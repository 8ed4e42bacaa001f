"""The dedicated G1 doubling (DeviceG1.double_formula, RCB15 algorithm 9,
the formula of csrc/ec.cuh::g1_dbl) and kernel K7's plain version built on
it, on the CPU.

The doubling gives the complete add's group element in another projective
representative, so it is held against add_formula(p, p) and the host
curve in affine form; K7's wrapper on CPU tensors is held against its
plain version limb for limb.  Points are seeded multiples of the
generator with random Z, plus the identity and the generator."""

import numpy as np
import pytest
import torch

from dusk_plonk_torch.curves import bls
from dusk_plonk_torch.fields.constants import Q_MOD, R_MOD
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1

torch.set_num_threads(1)

G1 = device_g1()
F = G1.F
MUL = F.mul_plain


def _points(seed, count):
    """Affine host points: the identity, the generator, then seeded
    multiples of the generator."""
    rng = np.random.default_rng(seed)
    scalars = [int(s) % R_MOD for s in rng.integers(2, 1 << 62, count - 2)]
    return [None, bls.G1_GENERATOR] + [bls.g1_mul(bls.G1_GENERATOR, s)
                                       for s in scalars]


def _projective(seed, pts):
    """The points with a random nonzero Z (the identity keeps Z = 0)."""
    rng = np.random.default_rng(seed + 1)
    zs = [int(z) % Q_MOD or 1 for z in rng.integers(1, 1 << 62, len(pts))]
    p = G1.pack_points(pts, "cpu")
    z = F.pack(zs, "cpu")
    return tuple(MUL(c, z) for c in p)


def _affine(pts):
    return G1.to_affine(pts)


@pytest.mark.parametrize("seed", [1, 2])
def test_double_equals_complete_add(seed):
    pts = _points(seed, 6)
    p = _projective(seed, pts)
    got = _affine(G1.double_formula(p, MUL))
    assert got == _affine(G1.add_formula(p, p, MUL))
    assert got == [None if q is None else bls.g1_mul(q, 2) for q in pts]


def test_double_keeps_the_identity_exactly():
    ident = G1.broadcast_identity((), 3, "cpu")
    for a, b in zip(G1.double_formula(ident, MUL), ident):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [0, 1, 4])
def test_double_add_plain_equals_complete_add_order(k):
    pts = _points(10 + k, 5)
    a = _projective(10 + k, pts)
    b = _projective(20 + k, pts[::-1])
    got = kernels.ec_double_add_plain(G1, a, b, k)
    want = kernels.ec_double_add_plain(G1, a, b, k, doubling=False)
    assert _affine(got) == _affine(want)
    assert _affine(got) == [bls.g1_add(bls.g1_mul(p, 1 << k), q)
                            if p is not None else q
                            for p, q in zip(pts, pts[::-1])]


def test_double_add_wrapper_is_the_plain_version_on_cpu():
    pts = _points(5, 4)
    a, b = _projective(5, pts), _projective(6, pts[1:] + pts[:1])
    for x, y in zip(kernels.ec_double_add(G1, a, b, 3),
                    kernels.ec_double_add_plain(G1, a, b, 3)):
        assert torch.equal(x, y)
