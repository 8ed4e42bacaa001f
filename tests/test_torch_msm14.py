"""The JAX package's 14-bit bucket-phase kernels K6 (pf.ec_sum_steps14) and
K4 (pf.ec_scan_excl14) against the port's K11b (ec_sum_steps) and K4
(ec_scan_excl), through the plain versions on the CPU, in affine form (the
14-bit engine's outputs are the same points scaled by 2^8).  Inputs are
made from a seed with numpy, with identity, P + P and P + (-P) lanes."""

import numpy as np
import torch
import jax.numpy as jnp

import dusk_plonk_tpu.ops.pallas_field as pf
from dusk_plonk_tpu.curves import bls
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1

torch.set_num_threads(1)

G1 = device_g1()
F = G1.F
Q = F.spec.modulus
LANES = 128


def _steps(seed, steps):
    """((steps, 24, lanes),)*3 Montgomery projective limbs with random Z:
    lane 0 starts with O, lane 1 adds P + P, lane 2 adds P + (-P)."""
    rng = np.random.default_rng(seed)
    pool = [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]
    pts = [[pool[i] for i in rng.integers(0, 16, size=LANES)]
           for _ in range(steps)]
    pts[0][0] = None
    pts[1][1] = pts[0][1]
    pts[1][2] = bls.g1_neg(pts[0][2])
    cols = ([], [], [])
    for p in (p for row in pts for p in row):
        z = int.from_bytes(rng.bytes(48), "little") % (Q - 1) + 1
        v = (0, 1, 0) if p is None else (p[0] * z % Q, p[1] * z % Q, z)
        for c, x in zip(cols, v):
            c.append(x)
    return tuple(F.pack(c, "cpu", shape=(steps, LANES)) for c in cols)


def _affine(pts):
    X, Y, Z = (F.unpack(c, from_mont=False) for c in pts)
    return [(x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q) if z else None
            for x, y, z in zip(X, Y, Z)]


def _stacked(g):
    return jnp.asarray(torch.cat(g, dim=-2).numpy().astype(np.uint32))


def _split(st):
    a = torch.from_numpy(np.asarray(st).astype(np.int32))
    return tuple(a[..., i * 24:(i + 1) * 24, :] for i in range(3))


def test_ec_sum_steps_plain_matches_ec_sum_steps14():
    """Both of K11b's orders (sequential, and blocked as the CPU route
    runs it) give K6's points."""
    g = _steps(31, 3)
    want = _affine(_split(pf.ec_sum_steps14(_stacked(g), interpret=True)))
    got = _affine(kernels.ec_sum_steps(G1, g))
    assert got == want
    assert _affine(kernels.ec_sum_steps_plain(G1, g)) == want
    assert got[2] is not None


def test_ec_scan_excl_plain_matches_ec_scan_excl14():
    g = _steps(32, 3)
    ours = kernels.ec_scan_excl(G1, g)
    theirs = _split(pf.ec_scan_excl14(_stacked(g), interpret=True))
    for s in range(3):
        got = _affine(tuple(c[s] for c in ours))
        assert got == _affine(tuple(c[s] for c in theirs)), s
    assert all(p is None for p in _affine(tuple(c[0] for c in ours)))
    assert _affine(tuple(c[2] for c in ours))[2] is None
