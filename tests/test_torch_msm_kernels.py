"""The port's step-axis EC kernels (ops/kernels.py: K11b ec_sum_steps, K4
ec_scan_excl, K7 ec_double_add, K8 ec_combine) through their plain versions
on the CPU: K11b limb for limb against the JAX package's 16-bit Pallas
kernel pf.ec_sum_steps (interpret mode), and all four against the host
group law.  The 14-bit JAX kernels each replaces are held in
test_torch_msm14.py and test_torch_tail14.py.  Inputs are made from a seed
with numpy: points from a pool of 16 multiples of G, projective with random
Z, with identity, P + P and P + (-P) lanes."""

import numpy as np
import pytest
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


def _pool(seed):
    rng = np.random.default_rng(seed)
    return [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]


def _grid(seed, steps, lanes=LANES):
    """steps x lanes host points; lane 0 starts with O, lane 1 adds P + P,
    lane 2 adds P + (-P), lane 3 is all O."""
    rng = np.random.default_rng(seed)
    pool = _pool(seed)
    pts = [[pool[i] for i in rng.integers(0, 16, size=lanes)]
           for _ in range(steps)]
    pts[0][0] = None
    if steps > 1:
        pts[1][1] = pts[0][1]
        pts[1][2] = bls.g1_neg(pts[0][2])
    for s in range(steps):
        pts[s][3] = None
    return pts


def _pack(grid, seed):
    """Host points [steps][lanes] -> ((steps, 24, lanes),)*3 Montgomery
    projective limbs with random Z (the identity as (0, 1, 0))."""
    rng = np.random.default_rng(seed + 1)
    cols = ([], [], [])
    for row in grid:
        for p in row:
            if p is None:
                v = (0, 1, 0)
            else:
                z = int.from_bytes(rng.bytes(48), "little") % (Q - 1) + 1
                v = (p[0] * z % Q, p[1] * z % Q, z)
            for c, x in zip(cols, v):
                c.append(x)
    shape = (len(grid), len(grid[0]))
    return tuple(F.pack(c, "cpu", shape=shape) for c in cols)


def _affine(pts):
    """Projective limbs (any uniform Montgomery scale) -> flat list of
    affine host points; Z = 0 -> None."""
    X, Y, Z = (F.unpack(c, from_mont=False) for c in pts)
    out = []
    for x, y, z in zip(X, Y, Z):
        zi = pow(z, -1, Q) if z else 0
        out.append((x * zi % Q, y * zi % Q) if z else None)
    return out


def _host_sum(pts):
    acc = None
    for p in pts:
        acc = p if acc is None else (acc if p is None else bls.g1_add(acc, p))
    return acc


def _host_mul(p, k):
    return None if p is None else bls.g1_mul(p, k)


def test_ec_sum_steps_plain_matches_pallas_ec_sum_steps():
    """K11b's sequential plain version (block=None) equals the 16-bit TPU
    kernel limb for limb (the same RCB15 step order); the kernel's blocked
    order, which the CPU route runs, gives the same points in affine
    form."""
    g = _pack(_grid(3, 3), 3)
    got = kernels.ec_sum_steps_plain(G1, g)
    stacked = jnp.asarray(torch.cat(g, dim=1).numpy().astype(np.uint32))
    want = tuple(torch.from_numpy(np.asarray(b).astype(np.int32))
                 for b in pf.ec_sum_steps(stacked, interpret=True))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    block = kernels._sum_block(3, LANES)
    assert block == (2, 2)
    blocked = kernels.ec_sum_steps(G1, g)
    for a, b in zip(blocked, kernels.ec_sum_steps_plain(G1, g, block)):
        assert torch.equal(a, b)
    assert _affine(blocked) == _affine(want)


def test_ec_sum_steps_plain_group_law():
    grid = _grid(5, 4)
    got = _affine(kernels.ec_sum_steps(G1, _pack(grid, 5)))
    assert got == [_host_sum(col) for col in zip(*grid)]


def test_ec_scan_excl_plain_group_law():
    grid = _grid(6, 4)
    out = kernels.ec_scan_excl(G1, _pack(grid, 6))
    for s in range(4):
        got = _affine(tuple(c[s] for c in out))
        assert got == [_host_sum(col[:s]) for col in zip(*grid)], s


@pytest.mark.parametrize("k", [0, 3])
def test_ec_double_add_plain_group_law(k):
    grid = _grid(7, 2)
    a, b = (tuple(c[s] for c in _pack(grid, 7)) for s in (0, 1))
    got = _affine(kernels.ec_double_add(G1, a, b, k))
    assert got == [_host_sum([_host_mul(p, 1 << k), q])
                   for p, q in zip(*grid)]


def test_ec_combine_plain_group_law():
    W, c = 3, 4
    grid = _grid(8, W, 8)
    got = _affine(kernels.ec_combine(G1, _pack(grid, 8), c))
    assert got == [_host_sum([_host_mul(p, 1 << (c * (W - 1 - w)))
                              for w, p in enumerate(col)])
                   for col in zip(*grid)]


@pytest.mark.parametrize("name", ["ec_sum_steps", "ec_scan_excl",
                                  "ec_double_add", "ec_combine"])
def test_non_cpu_tensor_never_takes_the_plain_route(name):
    def meta(*shape):
        return tuple(torch.empty(shape, dtype=torch.int32, device="meta")
                     for _ in range(3))
    call = {"ec_sum_steps": lambda: kernels.ec_sum_steps(G1, meta(2, 24, 4)),
            "ec_scan_excl": lambda: kernels.ec_scan_excl(G1, meta(2, 24, 4)),
            "ec_double_add": lambda: kernels.ec_double_add(
                G1, meta(24, 4), meta(24, 4), 2),
            "ec_combine": lambda: kernels.ec_combine(G1, meta(2, 24, 4), 3)}
    with pytest.raises(ValueError):
        call[name]()
