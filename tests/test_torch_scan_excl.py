"""K4's block-parallel order (ops/kernels.py: _excl_block and
ec_scan_excl_plain with block=(T, m)) on the CPU: the blocked scan gives the
sequential scan's group elements (the JAX kernel's order, held against
pf.ec_scan_excl14 in test_torch_msm14.py), the CPU route obeys the host
group law over several runs, the block shape covers every step once, and a
non-CPU tensor never takes the plain route.  Inputs are made from a seed
with numpy: points from a pool of 16 multiples of G, projective with random
Z, with identity, P + P and P + (-P) lanes placed across a run boundary."""

import numpy as np
import pytest
import torch

from dusk_plonk_torch.curves import bls
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1

torch.set_num_threads(1)

G1 = device_g1()
F = G1.F
Q = F.spec.modulus


def _grid(seed, steps, m, lanes=6):
    """steps x lanes host points (None = O).  Lane 0 starts with O; with a
    second run (steps > m), lanes 1 and 2 add P then P / -P across the
    boundary of runs 0 and 1 among other points, and lanes 4 and 5 hold
    only P at step m - 1 and P / -P at step m, so the block scan adds the
    run totals P + P and P + (-P) themselves; lane 3 is all O."""
    rng = np.random.default_rng(seed)
    pool = [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]
    pts = [[pool[i] for i in rng.integers(0, 16, size=lanes)]
           for _ in range(steps)]
    pts[0][0] = None
    for s in range(steps):
        pts[s][3] = None
        pts[s][4] = pts[s][5] = None
    if steps > m:
        b = m                                   # first step of run 1
        for lane, neg in ((1, False), (2, True), (4, False), (5, True)):
            p = pts[b - 1][lane] = pool[lane]
            pts[b][lane] = bls.g1_neg(p) if neg else p
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


def _host_affine(pts):
    """Projective limbs -> flat list of affine host points (Z = 0 -> None),
    inverted on the host."""
    X, Y, Z = (F.unpack(c) for c in pts)
    return [(x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q) if z else None
            for x, y, z in zip(X, Y, Z)]


def _host_prefix(col, s):
    acc = None
    for p in col[:s]:
        acc = p if acc is None else (acc if p is None else bls.g1_add(acc, p))
    return acc


@pytest.mark.parametrize("steps,block", [
    (1, (4, 1)), (5, (4, 2)), (17, (4, 5)), (33, (8, 5)),
    (257, kernels._excl_block(257))])
def test_blocked_equals_sequential_in_group_form(steps, block):
    g = _pack(_grid(steps, steps, block[1]), steps)
    seq = kernels.ec_scan_excl_plain(G1, g)
    blk = kernels.ec_scan_excl_plain(G1, g, block)
    assert all(b.shape == s.shape for b, s in zip(blk, seq))
    # X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1 and the same identities: equal points
    (x1, y1, z1), (x2, y2, z2) = blk, seq
    assert torch.equal(F.mul(x1, z2), F.mul(x2, z1))
    assert torch.equal(F.mul(y1, z2), F.mul(y2, z1))
    assert torch.equal((z1 == 0).all(dim=-2), (z2 == 0).all(dim=-2))
    if steps <= 17:                 # the Fermat inverse costs ~5 ms a point
        for a, b in zip(G1.affine(blk), G1.affine(seq)):
            assert torch.equal(a, b)
    # the identity at step 0, and the exact sums across the boundary
    assert bool((G1.affine(tuple(c[0] for c in blk))[2] == 0).all())
    if steps > block[1] + 1:
        grid = _grid(steps, steps, block[1])
        got = G1.to_affine(tuple(c[block[1] + 1] for c in blk))
        assert got == [_host_prefix(col, block[1] + 1)
                       for col in zip(*grid)]
        assert got[5] is None and got[3] is None


def test_cpu_route_group_law_over_several_runs():
    steps = 131                                 # T = 128, m = 2: 66 runs
    assert kernels._excl_block(steps) == (128, 2)
    grid = _grid(7, steps, 2, lanes=6)
    out = kernels.ec_scan_excl(G1, _pack(grid, 7))
    got = _host_affine(out)                     # step-major, lane minor
    want = [_host_prefix(col, s) for s in range(steps)
            for col in zip(*grid)]
    assert got == want


def test_excl_block_covers_every_step_once():
    for steps in range(1, 1200):
        T, m = kernels._excl_block(steps)
        assert 1 <= T <= 128 and T & (T - 1) == 0
        assert T * m >= steps > T * (m - 1)
        seen = [s for r in range(T) for s in range(r * m,
                                                   min((r + 1) * m, steps))]
        assert seen == list(range(steps))
    assert kernels._excl_block(257) == (128, 3)


def test_non_cpu_tensor_never_takes_the_blocked_plain_route():
    g = tuple(torch.empty((257, 24, 4), dtype=torch.int32, device="meta")
              for _ in range(3))
    with pytest.raises(ValueError):
        kernels.ec_scan_excl(G1, g)
