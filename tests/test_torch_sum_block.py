"""K11b's block-parallel order (ops/kernels.py: _sum_block and
ec_sum_steps_plain with block=(T, m)) on the CPU: the blocked tree sum
gives the sequential sum's group elements (the JAX kernel's order, held
against pf.ec_sum_steps in test_torch_msm_kernels.py) and the host group
law, the CPU route runs the blocked order, and the block shape keeps its
rules.  Inputs are made from a seed with numpy: points from a pool of 16
multiples of G, projective with random Z, with identity, P + P and
P + (-P) lanes whose pairs meet inside a run and in the tree."""

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


def _grid(seed, steps, m, lanes=8):
    """steps x lanes host points (None = O).  Lane 0 starts with O and lane
    3 is all O; lanes 1 and 2 add P then P / -P inside run 0 (steps 0, 1),
    lanes 4 and 5 hold only P at step m - 1 and P / -P at step m, so the
    tree adds the run totals P + P and P + (-P) themselves."""
    rng = np.random.default_rng(seed)
    pool = [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]
    pts = [[pool[i] for i in rng.integers(0, 16, size=lanes)]
           for _ in range(steps)]
    pts[0][0] = None
    for s in range(steps):
        pts[s][3] = pts[s][4] = pts[s][5] = None
    if steps > 1 and m > 1:
        for lane, neg in ((1, False), (2, True)):
            p = pts[0][lane]
            pts[1][lane] = bls.g1_neg(p) if neg else p
    if steps > m:
        for lane, neg in ((4, False), (5, True)):
            p = pts[m - 1][lane] = pool[lane]
            pts[m][lane] = bls.g1_neg(p) if neg else p
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


def _host_sum(col):
    acc = None
    for p in col:
        acc = p if acc is None else (acc if p is None else bls.g1_add(acc, p))
    return acc


@pytest.mark.parametrize("steps,lanes,block", [
    (1, 8, kernels._sum_block(1, 8)),         # one step: (1, 1)
    (5, 8, (8, 1)),                           # steps < T: runs past the end
    (7, 8, kernels._sum_block(7, 8)),         # (4, 2): 7 no multiple of T
    (13, 8, (4, 4)),
    (64, 80, kernels._sum_block(64, 80)),     # level 2 of a 4-commit batch
])
def test_blocked_equals_sequential_and_the_group_law(steps, lanes, block):
    T, m = block
    grid = _grid(steps, steps, m, lanes)
    g = _pack(grid, steps)
    seq = kernels.ec_sum_steps_plain(G1, g)
    blk = kernels.ec_sum_steps_plain(G1, g, block)
    assert all(b.shape == s.shape == (24, lanes) for b, s in zip(blk, seq))
    for a, b in zip(G1.affine(blk), G1.affine(seq)):
        assert torch.equal(a, b)
    got = _host_affine(blk)
    assert got == [_host_sum(col) for col in zip(*grid)]
    assert got[3] is None
    if steps > m:
        assert got[5] == _host_sum([grid[s][5] for s in range(steps)])


def test_cpu_route_runs_the_blocked_order():
    steps, lanes = 9, 6
    block = kernels._sum_block(steps, lanes)
    assert block == (8, 2)
    g = _pack(_grid(9, steps, block[1], lanes), 9)
    for a, b in zip(kernels.ec_sum_steps(G1, g),
                    kernels.ec_sum_steps_plain(G1, g, block)):
        assert torch.equal(a, b)


def test_sum_block_rules():
    for steps in range(0, 300):
        for lanes in (1, 20, 80, 1280, 2560, 5120, 19200, 40000):
            T, m = kernels._sum_block(steps, lanes)
            assert 1 <= T <= 64 and T & (T - 1) == 0
            assert T * m >= steps and T * (m - 1) < max(steps, 1)
            assert T <= max(steps, 1)
            # the launch fits one wave, with as many threads as fit
            assert lanes * T <= kernels.SUM_FILL or T == 1
            assert lanes * 2 * T > kernels.SUM_FILL or T == 64 \
                or 2 * T > steps
    # the shapes of a 2^16 proof, key compilation and msm_device
    assert kernels._sum_block(64, 5120) == (4, 16)
    assert kernels._sum_block(64, 1280) == (16, 4)
    assert kernels._sum_block(64, 2560) == (8, 8)
    assert kernels._sum_block(64, 19200) == (1, 64)
    assert kernels._sum_block(64, 80) == kernels._sum_block(64, 20) == (64, 1)


def test_blocked_order_rejects_a_bad_block():
    g = _pack(_grid(3, 3, 2), 3)
    with pytest.raises(ValueError):
        kernels.ec_sum_steps_plain(G1, g, (2, 1))      # misses step 2
    with pytest.raises(ValueError):
        kernels.ec_sum_steps_plain(G1, g, (3, 1))      # T no power of two
