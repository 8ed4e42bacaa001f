"""K12 (ops/kernels.py::ec_scan_mixed_em) on the CPU: its route gives the
host group law's prefix sums, with lanes whose running sums double, meet
the identity and leave it again; a model of its team scan
(csrc/ec_scan_em.cu::ec_scan_em_team_kernel: each step's mixed add on a
team of N threads, ec.cuh::g1_add_mixed_team, modelled step for step in
tests/test_torch_combine_team.py) gives the sequential order limb for
limb; and _scan_team picks a team the kernel takes.  The JAX kernel's
order is held against pf.ec_scan_mixed14_em in test_torch_alt_kernels.py.
Inputs are made from a seed with numpy: affine points from a pool of 16
multiples of G."""

import numpy as np
import pytest
import torch

from dusk_plonk_torch.curves import bls
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1
from tests.test_torch_combine_team import add_mixed_team

torch.set_num_threads(1)

G1 = device_g1()
LANES = 8


def _host_sum(pts):
    acc = None
    for p in pts:
        acc = p if acc is None else bls.g1_add(acc, p)
    return acc


def _grid(seed, cl, lanes):
    """cl x lanes affine host points (none the identity), of the first
    `lanes` of these: lane 0 random; lanes 1 and 2 add P, then P / -P
    (a doubling, the identity at step 1); lane 3 reaches the sum P at step
    cl // 2 - 1 and adds -P next (the identity mid-scan, then on from it);
    lane 4 is P at every step; lanes 5-7 random."""
    rng = np.random.default_rng(seed)
    pool = [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]
    pts = [[pool[i] for i in rng.integers(0, 16, size=LANES)]
           for _ in range(cl)]
    p = pool[0]
    if cl > 1:
        pts[0][1] = pts[1][1] = p
        pts[0][2], pts[1][2] = p, bls.g1_neg(p)
    k = cl // 2
    if k >= 1 and cl > k:
        part = _host_sum([pts[s][3] for s in range(k - 1)])
        last = p if part is None else bls.g1_add(p, bls.g1_neg(part))
        if last is not None:
            pts[k - 1][3] = last
            pts[k][3] = bls.g1_neg(p)
    for row in pts:
        row[4] = p
    return [row[:lanes] for row in pts]


def _pack(grid):
    """Host points [cl][lanes] -> (cl, 48, lanes) Montgomery limbs of x, y."""
    rows = [G1.pack_points(row, "cpu") for row in grid]
    return torch.stack([torch.cat([r[0], r[1]]) for r in rows])


def _host_affine(em):
    """(cl, lanes, 72) -> [[affine host point | None] per lane] per step."""
    cl, lanes, _ = em.shape
    pts = tuple(em[:, :, 24 * i:24 * (i + 1)].permute(2, 0, 1)
                .reshape(24, cl * lanes) for i in range(3))
    flat = G1.to_affine(pts)
    return [flat[s * lanes:(s + 1) * lanes] for s in range(cl)]


def _host_prefixes(grid):
    out, acc = [], [None] * len(grid[0])
    for row in grid:
        acc = [p if a is None else bls.g1_add(a, p)
               for a, p in zip(acc, row)]
        out.append(acc)
    return out


def team_scan(g, N):
    """csrc/ec_scan_em.cu::ec_scan_em_team_kernel<N>, step for step: from
    the identity, each step's mixed add on a team of N, each sum a row."""
    cl, _, lanes = g.shape
    acc = G1.broadcast_identity((), lanes, g.device)
    rows = []
    for s in range(cl):
        acc = add_mixed_team(acc, (g[s, :24], g[s, 24:]), N)
        rows.append(torch.cat(acc))
    return torch.stack(rows).transpose(1, 2).contiguous()


@pytest.mark.parametrize("cl,lanes", [
    (1, 8),                  # one step: each row the point itself
    (2, 8),                  # P + P and P + (-P) on the last step
    (3, 5),
    (8, 8),
    (11, 8),                 # the identity mid-scan, then on from it
    (16, 3),
    (7, 1),
])
def test_scan_em_is_the_group_law(cl, lanes):
    grid = _grid(cl * 10 + lanes, cl, lanes)
    g = _pack(grid)
    got = kernels.ec_scan_mixed_em(G1, g)
    assert got.shape == (cl, lanes, 72)
    rows = _host_affine(got)
    assert rows == _host_prefixes(grid)
    if cl > 1 and lanes > 2:
        assert rows[1][1] == bls.g1_add(grid[0][1], grid[0][1])
        assert rows[1][2] is None
    if cl >= 4 and lanes > 3:
        assert rows[cl // 2][3] is None
        assert rows[cl // 2 + 1][3] == grid[cl // 2 + 1][3]


@pytest.mark.parametrize("cl,lanes", [(5, 8), (9, 3)])
@pytest.mark.parametrize("N", [1, 2, 3, 6])
def test_team_scan_is_the_sequential_order(N, cl, lanes):
    """A team of any size gives the sequential scan's representatives: the
    package's teams of 3 and 6 and one thread, and the variants' team of
    two (tools/kernel_variants/k12_var.cu)."""
    g = _pack(_grid(N + cl, cl, lanes))
    assert torch.equal(team_scan(g, N), kernels.ec_scan_mixed_em(G1, g))


def test_scan_team_takes_a_kernel_team():
    """_scan_team: one of the teams dt_ec_scan_mixed_em launches, never a
    larger team at a wider launch."""
    last = 6
    for lanes in range(1, 100_000, 97):
        N = kernels._scan_team(lanes)
        assert N in (1, 3, 6) and N <= last
        last = N
