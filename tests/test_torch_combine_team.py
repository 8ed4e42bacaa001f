"""Kernel K8's order and the team schedule of csrc/ec.cuh, in plain PyTorch
on the CPU at tiny sizes (no JAX: the JAX kernel ec_combine14 is held
against the port in tests/test_torch_tail14.py).

- ec_combine_plain's default order (from T_0, RCB15 doublings, then + T_w:
  the kernel's) gives the points of the complete-add order from the
  identity (doubling=False, the JAX kernel's) and of the host curve, in
  affine form, with identity windows: T_0 the identity, every window the
  identity, T_1 = -T_0.
- The CPU route of kernels.ec_combine is that default order, limb for limb;
  no windows are refused on either route.
- A model of g1_dbl_team / g1_add_team (each rank of a team of T takes
  the jobs rank, rank + T, ... of a level, picks its operands as the CUDA
  code's selects do, stores only jobs below the level's size; one batched
  multiply a round; the adds between levels as the CUDA code orders them)
  equals DeviceG1.double_formula and add_formula limb for limb, and the
  model of g1_add_mixed_team (K10) equals add_mixed_formula."""

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
    rng = np.random.default_rng(seed)
    return [bls.g1_mul(bls.G1_GENERATOR, int(s) % R_MOD)
            for s in rng.integers(2, 1 << 62, count)]


def _pack(seed, pts):
    """Host points (None: the identity) -> projective limbs with random Z."""
    rng = np.random.default_rng(seed + 1)
    zs = [int(z) % Q_MOD or 1 for z in rng.integers(1, 1 << 62, len(pts))]
    p = G1.pack_points(pts, "cpu")
    return tuple(MUL(c, F.pack(zs, "cpu")) for c in p)


def _windows(seed, W):
    """((W, 24, 4),)*3 window totals and their host points: lane 0 has
    T_0 = O, lane 1 every window O, lane 2 T_1 = -T_0 (W > 1), lane 3
    random."""
    pts = _points(seed, 4 * W)
    grid = [pts[4 * w:4 * w + 4] for w in range(W)]
    grid[0][0] = None
    for w in range(W):
        grid[w][1] = None
    if W > 1:
        grid[1][2] = bls.g1_neg(grid[0][2])
    packed = [_pack(seed + w, row) for w, row in enumerate(grid)]
    return tuple(torch.stack([p[i] for p in packed]) for i in range(3)), grid


def _host_combine(col, c):
    acc = None
    for p in col:
        acc = bls.g1_add(bls.g1_mul(acc, 1 << c) if acc is not None else None,
                         p)
    return acc


@pytest.mark.parametrize("W", [1, 2, 5])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_combine_order_equals_complete_add_order(W, c):
    g, grid = _windows(10 * W + c, W)
    got = G1.to_affine(kernels.ec_combine_plain(G1, g, c))
    assert got == G1.to_affine(kernels.ec_combine_plain(G1, g, c,
                                                        doubling=False))
    assert got == [_host_combine(col, c) for col in zip(*grid)]
    assert got[1] is None


def test_combine_cpu_route_is_the_kernel_order():
    g, _ = _windows(7, 3)
    for a, b in zip(kernels.ec_combine(G1, g, 2),
                    kernels.ec_combine_plain(G1, g, 2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_combine_refuses_no_windows(device):
    g = tuple(torch.empty((0, 24, 4), dtype=torch.int32, device=device)
              for _ in range(3))
    with pytest.raises(ValueError):
        kernels.ec_combine(G1, g, 2)


# -- the team schedule of csrc/ec.cuh ---------------------------------------------

def _sel(c, a, b):
    return a if c else b


def _level(T, M, slots, base, operands):
    """One level of M jobs on a team of T: rank r takes jobs r, r + T, ..
    (a job >= M runs a copy and stores nothing); each round's T products
    are one batched multiply."""
    for j0 in range(0, M, T):
        jobs = [j0 + r for r in range(T)]
        pairs = [operands(j) for j in jobs]
        prod = MUL(torch.stack([a for a, _ in pairs]),
                   torch.stack([b for _, b in pairs]))
        for r, j in enumerate(jobs):
            if j < M:
                slots[base + j] = prod[r]


def _mul12(x):
    return G1._mul12(F, x)


def dbl_team(p, T):
    """csrc/ec.cuh::g1_dbl_team<T>, step for step."""
    x, y, z = p
    s = {}

    def level1(j):
        a = _sel(j >= 3, x, _sel(j == 2, z, y))
        return a, _sel(j == 1 or j == 2, z, y)
    _level(T, 4, s, 0, level1)
    t0, t1, t2, t3 = s[0], s[1], s[2], s[3]
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)
    t2 = _mul12(t2)
    y3 = F.add(t0, t2)
    u = F.add(t2, t2)
    u = F.add(u, t2)
    t0 = F.sub(t0, u)

    def level2(j):
        a = _sel(j == 0, t2, _sel(j == 1, t1, t0))
        return a, _sel(j <= 1, z3, _sel(j == 2, y3, t3))
    _level(T, 4, s, 6, level2)
    return (F.add(s[9], s[9]), F.add(s[6], s[8]), s[7])


def add_team(p, q, T):
    """csrc/ec.cuh::g1_add_team<T>, step for step."""
    s = {}

    def level1(j):
        fy, fz, sy = j in (1, 4), j == 2, j == 3
        out = []
        for x, y, z in (p, q):
            a = _sel(fz, z, _sel(fy, y, x))
            u = F.add(a, _sel(sy, y, z))
            out.append(_sel(j >= 3, u, a))
        return tuple(out)
    _level(T, 6, s, 0, level1)
    t0, t1, t2, t3, t4, y3 = (s[k] for k in range(6))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.sub(t4, F.add(t1, t2))
    y3 = F.sub(y3, F.add(t0, t2))
    t0 = F.add(F.add(t0, t0), t0)
    t2 = _mul12(t2)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = _mul12(y3)
    return _add_level2(T, s, t0, t1, t3, t4, y3, z3)


def _add_level2(T, s, t0, t1, t3, t4, y3, z3):
    """csrc/ec.cuh::team_add_level2<T>: the six products, then the sums."""
    ops_a = (t4, t3, y3, t1, t0)
    ops_b = (y3, t1, t0, z3, t3)

    def level2(j):
        return (ops_a[j] if j < 5 else z3, ops_b[j] if j < 5 else t4)
    _level(T, 6, s, 6, level2)
    return (F.sub(s[7], s[6]), F.add(s[9], s[8]), F.add(s[11], s[10]))


def add_mixed_team(p, q2, T):
    """csrc/ec.cuh::g1_add_mixed_team<T>, step for step."""
    x1, y1, z1 = p
    x2, y2 = q2
    s = {}

    def level1(j):
        a = _sel(j == 2, F.add(x1, y1), _sel(j >= 3, z1, _sel(j == 1, y1, x1)))
        b = _sel(j == 2, F.add(x2, y2), _sel(j in (1, 3), y2, x2))
        return a, b
    _level(T, 5, s, 0, level1)
    t0, t1 = s[0], s[1]
    t3 = F.sub(s[2], F.add(t0, t1))
    t4 = F.add(y1, s[3])
    y3 = F.add(x1, s[4])
    t0 = F.add(F.add(t0, t0), t0)
    t2 = _mul12(z1)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = _mul12(y3)
    return _add_level2(T, s, t0, t1, t3, t4, y3, z3)


def _special(seed):
    """(p, q) on 7 lanes: random, P + P, P + (-P), O + Q, P + O, O + O,
    random."""
    pts = _points(seed, 4)
    ps = [pts[0], pts[1], pts[2], None, pts[3], None, pts[3]]
    qs = [pts[1], pts[1], bls.g1_neg(pts[2]), pts[0], None, None, pts[2]]
    return _pack(seed, ps), _pack(seed + 7, qs)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 6])
def test_team_schedule_equals_formulas(T):
    p, q = _special(30 + T)
    for a, b in zip(dbl_team(p, T), G1.double_formula(p, MUL)):
        assert torch.equal(a, b)
    for a, b in zip(add_team(p, q, T), G1.add_formula(p, q, MUL)):
        assert torch.equal(a, b)


def _special_mixed(seed):
    """(p, (x2, y2)) on 6 lanes: random, O + Q, P + P, P + (-P), random,
    random; q affine (Z = 1), p with random Z."""
    pts = _points(seed, 6)
    qs = [pts[1], pts[2], pts[3], pts[4], pts[5], pts[0]]
    ps = [pts[0], None, pts[3], bls.g1_neg(pts[4]), pts[4], pts[5]]
    q = G1.pack_points(qs, "cpu")
    return _pack(seed, ps), (q[0], q[1]), ps, qs


@pytest.mark.parametrize("T", [1, 2, 3, 6])
def test_mixed_team_schedule_equals_formula(T):
    """g1_add_mixed_team<T> (K10's team of six, K12's teams of three and
    six, the variants' team of two) limb for limb with
    DeviceG1.add_mixed_formula, and the host group law."""
    p, q2, ps, qs = _special_mixed(50 + T)
    got = add_mixed_team(p, q2, T)
    for a, b in zip(got, G1.add_mixed_formula(p, q2, MUL)):
        assert torch.equal(a, b)
    want = [b if a is None else bls.g1_add(a, b) for a, b in zip(ps, qs)]
    assert G1.to_affine(got) == want
    assert want[3] is None

