"""The port's point-partitioned MSM, Pippenger tier
(dusk_plonk_torch/parallel/msm.py::ShardedMsm and
parallel/prover_step.py::msm_point_partitioned), on CPU meshes, each
result held in affine form against the host C++ MSM.  The bit-serial
tier is tests/test_torch_sharded_msm_bits.py."""

import numpy as np
import pytest
import torch

from dusk_plonk_torch import native
from dusk_plonk_torch.curves import bls
from dusk_plonk_torch.fields.constants import R_MOD
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.msm import MsmPlan
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel.msm import ShardedMsm
from dusk_plonk_torch.parallel.prover_step import (
    _local_window_totals, msm_point_partitioned)
from dusk_plonk_torch.utils.config import get_config, set_config
from dusk_plonk_torch.utils.tracing import tracer

torch.set_num_threads(1)


def host_points(n, double=False):
    """n distinct affine multiples of the generator (k G, or 2^k G)."""
    out, acc = [], bls._jac_from_affine(bls.G1_GENERATOR)
    for _ in range(n):
        if double:
            acc = bls._jac_double(acc)
        out.append(bls._jac_to_affine(acc))
        if not double:
            acc = bls._jac_add(acc, bls._jac_from_affine(bls.G1_GENERATOR))
    return out


def scalar_rows(seed, B, n, zero_rows=()):
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(32), "little") % R_MOD
             for _ in range(n)] for _ in range(B)]
    for b in zero_rows:
        rows[b] = [0] * n
    return rows


def sharded_inputs(mesh, pts, rows):
    F = fr_field()
    points = tuple(M.shard(mesh, c)
                   for c in device_g1().pack_points(pts, "cpu"))
    limbs = F.pack([s for r in rows for s in r], "cpu", to_mont=False,
                   shape=(len(rows), len(pts)))
    return points, M.shard(mesh, limbs)


@pytest.mark.parametrize("B,zero_rows", [(1, ()), (3, (1,)), (5, (0, 4))])
def test_sharded_msm_pippenger_equals_host(B, zero_rows):
    n, d = 32, 4
    pts = host_points(n)
    rows = scalar_rows(B, B, n, zero_rows)
    mesh = M.Mesh(["cpu"] * d)
    points, limbs = sharded_inputs(mesh, pts, rows)
    smsm = ShardedMsm(mesh, "shard", n, "pippenger")
    tracer.reset()
    got = smsm.msm_affine_batch(smsm.prepare_points(points), limbs)
    for b, r in enumerate(rows):
        if b in zero_rows:
            assert got[b] is None, b
        else:
            assert got[b] == native.g1_msm(pts, r), b
    w = smsm.plan.num_windows
    assert tracer.counters["msm_dispatch"] == 1
    assert tracer.counters["msm_points"] == n * B
    assert tracer.counters["collective_bytes"] == \
        3 * B * w * 24 * 4 * (d - 1) * d


def test_msm_point_partitioned_equals_host():
    n, d = 32, 8
    pts = host_points(n)
    rows = scalar_rows(7, 1, n)
    mesh = M.Mesh(["cpu"] * d)
    points, limbs = sharded_inputs(mesh, pts, rows)
    out = msm_point_partitioned(mesh, "shard", points,
                                [x[0] for x in limbs])
    assert device_g1().to_affine(out)[0] == native.g1_msm(pts, rows[0])


def test_local_window_totals_padded_shard():
    """A shard whose MsmPlan pads (n_pad != n: 96 points in chunks of
    64): the digits must cover the padded length, or negative digits
    would read the generator pads instead of the (x, -y) half."""
    cfg = get_config()
    old = cfg.msm_chunk_len, cfg.msm_window_bits
    set_config(msm_chunk_len=64, msm_window_bits=5)
    try:
        n = 96
        plan = MsmPlan(n)
        assert plan.n_pad != plan.n
        pts = host_points(n, double=True)
        rows = scalar_rows(13, 1, n)
        px, py, _ = device_g1().pack_points(pts, "cpu")
        limbs = fr_field().pack(rows[0], "cpu", to_mont=False)
        tot = _local_window_totals(plan, px, py, limbs)       # (24, W)
        msb = tuple(c.flip(-1).T[:, :, None].contiguous() for c in tot)
        got = device_g1().to_affine(device_g1().combine(msb,
                                                        plan.window_bits))
        assert got[0] == native.g1_msm(pts, rows[0])
    finally:
        set_config(msm_chunk_len=old[0], msm_window_bits=old[1])
