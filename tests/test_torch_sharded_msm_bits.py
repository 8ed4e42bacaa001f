"""The port's point-partitioned MSM, bit-serial tier
(dusk_plonk_torch/parallel/msm.py::ShardedMsm(tier="bit_serial")), on a
CPU mesh, each result held in affine form against the host C++ MSM.  The
tier's one-commit function, parallel/prover_step.py::msm_bit_serial, is
tests/test_torch_msm_bit_serial.py."""

import pytest
import torch

from dusk_plonk_torch import native
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel.msm import ShardedMsm

from test_torch_sharded_msm import host_points, scalar_rows, sharded_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("B,zero_rows", [(1, ()), (3, (1,)), (5, (0, 4))])
def test_sharded_msm_bit_serial_equals_host(B, zero_rows):
    n, d = 16, 4
    pts = host_points(n)
    rows = scalar_rows(20 + B, B, n, zero_rows)
    mesh = M.Mesh(["cpu"] * d)
    points, limbs = sharded_inputs(mesh, pts, rows)
    smsm = ShardedMsm(mesh, "shard", n, "bit_serial")
    got = smsm.msm_affine_batch(smsm.prepare_points(points), limbs)
    for b, r in enumerate(rows):
        if b in zero_rows:
            assert got[b] is None, b
        else:
            assert got[b] == native.g1_msm(pts, r), b

