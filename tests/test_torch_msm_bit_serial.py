"""parallel/prover_step.py::msm_bit_serial, the bit-serial tier's
one-commit function, on an 8-shard CPU mesh, held in affine form against
the host C++ MSM (the tier's batches are
tests/test_torch_sharded_msm_bits.py)."""

import torch

from dusk_plonk_torch import native
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel.prover_step import msm_bit_serial

from test_torch_sharded_msm import host_points, scalar_rows, sharded_inputs

torch.set_num_threads(1)


def test_msm_bit_serial_equals_host():
    """With an identity point and a zero scalar among the inputs (the
    complete add takes both)."""
    n, d = 16, 8
    pts = host_points(n)
    pts[5] = None
    rows = scalar_rows(3, 1, n)
    rows[0][2] = 0
    mesh = M.Mesh(["cpu"] * d)
    points, limbs = sharded_inputs(mesh, pts, rows)
    out = msm_bit_serial(mesh, "shard", points, [x[0] for x in limbs])
    assert device_g1().to_affine(out)[0] == native.g1_msm(pts, rows[0])
