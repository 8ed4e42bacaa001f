"""dusk_plonk_torch.ops.msm (the Pippenger pipeline over kernels K11a, K4,
K9, K11b and K7, with the window combine on the host or on kernel K8; their
plain versions on the CPU) against the host MSMs: the C++ native.g1_msm and
the Python curves.bls.g1_msm.  Group elements are compared in affine form.
Scalars are made from a seed with numpy."""

import numpy as np
import pytest
import torch

from dusk_plonk_tpu import native
from dusk_plonk_tpu.curves import bls
from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_tpu.kzg.srs import PlonkParams
from dusk_plonk_tpu.rng.chacha import ChaCha12Rng
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.msm import MsmPlan, pick_window_bits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def srs_points():
    return PlonkParams.setup(10, ChaCha12Rng.seed_from_u64(99)).powers


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    out = [int.from_bytes(w.astype("<u4").tobytes(), "little") % R_MOD
           for w in words]
    out[0] = 0
    out[1] = R_MOD - 1           # top-window carry of the signed digits
    out[n // 2] = 0
    out[-1] = 1
    return out


@pytest.mark.parametrize("n", [37, 135, 1031])
def test_msm_batch_matches_host(srs_points, n):
    pts = srs_points[:n]
    B = 3
    batch = [_scalars(100 * n + b, n) for b in range(B)]
    batch[2] = [0] * n                       # commits to the identity
    F = fr_field()
    limbs = torch.stack([F.pack(s, "cpu", to_mont=False) for s in batch])
    plan = MsmPlan(n)
    em = plan.prepare_points(device_g1().pack_points(pts, "cpu"))
    got = plan.msm_affine_batch(em, limbs)
    assert got[0] == native.g1_msm(pts, batch[0])
    assert got[1] == bls.g1_msm(pts, batch[1])
    assert got[2] is None


@pytest.mark.parametrize("n", [37, 135, 1031])
def test_msm_device_matches_host(srs_points, n):
    """msm_device (window totals, then the device combine K8) on a batch
    of two, and at n = 37 on one (16, n) scalar vector."""
    pts = srs_points[:n]
    batch = [_scalars(200 * n + b, n) for b in range(1 if n == 37 else 2)]
    F = fr_field()
    limbs = torch.stack([F.pack(s, "cpu", to_mont=False) for s in batch])
    plan = MsmPlan(n)
    G1 = device_g1()
    em = plan.prepare_points(G1.pack_points(pts, "cpu"))
    got = G1.to_affine(plan.msm_device(em, limbs[0] if n == 37 else limbs))
    assert got == [bls.g1_msm(pts, s) for s in batch]


def test_digits_recompose():
    """The signed c-bit digits sum back to the scalar, |d| <= 2^(c-1)."""
    F = fr_field()
    vals = _scalars(5, 64)
    limbs = F.pack(vals, "cpu", to_mont=False)[None]
    for c in (2, 7, 13, 16):
        plan = MsmPlan(64, window_bits=c)
        d = plan._digits(limbs)[0]                          # (W, 64)
        assert int(d.abs().max()) <= 1 << (c - 1)
        for j, v in enumerate(vals):
            assert sum(int(d[w, j]) << (c * w)
                       for w in range(plan.num_windows)) == v


def test_window_bits_rule():
    assert [pick_window_bits(n) for n in (37, 135, 1031, 65543)] == \
        [2, 4, 7, 13]
