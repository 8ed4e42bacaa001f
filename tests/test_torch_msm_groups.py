"""The MSM's row groups (dusk_plonk_torch.ops.msm.MsmPlan._row_groups,
config.msm_group_slots): the plan of groups at the 2^16 and 2^20 shapes,
the grouped MSM against the ungrouped one and the JAX package's host MSMs
in affine form, and a k = 7 proof under a cap that splits every commit
batch against the JAX package's host oracle, byte for byte.  On the CPU
every kernel runs its plain version.  Scalars are made from a seed with
numpy."""

import numpy as np
import pytest
import torch

from dusk_plonk_tpu import native
from dusk_plonk_tpu.curves import bls
from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_tpu.kzg.srs import PlonkParams
from dusk_plonk_tpu.rng.chacha import ChaCha12Rng
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.msm import MsmPlan
from dusk_plonk_torch.utils import config

from test_torch_engine import MixedCircuit, _host_and_torch, _proofs_equal

torch.set_num_threads(1)

N16, N20 = (1 << 16) + 7, (1 << 20) + 7      # the SRS sizes of k = 16, 20


def _plan(n, **overrides):
    """MsmPlan(n) built under `overrides` of the config, restored after."""
    old = config.get_config()
    config.set_config(**overrides)
    try:
        return MsmPlan(n)
    finally:
        config.set_config(**{k: getattr(old, k) for k in overrides})


@pytest.mark.parametrize("n, R, sizes", [
    (N16, 300, [300]),                 # key compilation: one group
    (N16, 80, [80]),                   # a proof's B = 4 batch
    (N20, 300, [30] * 10),             # key compilation at k = 20
    (N20, 80, [27, 27, 26]),           # a proof's B = 4, 1, 2 at k = 20
    (N20, 20, [20]),
    (N20, 40, [20, 20]),
])
def test_row_groups_at_bench_shapes(n, R, sizes):
    """The default cap keeps every 2^16 batch one group and splits a 2^20
    batch into the fewest balanced groups of at most 31 rows, covering
    every row once in order."""
    plan = MsmPlan(n)
    cap = plan.group_slots // plan.n_pad
    assert plan.n_pad == -(-n // 256) * 256
    groups = plan._row_groups(R)
    assert [b - a for a, b in groups] == sizes
    assert groups[0][0] == 0 and groups[-1][1] == R
    assert all(a1 == b0 for (_, b0), (a1, _) in zip(groups, groups[1:]))
    assert max(sizes) <= max(cap, 1) and max(sizes) - min(sizes) <= 1
    assert len(groups) == -(-R // max(cap, 1))
    if n == N20:
        assert cap == 31


def test_row_groups_cap_below_one_row():
    """A cap smaller than one row still runs each row alone."""
    plan = _plan(135, msm_group_slots=1)
    assert plan._row_groups(3) == [(0, 1), (1, 2), (2, 3)]


def test_excl_block_at_k20_chunks():
    """K4's block at a k = 20 row's 4,097 chunks: T <= 128 threads, runs
    covering every step."""
    T, m = kernels._excl_block(4097)
    assert (T, m) == (128, 33) and T * m >= 4097


@pytest.fixture(scope="module")
def batch135():
    """135 SRS points and B = 3 seeded scalar vectors (commit 2 the zero
    vector, commit 0 with the extreme scalars)."""
    pts = PlonkParams.setup(8, ChaCha12Rng.seed_from_u64(99)).powers[:135]
    rng = np.random.default_rng(135)
    words = rng.integers(0, 1 << 32, size=(3, 135, 8), dtype=np.uint64)
    scalars = [[int.from_bytes(w.astype("<u4").tobytes(), "little") % R_MOD
                for w in row] for row in words]
    scalars[0][:3] = [0, R_MOD - 1, 1]
    scalars[2] = [0] * 135
    F = fr_field()
    limbs = torch.stack([F.pack(s, "cpu", to_mont=False) for s in scalars])
    return pts, scalars, limbs


def _capture_totals(plan):
    """Record the window totals of each call of plan.window_totals."""
    seen = []
    inner = plan.window_totals

    def window_totals(em, limbs):
        out = inner(em, limbs)
        seen.append(out)
        return out
    plan.window_totals = window_totals
    return seen


def test_grouped_msm_equals_ungrouped_and_host(batch135):
    """n = 135, B = 3, chunks of 45 (3 a row): the 3 W rows in one group
    and in four unequal groups give the same window totals in affine form,
    the same commitments, equal to the JAX package's host MSMs (C++ and
    Python), and msm_device (the device combine, K8) gives them too."""
    pts, scalars, limbs = batch135
    G1 = device_g1()
    whole = _plan(135, msm_chunk_len=45)
    R = 3 * whole.num_windows
    split = _plan(135, msm_chunk_len=45,
                  msm_group_slots=whole.n_pad * (R // 4 + 1))
    sizes = [b - a for a, b in split._row_groups(R)]
    assert len(whole._row_groups(R)) == 1
    assert len(sizes) >= 4 and len(set(sizes)) > 1, sizes
    em = whole.prepare_points(G1.pack_points(pts, "cpu"))

    seen_whole, seen_split = _capture_totals(whole), _capture_totals(split)
    ref = whole.msm_affine_batch(em, limbs)
    got = split.msm_affine_batch(em, limbs)
    assert G1.to_affine(seen_split[0]) == G1.to_affine(seen_whole[0])
    assert got == ref
    assert got[0] == native.g1_msm(pts, scalars[0])
    assert got[1] == bls.g1_msm(pts, scalars[1])
    assert got[2] is None
    assert G1.to_affine(split.msm_device(em, limbs)) == got


def test_proof_under_split_batches_equals_host():
    """The slice under a cap of 128 rows, which splits each of the k = 7
    mixed circuit's commit batches (39 SRS points, c = 2: B = 4, 1, 4, 2
    commits of W = 129 rows): the key is the host compile's and the proof
    equals the JAX package's host-oracle proof, and verifies."""
    old = config.get_config()
    config.set_config(msm_group_slots=39 * 128)
    try:
        rng_h, prover_h, verifier, rng_t, prover_t = _host_and_torch(
            7, MixedCircuit)
    finally:
        config.set_config(msm_group_slots=old.msm_group_slots)
    msm = prover_t.engine.msm
    assert msm.n_pad == 39 and msm.num_windows == 129
    for B in (4, 1, 2):
        assert len(msm._row_groups(B * msm.num_windows)) > 1
    assert prover_t.verifier_key.to_bytes() == \
        prover_h.verifier_key.to_bytes()
    proof_h, pis = prover_h.create_proof(rng_h, MixedCircuit(13, 5))
    proof_t, pis_t = prover_t.create_proof(rng_t, MixedCircuit(13, 5))
    assert pis == pis_t
    _proofs_equal(proof_h, proof_t)
    assert proof_t.to_bytes() == proof_h.to_bytes()
    verifier.verify(proof_t, pis_t)
