"""Kernel K2's multi-pass NTT (dusk_plonk_torch.ops.kernels.ntt_passes /
ntt_plain, through NttPlan on the CPU) against the radix-2 ladder of
earlier versions (ops/ntt.py::ladder_oracle: scale, bit reversal, the k
stages of kernels.ntt_ladder_plain, scale) and against the JAX NttPlan (its
XLA path on the CPU at k <= 9).

Inputs are made from a seed with numpy; every comparison is exact, limb
for limb: each pass keeps every value canonical, so the DFT's limbs are
unique whatever the decomposition."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
from dusk_plonk_tpu.ops.ntt import NttPlan as JaxNttPlan
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.ntt import NttPlan, ladder_oracle

torch.set_num_threads(1)

KINDS = ("dft", "idft", "coset_dft", "coset_idft")
SMEM_PER_BLOCK = 232448        # bytes of shared memory a block (H100)


def _limbs(seed, batch, k):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(batch << k, 8), dtype=np.uint64)
    vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") % R_MOD
            for w in words]
    return vals, fr_field().pack(vals, "cpu", shape=(batch, 1 << k))


@pytest.mark.parametrize("k", range(0, 25))
def test_planner_covers_every_level_in_tiles_that_fit(k):
    passes = kernels.ntt_passes(k)
    assert sum(p.log_m for p in passes) == k
    assert len(passes) == (1 if k <= 10 else 2 if k <= 16 else 3)
    n = 1 << k
    for i, p in enumerate(passes):
        m = 1 << p.log_m
        tile = p.lines * m
        assert tile <= kernels.NTT_TILE and tile * 32 <= SMEM_PER_BLOCK
        assert (n // m) % p.lines == 0 and p.D % p.lines == 0
        assert (p.mid != 0) == (i < len(passes) - 1)
        if i < len(passes) - 1:
            # a strided read: runs of 8 adjacent lines in every plane
            assert p.in_s > 1 and p.lines == min(8, p.in_s)
    if len(passes) > 1:
        # the last pass reads rows and writes runs of 8 adjacent outputs
        assert passes[-1].in_s == 1 and passes[-1].lines == 8


def test_planner_refuses_what_it_cannot_tile():
    for k, passes in ((25, None), (12, 1), (2, 3), (9, 4)):
        with pytest.raises(ValueError):
            kernels.ntt_passes(k, passes)


@pytest.mark.parametrize("k,passes", [(5, 3), (6, 2), (7, 1)])
def test_pass_index_maps_are_permutations(k, passes):
    """Each pass reads and writes every position once."""
    n = 1 << k
    for p in kernels.ntt_passes(k, passes):
        src, dst, _ = kernels._pass_index(p, n, "cpu")
        assert torch.equal(src.flatten().sort()[0], torch.arange(n))
        assert torch.equal(dst.flatten().sort()[0], torch.arange(n))


# (k, forced pass count or None, batch): one pass (k <= 10), two uneven
# passes (k = 11: 5 + 6 levels), two even passes (k = 12: 6 + 6), three
# passes forced at small k (uneven 2 + 2 + 3 at k = 7), and a two-pass
# split forced below k = 11
CASES = [(4, None, 1), (7, None, 2), (11, None, 1), (12, None, 1),
         (6, 3, 2), (7, 3, 1), (3, 3, 1), (8, 2, 2)]


@pytest.mark.parametrize("k,passes,batch", CASES)
def test_matches_ladder_oracle(k, passes, batch):
    F = fr_field()
    _, x = _limbs(100 + k, batch, k)
    plan = NttPlan(k, "cpu", passes)
    assert len(plan.passes) == (passes or len(kernels.ntt_passes(k)))
    kinds = KINDS if k < 12 else ("coset_dft", "coset_idft")
    for kind in kinds:
        got = getattr(plan, kind)(x)
        assert torch.equal(got, ladder_oracle(F, k, kind, x)), kind


@pytest.fixture(scope="module")
def jax_plan9():
    return JaxNttPlan(9)


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_matches_jax_plan(jax_plan9, passes):
    k, batch = 9, 2
    vals, _ = _limbs(7 + passes, batch, k)
    x = np.asarray(jax_fr().pack(vals, shape=(batch, 1 << k)))
    plan = NttPlan(k, "cpu", passes)
    for kind in KINDS:
        want = np.asarray(getattr(jax_plan9, kind)(jnp.asarray(x)))
        got = getattr(plan, kind)(torch.from_numpy(x.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_pack_words_roundtrip():
    _, x = _limbs(3, 1, 6)
    w = kernels.pack_words(x[0])
    assert w.shape == (64, 8) and w.dtype == torch.int32
    assert torch.equal(kernels.unpack_words(w), x[0])


def test_non_cpu_tensor_never_takes_the_plain_route():
    plan = NttPlan(4, "cpu")
    x = torch.empty((1, 16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.ntt(plan.F, x, 4, plan.steps_fwd)
