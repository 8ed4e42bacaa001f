"""dusk_plonk_torch.ops.ntt (kernel K2's plain version on the CPU) against the
JAX NttPlan (its XLA path on the CPU) and the host domain oracle.

Inputs are made from a seed with numpy; comparisons are exact, limb for
limb."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
from dusk_plonk_tpu.ops.ntt import NttPlan as JaxNttPlan
from dusk_plonk_tpu.poly.domain import Domain
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.ntt import NttPlan

torch.set_num_threads(1)

KINDS = ("dft", "idft", "coset_dft", "coset_idft")


def _values(seed, count):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % R_MOD
            for w in words]


@pytest.fixture(scope="module")
def jax_plan8():
    return JaxNttPlan(8)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_plan(jax_plan8, kind, batch):
    k = 8
    vals = _values(10 + batch, batch << k)
    J = jax_fr()
    x = np.asarray(J.pack(vals, shape=(batch, 1 << k)))    # (B, 16, n)
    want = np.asarray(getattr(jax_plan8, kind)(jnp.asarray(x)))
    plan = NttPlan(k, "cpu")
    got = getattr(plan, kind)(torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_host_domain(kind, k):
    n = 1 << k
    vals = _values(k, n)
    F = fr_field()
    plan = NttPlan(k, "cpu")
    got = F.unpack(getattr(plan, kind)(F.pack(vals, "cpu")))
    assert got == getattr(Domain(k), kind)(vals)


def test_roundtrip_batch():
    k = 6
    F = fr_field()
    plan = NttPlan(k, "cpu")
    x = F.pack(_values(99, 3 << k), "cpu", shape=(3, 1 << k))
    torch.testing.assert_close(plan.idft(plan.dft(x)), x, rtol=0, atol=0)
    torch.testing.assert_close(plan.coset_idft(plan.coset_dft(x)), x,
                               rtol=0, atol=0)
