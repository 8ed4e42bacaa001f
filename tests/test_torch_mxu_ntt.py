"""The port's four-step NTT (dusk_plonk_torch/ops/mxu_ntt.py, int8 digit
products by torch._int_mm, kernel K13's plain version on the CPU) against
the JAX package's (dusk_plonk_tpu/ops/mxu_ntt.py, forced onto the CPU with
ntt_mxu_force: int8 einsums and the Pallas reduction in interpret mode)
and the host domain oracle.

Inputs are made from a seed with numpy; every comparison is exact, limb
for limb."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dusk_plonk_tpu.ops.mxu_ntt as jmx
from dusk_plonk_tpu.ops import ntt as jax_ntt
from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
from dusk_plonk_tpu.poly.domain import Domain
from dusk_plonk_tpu.utils import config as jax_config
from dusk_plonk_torch.fields.constants import R_MOD
from dusk_plonk_torch.ops import kernels, mxu_ntt
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.ntt import NttPlan
from dusk_plonk_torch.utils import config

torch.set_num_threads(1)

K = 6                       # 64 points: n1 = n2 = 8
KINDS = ("dft", "idft", "coset_dft", "coset_idft")


def _values(seed, count):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % R_MOD
            for w in words]


@pytest.fixture(scope="module")
def jax_mxu_plan():
    old = jax_config.get_config()
    jax_config.set_config(ntt_mxu_min_k=K, ntt_mxu_force=True)
    jax_ntt.ntt_plan.cache_clear()
    try:
        plan = jax_ntt.ntt_plan(K)
        assert plan.mxu
        yield plan
    finally:
        jax_config.set_config(ntt_mxu_min_k=old.ntt_mxu_min_k,
                              ntt_mxu_force=old.ntt_mxu_force)
        jax_ntt.ntt_plan.cache_clear()


@pytest.fixture()
def mxu_config():
    """The port's config with the four-step route on from 2^K, restored
    afterwards."""
    old = config.get_config()
    config.set_config(ntt_mxu_min_k=K)
    try:
        yield
    finally:
        config.set_config(ntt_mxu_min_k=old.ntt_mxu_min_k)


def test_to_digits_matches_host_digits():
    vals = _values(1, 60) + [0, 1, R_MOD - 1, (1 << 255) - 1]
    x = fr_field().pack(vals, "cpu", to_mont=False)
    got = mxu_ntt._to_digits(x).numpy()
    np.testing.assert_array_equal(got, mxu_ntt._balanced_digits_host(vals))
    assert sum(int(got[i, 62]) << (8 * i) for i in range(33)) == R_MOD - 1


def test_host_tables_match_jax():
    vals = _values(2, 17)
    np.testing.assert_array_equal(mxu_ntt._balanced_digits_host(vals),
                                  jmx._balanced_digits_host(vals))
    w = pow(5, (R_MOD - 1) // 8, R_MOD)
    np.testing.assert_array_equal(mxu_ntt._dft_matrix_digits(8, w),
                                  jmx._dft_matrix_digits(8, w))


@pytest.mark.parametrize("shape", [(40, 8, 16), (33, 5, 3), (66, 12, 20)])
def test_int8_mm_pads_to_the_exact_product(shape):
    m, kk, w = shape
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-128, 128, (m, kk), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (kk, w), dtype=np.int8))
    got = mxu_ntt._int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, w)
    torch.testing.assert_close(got, a.int() @ b.int(), rtol=0, atol=0)


def _real_planes(seed, batch, m, t):
    """Product planes of a Montgomery DFT matrix times random limbs, as
    mod_matmul forms them: (batch, 65, m * t) int32."""
    F = fr_field()
    x = F.pack(_values(seed, batch * m * t), "cpu",
               shape=(batch, m * t)).reshape(batch, 16, m, t)
    w = pow(7, (R_MOD - 1) // m, R_MOD)
    wd = torch.from_numpy(mxu_ntt._dft_matrix_digits(m, w))
    xd = mxu_ntt._to_digits(x.reshape(batch, 16, m * t))
    planes = mxu_ntt.int8_products(wd, xd.reshape(batch, 33, m, t))
    return planes.reshape(batch, 65, m * t)


def test_reduce_planes_plain_matches_jax():
    """K13's plain version against the JAX Pallas kernel in interpret
    mode, on two leading rows of real digit products (with one all-zero
    element)."""
    planes = _real_planes(3, 2, 16, 8)
    planes[1, :, 5] = 0
    got = kernels.reduce_planes(fr_field(), planes)
    want = np.asarray(jmx.reduce_planes(
        jnp.asarray(planes.numpy()), interpret=True))
    assert got.shape == (2, 16, 128)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert not got[1, :, 5].any()


def test_mod_matmul_value():
    """mod_matmul = Mont(W X) 2^-16 against host integers."""
    F = fr_field()
    m, t = 8, 8
    xv = _values(4, m * t)
    w = pow(7, (R_MOD - 1) // m, R_MOD)
    wd = torch.from_numpy(mxu_ntt._dft_matrix_digits(m, w))
    x = F.pack(xv, "cpu").reshape(16, m, t)
    got = F.unpack(mxu_ntt.mod_matmul(F, wd, x).reshape(16, m * t))
    inv16 = pow(1 << 16, -1, R_MOD)
    want = [sum(pow(w, i * j % m, R_MOD) * xv[j * t + c] for j in range(m))
            * inv16 % R_MOD for i in range(m) for c in range(t)]
    assert got == want


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_four_step_matches_jax_and_host(jax_mxu_plan, mxu_config, kind,
                                        batch):
    vals = _values(10 + batch, batch << K)
    J = jax_fr()
    x = np.asarray(J.pack(vals, shape=(batch, 1 << K)))    # (B, 16, n)
    want = np.asarray(getattr(jax_mxu_plan, kind)(jnp.asarray(x)))
    plan = NttPlan(K, "cpu")
    assert plan.mxu and not hasattr(plan, "bitrev")
    got = getattr(plan, kind)(torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    F = fr_field()
    host = getattr(Domain(K), kind)
    out = F.unpack(got)
    n = 1 << K
    for b in range(batch):
        assert out[b * n:(b + 1) * n] == host(vals[b * n:(b + 1) * n])


def test_route_follows_the_config(mxu_config):
    assert NttPlan(K, "cpu").mxu
    assert not NttPlan(K - 1, "cpu").mxu           # below ntt_mxu_min_k
    config.set_config(ntt_mxu_min_k=None)
    assert not NttPlan(K, "cpu").mxu
    assert mxu_ntt.supported(22) and not mxu_ntt.supported(23)
