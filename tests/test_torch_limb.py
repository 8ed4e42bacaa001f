"""dusk_plonk_torch.ops.limb (kernel K1's plain version on the CPU) against
the JAX LimbField (its XLA path on the CPU) and the host field oracle.

Inputs are made from a seed with numpy; every comparison is exact, limb for
limb, since the arithmetic is integer."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dusk_plonk_tpu.fields.constants import R_MOD, Q_MOD
from dusk_plonk_tpu.ops import limb as jlimb
from dusk_plonk_torch.ops import limb as tlimb
from dusk_plonk_torch.ops import kernels

torch.set_num_threads(1)

FIELDS = {"fr": (jlimb.fr_field, tlimb.fr_field, R_MOD),
          "fq": (jlimb.fq_field, tlimb.fq_field, Q_MOD)}
N = 256


def _values(p, seed, n=N):
    """n canonical values: 0, 1, p - 1, p - 2, then seeded random ones."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 12), dtype=np.uint64)
    vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") % p
            for w in words]
    vals[:4] = [0, 1, p - 1, p - 2]
    return vals


@pytest.fixture(scope="module", params=sorted(FIELDS))
def field(request):
    jf, tf, p = FIELDS[request.param]
    J, T = jf(), tf()
    a_int = _values(p, 1)
    b_int = _values(p, 2)[::-1]
    a_np = J.pack_host(a_int).astype(np.uint32)
    b_np = J.pack_host(b_int).astype(np.uint32)
    # Montgomery forms through the JAX package (its own mul by R^2)
    am = np.asarray(J.pack(a_int))
    bm = np.asarray(J.pack(b_int))
    return dict(J=J, T=T, p=p, a_int=a_int, b_int=b_int, a_np=a_np,
                b_np=b_np, am=am, bm=bm,
                at=torch.from_numpy(am.astype(np.int32)),
                bt=torch.from_numpy(bm.astype(np.int32)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


def test_pack_matches_jax(field):
    T = field["T"]
    _eq(T.pack(field["a_int"], "cpu"), field["am"])
    _eq(T.pack(field["a_int"], "cpu", to_mont=False), field["a_np"])


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_op_matches_jax(field, op):
    J, T = field["J"], field["T"]
    fn = J._mul_xla if op == "mul" else getattr(J, op)
    want = jax.jit(fn)(jnp.asarray(field["am"]), jnp.asarray(field["bm"]))
    _eq(getattr(T, op)(field["at"], field["bt"]), want)


@pytest.mark.parametrize("op", ["neg", "from_mont"])
def test_unary_op_matches_jax(field, op):
    J, T = field["J"], field["T"]
    if op == "from_mont":
        fn = lambda a: J._mul_xla(a, jnp.asarray(  # noqa: E731
            np.eye(J.L, 1, dtype=np.uint32)))
    else:
        fn = J.neg
    _eq(getattr(T, op)(field["at"]), jax.jit(fn)(jnp.asarray(field["am"])))


def test_mul_broadcasts_scalar_and_batch(field):
    """(L, 1) scalars and (B, L, 1) x (L, n) broadcasts, as the engine
    uses them (engine.py:426-431)."""
    T, p = field["T"], field["p"]
    a, b = field["a_int"], field["b_int"]
    s = T.pack([b[7]], "cpu")
    assert T.unpack(T.mul(field["at"], s)) == [x * b[7] % p for x in a]
    ks = T.pack(b[:4], "cpu").T.reshape(4, T.L, 1)         # (4, L, 1)
    got = T.unpack(T.mul(ks, field["at"]))
    assert got == [k * x % p for k in b[:4] for x in a]


def test_plain_mul_is_the_cpu_route(field):
    T = field["T"]
    _eq(kernels.mont_mul(T, field["at"], field["bt"]),
        T.mul_plain(field["at"], field["bt"]).numpy())


def test_inv_and_batch_inv(field):
    T, p = field["T"], field["p"]
    a = field["a_int"]
    assert T.unpack(T.inv(field["at"][:, :8])) == \
        [pow(x, -1, p) if x else 0 for x in a[:8]]
    with_zeros = field["at"].clone()
    with_zeros[:, 5] = 0
    want = [pow(x, -1, p) if x else 0 for x in a]
    want[5] = 0
    assert T.unpack(T.batch_inv(with_zeros)) == want


def test_prefix_mul_powers_dot(field):
    T, p = field["T"], field["p"]
    a, b = field["a_int"], field["b_int"]
    acc, want = 1, []
    for x in a:
        acc = acc * x % p
        want.append(acc)
    assert T.unpack(T.prefix_mul(field["at"])) == want
    base = b[9]
    pw = T.powers(T.pack([base], "cpu"), 37)
    assert T.unpack(pw) == [pow(base, i, p) for i in range(37)]
    assert T.unpack(T.powers_host_base(base, 37, "cpu", scale=3)) == \
        [3 * pow(base, i, p) % p for i in range(37)]
    dot = T.dot(field["at"][None], field["bt"][None])
    assert T.unpack(dot) == [sum(x * y for x, y in zip(a, b)) % p]
    rows = torch.stack([field["at"], field["bt"], field["at"]])
    assert T.unpack(T.sum_reduce(rows)) == \
        [(2 * x + y) % p for x, y in zip(a, b)]


def test_pow_const_matches_jax(field):
    J, T = field["J"], field["T"]
    e = 0xABCD
    want = jax.jit(lambda x: J.pow_const(x, e))(jnp.asarray(field["am"][:, :8]))
    _eq(T.pow_const(field["at"][:, :8], e), want)


def test_non_cpu_tensor_never_takes_the_plain_route(field):
    T = field["T"]
    meta = torch.empty((T.L, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.mont_mul(T, meta, meta)
