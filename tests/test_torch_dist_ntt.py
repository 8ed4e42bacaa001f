"""The port's distributed four-step NTT (dusk_plonk_torch/parallel/ntt.py)
against the JAX package's (dusk_plonk_tpu/parallel/ntt.py), limb for limb,
on CPU meshes: the JAX one over the 8-device CPU mesh of tests/conftest.py
(or its first 4 devices), the port's over D shards of the CPU device.
The tracer counters of one call equal the JAX tracer's.  The small-domain
fallback is held against the host Domain oracle."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
from dusk_plonk_tpu.parallel.ntt import distributed_ntt as jax_dist_ntt
from dusk_plonk_tpu.poly.domain import Domain
from dusk_plonk_tpu.utils.tracing import tracer as jax_tracer
from dusk_plonk_torch.convert import limbs_from_numpy
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel.ntt import distributed_ntt
from dusk_plonk_torch.utils.tracing import tracer

torch.set_num_threads(1)

KINDS = ("dft", "idft", "coset_dft", "coset_idft")
COUNTERS = ("collective_ops", "collective_bytes")


def _values(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(count)]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d", [8, 4])
def test_distributed_ntt_equals_jax(d, batched):
    k = 6
    n = 1 << k
    B = 3 if batched else 1
    shape = (B, n) if batched else (n,)
    packed = jax_fr().pack(_values(10 * d + B, B * n), shape=shape)
    jmesh = JaxMesh(np.array(jax.devices()[:d]), axis_names=("shard",))
    spec = P(None, None, "shard") if batched else P(None, "shard")
    jx = jax.device_put(packed, NamedSharding(jmesh, spec))
    mesh = M.Mesh(["cpu"] * d)
    xs = M.shard(mesh, limbs_from_numpy(np.asarray(packed), "cpu"))
    for kind in KINDS:
        jax_tracer.reset()
        with jmesh:
            want = np.asarray(jax_dist_ntt(jmesh, "shard", jx, k, kind))
        tracer.reset()
        got = distributed_ntt(mesh, "shard", xs, k, kind)
        assert [x.shape[-1] for x in got] == [n // d] * d
        assert np.array_equal(M.gather(mesh, got).numpy(),
                              want.astype(np.int32)), kind
        for c in COUNTERS:
            assert tracer.counters[c] == jax_tracer.counters[c], (kind, c)


def test_distributed_ntt_round_trip():
    k, d = 6, 8
    F = fr_field()
    vals = _values(3, 1 << k)
    mesh = M.Mesh(["cpu"] * d)
    xs = M.shard(mesh, F.pack(vals, "cpu"))
    back = distributed_ntt(mesh, "shard",
                           distributed_ntt(mesh, "shard", xs, k, "coset_dft"),
                           k, "coset_idft")
    assert F.unpack(M.gather(mesh, back)) == vals


def test_small_domain_fallback_equals_host_domain():
    """k = 5 < log2(D^2) at D = 8: gather, single-plan transform,
    re-shard; no collective of the four-step is counted."""
    k, d = 5, 8
    F = fr_field()
    dom = Domain(k)
    vals = _values(6, 1 << k)
    mesh = M.Mesh(["cpu"] * d)
    xs = M.shard(mesh, F.pack(vals, "cpu"))
    want = {"dft": dom.dft(vals), "idft": dom.idft(vals),
            "coset_dft": dom.coset_dft(vals),
            "coset_idft": dom.coset_idft(vals)}
    tracer.reset()
    for kind in KINDS:
        got = distributed_ntt(mesh, "shard", xs, k, kind)
        assert [x.shape[-1] for x in got] == [4] * d
        assert F.unpack(M.gather(mesh, got)) == want[kind], kind
    assert tracer.counters["collective_ops"] == 0
