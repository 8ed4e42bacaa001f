"""The port's two-phase sharded scans (dusk_plonk_torch/parallel/
prover_step.py: grand_product_sharded, batch_inv_sharded) against the JAX
package's on CPU meshes of D = 2, 4, 8 shards, limb for limb, with zero
entries in the batch inversion."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
from dusk_plonk_tpu.parallel.prover_step import (
    batch_inv_sharded as jax_batch_inv, grand_product_sharded as jax_gp)
from dusk_plonk_tpu.utils.tracing import tracer as jax_tracer
from dusk_plonk_torch.convert import limbs_from_numpy
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel.prover_step import (
    batch_inv_sharded, grand_product_sharded)
from dusk_plonk_torch.utils.tracing import tracer

torch.set_num_threads(1)

N = 64


def _inputs(d, zeros):
    rng = np.random.default_rng(100 + d)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(N)]
    for i in zeros:
        vals[i] = 0
    packed = jax_fr().pack(vals)
    return packed, limbs_from_numpy(np.asarray(packed), "cpu")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_grand_product_sharded_equals_jax(d):
    packed, x = _inputs(d, ())
    jmesh = JaxMesh(np.array(jax.devices()[:d]), axis_names=("shard",))
    jax_tracer.reset()
    with jmesh:
        want = np.asarray(jax.jit(
            lambda r: jax_gp(jmesh, "shard", r))(packed))
    mesh = M.Mesh(["cpu"] * d)
    tracer.reset()
    got = M.gather(mesh, grand_product_sharded(mesh, "shard",
                                               M.shard(mesh, x)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    for c in ("collective_ops", "collective_bytes"):
        assert tracer.counters[c] == jax_tracer.counters[c], c


@pytest.mark.parametrize("d", [2, 4, 8])
def test_batch_inv_sharded_equals_jax(d):
    # zeros inside a shard, at both ends and on a shard boundary
    zeros = (0, 5, N // d, N - 1)
    packed, x = _inputs(d, zeros)
    jmesh = JaxMesh(np.array(jax.devices()[:d]), axis_names=("shard",))
    F = fr_field()
    with jmesh:
        want = np.asarray(jax.jit(
            lambda a: jax_batch_inv(jmesh, "shard", jax_fr(), a))(packed))
    mesh = M.Mesh(["cpu"] * d)
    got = M.gather(mesh, batch_inv_sharded(mesh, "shard", F,
                                           M.shard(mesh, x)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    inv = F.unpack(got, from_mont=False)
    vals = F.unpack(x, from_mont=False)
    R = F.spec.mont_r
    for i, (v, w) in enumerate(zip(vals, inv)):
        # Montgomery: v R * w R / R = 1 R, and zeros stay zero
        assert (v * w * pow(R, -1, R_MOD) % R_MOD == R % R_MOD) \
            if v else w == 0, i
