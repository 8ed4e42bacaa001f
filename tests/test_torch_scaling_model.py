"""The port's scaling model (dusk_plonk_torch/parallel/model.py) against
its tracer and against the JAX package's model: the counterparts of
tests/test_scaling_model.py with the card's rates (NVIDIA H100 80GB HBM3
at 700 W, measured by chip_smoke.py; NVLink 4 at NVIDIA's published 450
GB/s each way)."""

import random

import pytest
import torch

from dusk_plonk_tpu.parallel.model import (
    proof_collective_bytes as jax_proof_collective_bytes)
from dusk_plonk_torch.fields.constants import R_MOD
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel.model import (
    FR_BYTES, MeshModel, proof_collective_bytes, projected_efficiency)
from dusk_plonk_torch.parallel.ntt import distributed_ntt
from dusk_plonk_torch.utils.tracing import tracer

torch.set_num_threads(1)


def test_ntt_counter_matches_model_term():
    d, k = 8, 6
    n = 1 << k
    F = fr_field()
    rnd = random.Random(0)
    x = F.pack([rnd.randrange(R_MOD) for _ in range(4 * n)], "cpu",
               shape=(4, n))
    mesh = M.Mesh(["cpu"] * d)
    xs = M.shard(mesh, x)
    tracer.reset()
    distributed_ntt(mesh, "shard", xs, k, "idft")
    nbytes = 4 * n * FR_BYTES
    assert tracer.counters["collective_bytes"] == \
        nbytes * (d - 1) // d + nbytes * (d - 1)
    assert tracer.counters["collective_ops"] == 2


def test_projected_efficiency_with_the_cards_rates():
    e20 = projected_efficiency(20, 8)
    e24 = projected_efficiency(24, 64)
    assert e20["efficiency"] > 0.70
    # the value the model's own constants give: a faster chip leaves less
    # compute to hide the links behind (with TPU v5e rates the JAX model
    # gives more)
    assert e24["efficiency"] == 0.7303
    # traffic self-consistency: bytes grow linearly in n, and the
    # all-gather term dominates the four-step schedule
    t = proof_collective_bytes(20, 8)
    t2 = proof_collective_bytes(21, 8)
    assert 1.9 < t2["ntt_all_gather"] / t["ntt_all_gather"] < 2.1
    assert t["ntt_all_gather"] > t["ntt_all_to_all"]


def test_efficiency_degrades_gracefully_with_slow_links():
    slow = MeshModel(link_gbps=10.0)
    fast = MeshModel(link_gbps=900.0)
    assert projected_efficiency(20, 8, fast)["efficiency"] > \
        projected_efficiency(20, 8, slow)["efficiency"]


@pytest.mark.parametrize("k,d", [(6, 8), (16, 4), (20, 8), (24, 64)])
def test_traffic_formula_equals_the_jax_one(k, d):
    assert proof_collective_bytes(k, d) == jax_proof_collective_bytes(k, d)
