"""The port's mesh-sharded prover (dusk_plonk_torch/proving/
sharded_engine.py) on an 8-shard CPU mesh: its proof equals, byte for
byte, the JAX package's host-oracle proof from the same seed, and
verifies.

The circuit is tests/test_sharded_engine.py's: n = 64 >= D^2, so both the
n and the 8n domain take the four-step route at D = 8, and the SRS (ns =
n + 7) is padded to a shard multiple.  Each proof takes tens of seconds
on the plain versions, so the cases are split over files: D = 2 is
test_torch_sharded_engine_d2.py, the bit-serial MSM tier
test_torch_sharded_engine_bits.py, and the single-device TorchEngine's
proof of the same circuit, equal to the same host-oracle bytes, is in
test_torch_sharded_step.py."""

import dusk_plonk_tpu.prelude as jx
import dusk_plonk_torch.prelude as pt
import torch

from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.proving.sharded_engine import ShardedEngine
from dusk_plonk_torch.utils.tracing import tracer

torch.set_num_threads(1)

SEED = 8349


def wide_circuit(pkg):
    class WideCircuit(pkg.Circuit):
        """> 32 gates, so n = 64."""

        def __init__(self, a=3):
            self.a = a

        def synthesize(self, c):
            w = c.append_witness(self.a)
            c.component_boolean(c.append_witness(1))
            acc = w
            for _ in range(40):
                acc = c.gate_mul(pkg.Constraint().mult(1).a(acc).b(w))

    return WideCircuit


def host_proof():
    """The JAX package's host oracle: (proof bytes, public inputs,
    verifier)."""
    Wide = wide_circuit(jx)
    rng = jx.ChaCha12Rng.seed_from_u64(SEED)
    prover, verifier = jx.PlonkKey.compile(jx.PlonkParams.setup(7, rng),
                                           Wide)
    assert prover.size == 64
    proof, pis = prover.create_proof(rng, Wide(3))
    return proof.to_bytes(), pis, verifier


def sharded_proof(d, msm_tier="pippenger"):
    """The port's ShardedEngine proof on d CPU shards: (proof, public
    inputs, engine)."""
    Wide = wide_circuit(pt)
    rng = pt.ChaCha12Rng.seed_from_u64(SEED)
    prover, _ = pt.PlonkKey.compile(pt.PlonkParams.setup(7, rng), Wide)
    engine = ShardedEngine(prover, mesh=M.Mesh(["cpu"] * d),
                           msm_tier=msm_tier)
    prover.use_device_engine(engine)
    tracer.reset()
    proof, pis = prover.create_proof(rng, Wide(3))
    return proof, pis, engine


def check_against_host(proof, pis):
    want, want_pis, verifier = host_proof()
    assert pis == want_pis
    assert proof.to_bytes() == want
    verifier.verify(jx.Proof.from_bytes(proof.to_bytes()), pis)


def test_sharded_proof_d8_equals_host():
    proof, pis, engine = sharded_proof(8)
    assert (engine.D, engine.n, engine.ns, engine.nsd) == (8, 64, 71, 72)
    check_against_host(proof, pis)
    # both domains four-step: 2 collectives for each of the 5 transform
    # calls; 3 for each of the 4 commit batches; 1 for each of the 3
    # grand products (round 2's and the batch inversion's two)
    assert tracer.counters["collective_ops"] == 5 * 2 + 4 * 3 + 3
    assert tracer.counters["msm_dispatch"] == 4
    assert tracer.counters["gather_bytes"] > 0
    assert set(k for k in tracer.spans if k.startswith("prove.")) == {
        "prove." + k for k in engine.last_timings}
