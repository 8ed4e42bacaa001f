"""The JAX package's switched-off configuration end to end in the port, on
the CPU (every kernel as its plain version): the MSM with `ec_scan_em`
(kernel K12 feeding the bucket phase) against the host MSM and the default
K11a route, and a k = 7 device setup, compilation and proof with both knobs
on (`ntt_mxu_min_k`: every NTT on the four-step route; `ec_scan_em`)
against the host oracle, byte for byte.  Scalars are made from a seed with
numpy."""

import numpy as np
import pytest
import torch

import dusk_plonk_tpu.prelude as jx
from dusk_plonk_tpu import native
from dusk_plonk_tpu.composer.constraint import Constraint
from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_torch.kzg.srs import PlonkParams
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.ops.msm import MsmPlan
from dusk_plonk_torch.proving.keys import compile_circuit_device
from dusk_plonk_torch.utils import config

torch.set_num_threads(1)

G1 = device_g1()


@pytest.fixture()
def alt_config():
    """Both knobs of the switched-off configuration, and a short chunk so
    that every MSM scans several chunks a row; restored afterwards."""
    old = config.get_config()
    config.set_config(ntt_mxu_min_k=1, ec_scan_em=True, msm_chunk_len=32)
    try:
        yield
    finally:
        config.set_config(ntt_mxu_min_k=old.ntt_mxu_min_k,
                          ec_scan_em=old.ec_scan_em,
                          msm_chunk_len=old.msm_chunk_len)


@pytest.fixture(scope="module")
def srs_points():
    return jx.PlonkParams.setup(10, jx.ChaCha12Rng.seed_from_u64(99)).powers


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % R_MOD
           for _ in range(n)]
    out[0] = 0
    out[1] = R_MOD - 1
    return out


@pytest.mark.parametrize("n", [37, 135])
def test_msm_with_ec_scan_em_matches_host(srs_points, alt_config, n):
    """The K12 route: window totals equal the K11a route's limb for limb,
    and the MSMs equal native.g1_msm."""
    pts = srs_points[:n]
    batch = [_scalars(300 * n + b, n) for b in range(2)]
    limbs = torch.stack([fr_field().pack(s, "cpu", to_mont=False)
                         for s in batch])
    plan = MsmPlan(n)
    assert plan.scan_em
    em = plan.prepare_points(G1.pack_points(pts, "cpu"))
    assert plan.msm_affine_batch(em, limbs) == \
        [native.g1_msm(pts, s) for s in batch]
    config.set_config(ec_scan_em=False)
    ladder = MsmPlan(n)
    assert not ladder.scan_em
    for a, b in zip(plan.window_totals(em, limbs),
                    ladder.window_totals(em, limbs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class MixedCircuit(jx.Circuit):
    """Arithmetic + range + logic + public input: four gate families."""

    def __init__(self, a=13, b=5):
        self.a = a
        self.b = b

    def synthesize(self, composer):
        w_a = composer.append_witness(self.a)
        w_b = composer.append_witness(self.b)
        prod = composer.gate_mul(Constraint().mult(1).a(w_a).b(w_b))
        composer.assert_equal_constant(prod, 0, (-self.a * self.b) % R_MOD)
        composer.component_range(w_a, 6)
        composer.append_logic_and(w_a, w_b, 8)
        composer.append_logic_xor(w_a, w_b, 8)


def test_alt_config_proof_equals_host_oracle_k7(alt_config):
    """Device setup, device compilation and a proof with every NTT on the
    four-step route and every chunk scan on K12: the key and the proof
    equal the host oracle's byte for byte, and verify."""
    assert config.get_config().msm_chunk_len < 1 << 7
    rng_h = jx.ChaCha12Rng.seed_from_u64(8349)
    prover_h, verifier = jx.PlonkKey.compile(
        jx.PlonkParams.setup(7, rng_h), MixedCircuit)
    rng_d = jx.ChaCha12Rng.seed_from_u64(8349)
    pp = PlonkParams.setup_device(7, rng_d, "cpu")
    prover_d, verifier_d = compile_circuit_device(pp, MixedCircuit(), "cpu")
    engine = prover_d.engine
    assert engine.plan_n.mxu and engine.plan_8n.mxu and engine.msm.scan_em
    assert prover_d.verifier_key.to_bytes() == \
        prover_h.verifier_key.to_bytes()
    proof_h, pis_h = prover_h.create_proof(rng_h, MixedCircuit(13, 5))
    proof_d, pis_d = prover_d.create_proof(rng_d, MixedCircuit(13, 5))
    assert pis_d == pis_h
    assert proof_d.to_bytes() == proof_h.to_bytes()
    verifier.verify(proof_d, pis_d)
    verifier_d.verify(proof_d, pis_d)
