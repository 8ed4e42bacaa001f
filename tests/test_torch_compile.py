"""Device SRS setup and device key compilation of the port (kzg/srs.py::
PlonkParams.setup_device, proving/keys.py::compile_circuit_device), run on
the CPU with every kernel as its plain version, against the JAX package's
host setup, host key compilation and host prover (the oracle)."""

import numpy as np
import pytest
import torch

import dusk_plonk_tpu.prelude as jx
from dusk_plonk_tpu.composer.constraint import Constraint
from dusk_plonk_tpu.fields.constants import Q_MOD, R_MOD
from dusk_plonk_torch.convert import params_from_jax
from dusk_plonk_torch.kzg.srs import PlonkParams
from dusk_plonk_torch.ops.limb import fq_field
from dusk_plonk_torch.proving.keys import compile_circuit_device

torch.set_num_threads(1)


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


class BoolCircuit(jx.Circuit):
    def __init__(self, a=1):
        self.a = a

    def synthesize(self, composer):
        composer.component_boolean(composer.append_witness(self.a))


def test_setup_device_equals_host_setup():
    rng_h = jx.ChaCha12Rng.seed_from_u64(31)
    host = jx.PlonkParams.setup(5, rng_h)
    rng = jx.ChaCha12Rng.seed_from_u64(31)
    dev = PlonkParams.setup_device(5, rng, "cpu")
    assert dev.powers == host.powers
    assert (dev.h, dev.beta_h) == (host.h, host.beta_h)
    assert rng.next_u64() == rng_h.next_u64()     # one draw, as setup
    # the device's affine planes ride along: Z = Montgomery 1 everywhere
    one = fq_field().const("one_mont", "cpu")
    assert dev.packed[0].shape == (24, (1 << 5) + 7)
    assert torch.equal(dev.packed[2], one.expand_as(dev.packed[2]))
    assert set(dev.setup_timings) == {"window_tables", "pack_tables",
                                      "tau_ladder", "pack_ladder",
                                      "device_reduce", "to_affine", "g2"}


def test_compile_device_equals_host_compile_k7():
    rng_h = jx.ChaCha12Rng.seed_from_u64(8349)
    prover_h, verifier = jx.PlonkKey.compile(
        jx.PlonkParams.setup(7, rng_h), MixedCircuit)
    rng_d = jx.ChaCha12Rng.seed_from_u64(8349)
    pp = PlonkParams.setup_device(7, rng_d, "cpu")
    prover_d, verifier_d = compile_circuit_device(pp, MixedCircuit(), "cpu")
    assert prover_d.verifier_key.commitments == \
        prover_h.verifier_key.commitments
    assert prover_d.verifier_key.to_bytes() == \
        prover_h.verifier_key.to_bytes()
    proof_h, pis_h = prover_h.create_proof(rng_h, MixedCircuit(13, 5))
    proof_d, pis_d = prover_d.create_proof(rng_d, MixedCircuit(13, 5))
    assert pis_d == pis_h
    assert proof_d.to_bytes() == proof_h.to_bytes()
    verifier.verify(proof_d, pis_d)
    verifier_d.verify(proof_d, pis_d)
    assert set(prover_d.engine.compile_timings) == {
        "synthesize", "pack_columns", "sigma_permutation", "polys",
        "pack_srs", "commit15", "engine"}


def _jax_packed_params(k, seed):
    """A JAX PlonkParams in its packed form (three (24, N) uint32 planes
    of Montgomery affine coordinates, as PlonkParams.from_packed_npz
    loads them), with no host powers."""
    host = jx.PlonkParams.setup(k, jx.ChaCha12Rng.seed_from_u64(seed))
    R = (1 << 384) % Q_MOD

    def plane(vals):
        buf = b"".join((v * R % Q_MOD).to_bytes(48, "little") for v in vals)
        return np.frombuffer(buf, "<u2").reshape(len(vals), 24).T \
            .astype(np.uint32)

    packed = (plane([p[0] for p in host.powers]),
              plane([p[1] for p in host.powers]),
              plane([1] * len(host.powers)))
    return host, jx.PlonkParams(None, host.h, host.beta_h, packed=packed,
                                g=host.powers[0])


def test_convert_jax_packed_srs_gives_the_same_commitments():
    host, packed = _jax_packed_params(4, 77)
    pp = params_from_jax(packed)
    assert pp.powers is None and pp.n_powers() == host.n_powers()
    prover_d, _ = compile_circuit_device(pp, BoolCircuit(), "cpu")
    prover_h, _ = jx.compile_circuit(host, BoolCircuit())
    assert prover_d.verifier_key.to_bytes() == \
        prover_h.verifier_key.to_bytes()


def test_compile_device_rejects_a_short_srs():
    pp = PlonkParams.setup_device(2, jx.ChaCha12Rng.seed_from_u64(1), "cpu")
    with pytest.raises(ValueError):
        compile_circuit_device(pp, MixedCircuit(), "cpu")
