"""The slice as a whole: proofs from the torch engine (on the CPU, every kernel
as its plain version) against the host oracle, the same contract that
tests/test_device_engine.py pins for the JAX engine.  Both paths share the
transcript schedule and RNG draw order, so proofs from identical seeds are
identical, commitment for commitment and evaluation for evaluation."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dusk_plonk_tpu.prelude import (
    PlonkKey, PlonkParams, Circuit, ChaCha12Rng)
from dusk_plonk_tpu.composer.constraint import Constraint
from dusk_plonk_tpu.fields.constants import R_MOD
from dusk_plonk_torch.convert import limbs_from_numpy
from dusk_plonk_torch.prelude import Error as TorchError
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.proving.engine import TorchEngine
from dusk_plonk_torch.proving.keys import compile_circuit_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BoolCircuit(Circuit):
    def __init__(self, a=1):
        self.a = a

    def synthesize(self, composer):
        w = composer.append_witness(self.a)
        composer.component_boolean(w)


class MixedCircuit(Circuit):
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


FIELDS = ("a_comm", "b_comm", "c_comm", "d_comm", "z_comm", "t_low_comm",
          "t_mid_comm", "t_high_comm", "t_4_comm", "w_z_chall_comm",
          "w_z_chall_w_comm")


def _proofs_equal(p1, p2):
    for f in FIELDS:
        assert getattr(p1, f) == getattr(p2, f), f"mismatch at {f}"
    assert p1.evaluations == p2.evaluations


def _host_and_torch(k, circuit_cls):
    rng_h = ChaCha12Rng.seed_from_u64(8349)
    prover_h, verifier = PlonkKey.compile(PlonkParams.setup(k, rng_h),
                                          circuit_cls)
    rng_t = ChaCha12Rng.seed_from_u64(8349)
    prover_t, _ = compile_circuit_torch(PlonkParams.setup(k, rng_t),
                                        circuit_cls(), "cpu")
    return rng_h, prover_h, verifier, rng_t, prover_t


def test_torch_proof_equals_host_boolean():
    rng_h, prover_h, verifier, rng_t, prover_t = _host_and_torch(4,
                                                                 BoolCircuit)
    proof_h, pis_h = prover_h.create_proof(rng_h, BoolCircuit(1))
    proof_t, pis_t = prover_t.create_proof(rng_t, BoolCircuit(1))
    assert pis_h == pis_t
    _proofs_equal(proof_h, proof_t)
    verifier.verify(proof_t, pis_t)
    # second proof from the same stream still matches
    proof_h2, _ = prover_h.create_proof(rng_h, BoolCircuit(0))
    proof_t2, pis2 = prover_t.create_proof(rng_t, BoolCircuit(0))
    _proofs_equal(proof_h2, proof_t2)
    verifier.verify(proof_t2, pis2)


def test_torch_proof_equals_host_mixed():
    rng_h, prover_h, verifier, rng_t, prover_t = _host_and_torch(7,
                                                                 MixedCircuit)
    proof_h, pis = prover_h.create_proof(rng_h, MixedCircuit(13, 5))
    proof_t, pis_t = prover_t.create_proof(rng_t, MixedCircuit(13, 5))
    assert pis == pis_t
    _proofs_equal(proof_h, proof_t)
    verifier.verify(proof_t, pis_t)
    assert set(prover_t.engine.last_timings) == {
        "synthesize", "wire_pack", "round1", "round2", "round3", "evals",
        "rpoly", "openings"}


def test_torch_negative_unsatisfied():
    rng = ChaCha12Rng.seed_from_u64(8349)
    prover, _ = compile_circuit_torch(PlonkParams.setup(4, rng),
                                      BoolCircuit(), "cpu")
    with pytest.raises(TorchError):
        prover.create_proof(rng, BoolCircuit(2))


def test_convert_jax_packed_arrays():
    """The JAX package's packed numpy limbs (fr_field().pack,
    device_g1().pack_points) become tensors equal to the port's own, and
    an engine built from them proves the host oracle's proof."""
    from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
    from dusk_plonk_tpu.ops.ec import device_g1 as jax_g1
    from dusk_plonk_tpu.proving.engine import SEL_ORDER

    rng_h, prover_h, verifier, rng_t, prover_t = _host_and_torch(4,
                                                                 BoolCircuit)
    pk, n = prover_t.prover_key, prover_t.size
    sel = [v for name in SEL_ORDER for v in pk.selector_polys[name]]
    sig = [v for p in pk.sigma_polys for v in p]
    sel_np = np.asarray(jax_fr().pack(sel, shape=(11, n)))
    sig_np = np.asarray(jax_fr().pack(sig, shape=(4, n)))
    srs_np = tuple(np.asarray(c)
                   for c in jax_g1().pack_points(prover_t.keypair.powers))
    assert sel_np.dtype == np.uint32

    F = fr_field()
    torch.testing.assert_close(limbs_from_numpy(sel_np, "cpu"),
                               F.pack(sel, "cpu", shape=(11, n)),
                               rtol=0, atol=0)
    for a, b in zip(srs_np, device_g1().pack_points(prover_t.keypair.powers,
                                                    "cpu")):
        torch.testing.assert_close(limbs_from_numpy(a, "cpu"), b,
                                   rtol=0, atol=0)

    prover_t.use_device_engine(TorchEngine(
        prover_t, "cpu", sel_polys=sel_np, sigma_polys=sig_np, srs=srs_np))
    proof_h, _ = prover_h.create_proof(rng_h, BoolCircuit(1))
    proof_t, pis = prover_t.create_proof(rng_t, BoolCircuit(1))
    _proofs_equal(proof_h, proof_t)
    verifier.verify(proof_t, pis)


def test_limbs_from_numpy_rejects_wide_values():
    with pytest.raises(ValueError):
        limbs_from_numpy(np.array([[1 << 16]], np.uint32), "cpu")


JAX_FREE_PROOF = r"""
import sys
sys.modules["jax"] = None                  # any `import jax` now fails
sys.modules["dusk_plonk_tpu"] = None       # and so does the JAX package
import torch
torch.set_num_threads(1)
from dusk_plonk_torch.prelude import (
    Circuit, ChaCha12Rng, PlonkParams, compile_circuit_torch)

class BoolCircuit(Circuit):
    def __init__(self, a=1):
        self.a = a
    def synthesize(self, composer):
        composer.component_boolean(composer.append_witness(self.a))

rng = ChaCha12Rng.seed_from_u64(8349)
prover, verifier = compile_circuit_torch(PlonkParams.setup(4, rng),
                                         BoolCircuit(), "cpu")
proof, pis = prover.create_proof(rng, BoolCircuit(1))
verifier.verify(proof, pis)
assert not any(m.split(".")[0] in ("jax", "dusk_plonk_tpu") for m, v in
               sys.modules.items() if v is not None)
print("JAX_FREE_OK")
"""


def test_port_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", JAX_FREE_PROOF], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "JAX_FREE_OK" in res.stdout


def test_no_source_imports_jax():
    """No module of the port and nothing in chip_smoke.py imports jax or
    the JAX package, at the top of a file or inside a function."""
    pkg = os.path.join(ROOT, "dusk_plonk_torch")
    pattern = re.compile(
        r"^\s*(import\s+(jax|dusk_plonk_tpu)\b"
        r"|from\s+(jax|dusk_plonk_tpu)\b)", re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")]
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(sources) >= 30
    offenders = [p for p in sources if pattern.search(open(p).read())]
    assert offenders == []
