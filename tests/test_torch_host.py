"""The port's own host layer (fields, curves, transcript, RNG, composer, KZG,
host prover and verifier, and the ctypes binding of native/): the port runs
with jax and the JAX package both blocked (its every module imported, a
device proof and a sharded proof on a two-shard CPU mesh made and
verified), and its copied host modules give the JAX package's keys and
proofs byte for byte."""

import os
import subprocess
import sys

import pytest

import dusk_plonk_tpu.prelude as jx
import dusk_plonk_torch.prelude as pt
from dusk_plonk_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ISOLATED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                  # any `import jax` now fails
sys.modules["dusk_plonk_tpu"] = None       # and so does the JAX package
import torch
torch.set_num_threads(1)
import dusk_plonk_torch
names = [m.name for m in pkgutil.walk_packages(dusk_plonk_torch.__path__,
                                               "dusk_plonk_torch.")]
for name in names:
    importlib.import_module(name)
from dusk_plonk_torch.prelude import (
    Circuit, ChaCha12Rng, PlonkKey, PlonkParams)

class BoolCircuit(Circuit):
    def __init__(self, a=1):
        self.a = a
    def synthesize(self, composer):
        composer.component_boolean(composer.append_witness(self.a))

rng = ChaCha12Rng.seed_from_u64(8349)
pp = PlonkParams.setup_device(4, rng, "cpu")
prover, verifier = PlonkKey.compile_device(pp, BoolCircuit, device="cpu")
proof, pis = prover.create_proof(rng, BoolCircuit(1))
verifier.verify(proof, pis)
import dusk_plonk_torch.parallel
from dusk_plonk_torch.parallel.mesh import Mesh
from dusk_plonk_torch.proving.sharded_engine import ShardedEngine
eng = prover.engine
prover.use_device_engine(ShardedEngine(
    prover, mesh=Mesh(["cpu"] * 2), sel_polys=eng.sel_polys,
    sigma_polys=eng.sigma_polys, srs=eng.srs, wire_plan=eng._wire_plan))
proof, pis = prover.create_proof(rng, BoolCircuit(1))
verifier.verify(proof, pis)
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "dusk_plonk_tpu")]
assert loaded == [], loaded
print("ISOLATED_OK", len(names))
"""


def test_port_imports_and_proves_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", ISOLATED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("ISOLATED_OK")]
    assert line and int(line[0].split()[1]) >= 40


def test_native_binding_builds_into_the_port_build_dir():
    assert native.available()
    assert native._SO.startswith(os.path.join(ROOT, "build", ""))
    assert os.path.exists(native._SO)


def _bool_circuit(base):
    class BoolCircuit(base):
        def __init__(self, a=1):
            self.a = a

        def synthesize(self, composer):
            composer.component_boolean(composer.append_witness(self.a))

    return BoolCircuit


def _keys_and_proof(pkg):
    Circuit = _bool_circuit(pkg.Circuit)
    rng = pkg.ChaCha12Rng.seed_from_u64(8349)
    prover, verifier = pkg.PlonkKey.compile(pkg.PlonkParams.setup(4, rng),
                                            Circuit)
    proof, pis = prover.create_proof(rng, Circuit(1))
    return prover, verifier, proof, pis


@pytest.fixture(scope="module")
def both():
    return _keys_and_proof(jx), _keys_and_proof(pt)


def test_copied_host_layer_gives_the_same_bytes(both):
    (p_j, _, proof_j, pis_j), (p_t, _, proof_t, pis_t) = both
    assert type(proof_t).__module__.startswith("dusk_plonk_torch")
    assert p_t.verifier_key.to_bytes() == p_j.verifier_key.to_bytes()
    assert proof_t.to_bytes() == proof_j.to_bytes()
    assert pis_t == pis_j


@pytest.mark.parametrize("prover_pkg", ["jax", "torch"])
def test_each_verifier_accepts_the_others_proof_bytes(both, prover_pkg):
    (_, v_j, proof_j, pis), (_, v_t, proof_t, _) = both
    if prover_pkg == "jax":
        verifier, proof = v_t, pt.Proof.from_bytes(proof_j.to_bytes())
    else:
        verifier, proof = v_j, jx.Proof.from_bytes(proof_t.to_bytes())
    verifier.verify(proof, pis)
    forged = type(proof).from_bytes(proof.to_bytes())
    forged.evaluations["a_eval"] = (forged.evaluations["a_eval"] + 1) \
        % pt.BLS_SCALAR_MODULUS
    with pytest.raises(Exception):
        verifier.verify(forged, pis)
