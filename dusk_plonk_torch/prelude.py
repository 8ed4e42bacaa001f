"""Public API surface, mirroring the reference prelude
(src/prelude.rs:12-20) with the names of dusk_plonk_tpu/prelude.py: Plonk,
PlonkKey(compile), Prover, Verifier, Proof, WitnessPoint, scalar types,
Circuit, Error, Constraint; plus the torch entry points.

    from dusk_plonk_torch.prelude import *
    rng = ChaCha12Rng.seed_from_u64(8349)
    pp = PlonkParams.setup_device(k, rng)              # on the GPU
    prover, verifier = PlonkKey.compile_device(pp, MyCircuit)
    proof, pis = prover.create_proof(rng, MyCircuit())
    verifier.verify(proof, pis)

Device entry points run on "cuda" unless given another device.
"""

from .composer.composer import (
    Plonk, Circuit, WitnessPoint, Error, UnsupportedWNAF2k,
    InconsistentPublicInputsLen, ProofVerificationError, PairingCheckFailure,
)
from .composer.constraint import Constraint
from .proving.keys import (
    compile_circuit, compile_circuit_device, compile_circuit_torch)
from .proving.engine import TorchEngine
from .proving.prover import Prover
from .proving.verifier import Verifier
from .proving.proof import Proof
from .kzg.srs import PlonkParams, EvaluationKey
from .rng.chacha import ChaCha12Rng, fr_random
from .fields.constants import R_MOD as BLS_SCALAR_MODULUS
from .curves import jubjub

# Scalar/point type names from the reference prelude (src/prelude.rs:12-20):
# field elements are canonical Python ints and curve points (x, y) tuples.
BlsScalar = int
JubjubScalar = int
JubjubAffine = tuple
JubjubExtended = tuple


class PlonkKey:
    """Keypair compiler (reference src/key.rs PlonkKey)."""

    @staticmethod
    def compile(params: PlonkParams, circuit_cls, label: bytes = b"plonk"):
        return compile_circuit(params, circuit_cls(), label)

    @staticmethod
    def compile_with_circuit(params: PlonkParams, label: bytes, circuit):
        return compile_circuit(params, circuit, label)

    @staticmethod
    def compile_device(params: PlonkParams, circuit_cls,
                       label: bytes = b"plonk", device="cuda"):
        """Key compilation on the device; returns a prover with the torch
        engine attached, and the verifier."""
        return compile_circuit_device(params, circuit_cls(), device, label)


__all__ = [
    "Plonk", "PlonkKey", "Prover", "Verifier", "Proof", "WitnessPoint",
    "Circuit", "Constraint", "Error", "PlonkParams", "EvaluationKey",
    "ChaCha12Rng", "fr_random", "BLS_SCALAR_MODULUS", "jubjub",
    "UnsupportedWNAF2k", "InconsistentPublicInputsLen",
    "ProofVerificationError", "PairingCheckFailure", "compile_circuit",
    "compile_circuit_device", "compile_circuit_torch", "TorchEngine",
    "BlsScalar", "JubjubScalar", "JubjubAffine", "JubjubExtended",
]
