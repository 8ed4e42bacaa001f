"""Public API: the reference's host prelude plus the torch entry point.

    from dusk_plonk_torch.prelude import *
    rng = ChaCha12Rng.seed_from_u64(8349)
    pp = PlonkParams.setup(k, rng)
    prover, verifier = compile_circuit_torch(pp, MyCircuit(), "cuda")
    proof, pis = prover.create_proof(rng, MyCircuit())
    verifier.verify(proof, pis)
"""

from dusk_plonk_tpu.prelude import (
    Plonk, PlonkKey, Prover, Verifier, Proof, Circuit, Constraint, Error,
    PlonkParams, ChaCha12Rng, fr_random, compile_circuit,
    BLS_SCALAR_MODULUS,
)

from .proving.keys import compile_circuit_torch
from .proving.engine import TorchEngine

__all__ = [
    "Plonk", "PlonkKey", "Prover", "Verifier", "Proof", "Circuit",
    "Constraint", "Error", "PlonkParams", "ChaCha12Rng", "fr_random",
    "compile_circuit", "compile_circuit_torch", "TorchEngine",
    "BLS_SCALAR_MODULUS",
]
