"""Key compilation for the torch engine."""

from __future__ import annotations

from dusk_plonk_tpu.proving.keys import compile_circuit

from .engine import TorchEngine


def compile_circuit_torch(params, circuit, device, label: bytes = b"plonk"):
    """Host key compilation (dusk_plonk_tpu.proving.keys.compile_circuit)
    with a TorchEngine on `device` attached to the prover: afterwards
    `prover.create_proof(rng, circuit)` runs the port.  Returns
    (prover, verifier)."""
    prover, verifier = compile_circuit(params, circuit, label)
    prover.use_device_engine(TorchEngine(prover, device))
    return prover, verifier
