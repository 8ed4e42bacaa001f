"""dusk_plonk_torch: the PLONK prover of dusk_plonk_tpu on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Layering:
  ops/        limb field arithmetic, NTT, G1 and Pippenger MSM on torch
              tensors; ops/kernels.py wraps the CUDA kernels of csrc/
  proving/    the device proving engine behind Prover.create_proof
  convert.py  the JAX package's packed numpy limbs -> torch tensors

The host layer (fields, curves, transcript, RNG, composer, KZG setup, the
host prover and verifier) is imported from dusk_plonk_tpu, which loads
without jax.  Nothing in this package imports jax.
"""
