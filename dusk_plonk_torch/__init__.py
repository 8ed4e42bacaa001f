"""dusk_plonk_torch: the PLONK prover of dusk_plonk_tpu on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Layering:
  fields/ curves/ transcript/ rng/   host exactness engine (bit-exact
                                     oracle), copied from the JAX package
  poly/ kzg/ composer/ proving/      the PLONK protocol stack; kzg/srs.py
                                     and proving/keys.py add device SRS
                                     setup and key compilation, and
                                     proving/engine.py is the device engine
  native.py                          ctypes binding of the host C++ engine
                                     (native/dusk_native.cpp)
  ops/                               limb field arithmetic, NTT, G1 and
                                     Pippenger MSM on torch tensors;
                                     ops/kernels.py wraps the CUDA kernels
                                     of csrc/
  convert.py                         the JAX package's packed numpy limbs
                                     and SRS -> the port's

Nothing in this package imports jax or dusk_plonk_tpu; only the tests
import both, to hold the port against the reference.
"""
