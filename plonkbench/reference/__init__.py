"""The plain reference that decides a run's `correct`.

`check.py` is the check itself, `fr_limbs.py` its Fr vectors in plain
PyTorch.  The other modules are frozen copies of the
port's host layer, kept here so that the reference imports nothing of the
program (`dusk_plonk_torch`) and nothing of the JAX package, and so that a
later change to the program cannot move the yardstick:

  constants.py   <- dusk_plonk_torch/fields/constants.py
  host.py        <- dusk_plonk_torch/fields/host.py (Fr, Fq, Fq2)
  bls.py         <- dusk_plonk_torch/curves/bls.py (pure Python G1 / G2
                    arithmetic and the compressed G1 encoding)
  constraint.py, composer.py, permutation.py
                 <- dusk_plonk_torch/composer/ (the gadgets the benchmark's
                    circuits use, which fix which gates a circuit has;
                    permutation.py keeps the sigma cycles)
  keccak.py, merlin.py, transcript.py
                 <- dusk_plonk_torch/transcript/ (pure Python keccak)
  chacha.py      <- dusk_plonk_torch/rng/chacha.py (pure Python blocks)
  widgets.py     <- dusk_plonk_torch/proving/widgets.py (gate formulas)
"""
