"""ntt_roofline: the NTT's share of its roofline, over every call of
ops/ntt.py::NttPlan.dft / idft / coset_dft / coset_idft in the traced
proofs."""

import math

from plonkbench import work
from plonkbench.metrics._roofline import share

LAYER = "NTT (ops/ntt.py)"
UNIT = "%"
MOVES = "proof_s"


def _work(name, args, kwargs):
    x = args[1]
    n = x.shape[-1]
    return work.ntt(name, math.prod(x.shape[:-2]), n)


ENTRIES = [("dusk_plonk_torch.ops.ntt", f"NttPlan.{kind}", "ntt", _work)
           for kind in ("dft", "idft", "coset_dft", "coset_idft")]


def read(run):
    return share(run, "ntt")
