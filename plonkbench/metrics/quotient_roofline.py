"""quotient_roofline: the quotient grid's share of its roofline, over every
call of ops/kernels.py::quotient (kernel K14) in the traced proofs."""

from plonkbench import work
from plonkbench.metrics._roofline import share

LAYER = "quotient (ops/kernels.py, K14)"
UNIT = "%"
MOVES = "proof_s"


def _work(name, args, kwargs):
    evs, sel8, sig8 = args[1], args[3], args[4]
    planes_in = evs.shape[0] + sel8.shape[0] + sig8.shape[0] + 3
    return work.quotient(evs.shape[-1], planes_in)


ENTRIES = [("dusk_plonk_torch.ops.kernels", "quotient", "quotient", _work)]


def read(run):
    return share(run, "quotient")
