"""msm_roofline: the MSM's share of its roofline, over every call of
ops/msm.py::MsmPlan.msm_affine_batch in the traced proofs (each commit
batch of the rounds and the openings)."""

from plonkbench import work
from plonkbench.metrics._roofline import share

LAYER = "MSM (ops/msm.py)"
UNIT = "%"
MOVES = "proof_s"


def _work(name, args, kwargs):
    stack = args[2] if len(args) > 2 else kwargs["limbs_stack"]
    return work.msm(stack.shape[0], stack.shape[-1])


ENTRIES = [("dusk_plonk_torch.ops.msm", "MsmPlan.msm_affine_batch", "msm",
            _work)]


def read(run):
    return share(run, "msm")
