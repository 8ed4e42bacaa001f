"""device_ops: the device activities (kernels, copies, fills) a proof, in
the profiler's trace of the traced proofs."""

LAYER = "engine rounds (proving/engine.py)"
UNIT = "ops/proof"
MOVES = "proof_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.activities:
        return None
    return len(tr.activities) / tr.proofs
