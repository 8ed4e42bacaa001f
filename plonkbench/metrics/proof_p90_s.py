"""proof_p90_s: the 90th percentile of the window's proof times, by the
host clock around each Prover.create_proof call (each ends with the proof's
points and scalars on the host)."""

from plonkbench import stats

LAYER = "prover API (proving/prover.py)"
UNIT = "s"
MOVES = "proof_s"


def read(run):
    if not run.proof_seconds:
        return None
    return stats.percentile(run.proof_seconds, 90)
