"""synth_ms: host witness synthesis and wire packing a proof, the engine's
own synchronised round times `last_timings["synthesize"]` and
`["wire_pack"]`, the mean over the window's proofs."""

LAYER = "engine rounds (proving/engine.py)"
UNIT = "ms"
MOVES = "proof_s"
ROUNDS = ("synthesize", "wire_pack")


def read(run):
    per = [sum(t[r] for r in ROUNDS) for t in run.engine_timings
           if all(r in t for r in ROUNDS)]
    if not per:
        return None
    return 1e3 * sum(per) / len(per)
