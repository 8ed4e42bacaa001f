"""idle_share: the share of the traced proofs' wall time in which no device
activity runs (100 - the union of the device intervals over the window)."""

LAYER = "the card"
UNIT = "%"
MOVES = "proof_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.activities or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
