"""srs_setup_s: PlonkParams.setup_device(k, rng), by the host clock around
the call, ending in a synchronise."""

LAYER = "SRS set-up (kzg/srs.py)"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.setup.get("srs_setup_s")
