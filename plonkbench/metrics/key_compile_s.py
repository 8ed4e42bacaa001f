"""key_compile_s: PlonkKey.compile_device (proving/keys.py::
compile_circuit_device), by the host clock around the call, ending in a
synchronise."""

LAYER = "key compilation (proving/keys.py)"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.setup.get("key_compile_s")
