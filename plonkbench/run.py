#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the CUDA card and print its result.

    python3 plonkbench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

Set-up (the import, PlonkParams.setup_device, PlonkKey.compile_device and
the mix's warm proofs) is timed from this process's start; then proofs run
for --seconds; with --trace 1 a few more proofs run under torch.profiler;
then the reference checks the SRS, the key and a sample of the window's
proofs.  The last line of standard output is one JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error.  Exits non-zero, with no result, without a CUDA card, or when a JAX
module has been imported.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dusk_plonk_tpu")


def forbidden_modules() -> list:
    """Modules whose top-level name is a JAX one."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from plonkbench import spec
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    # kernel caches inside the checkout, at fixed paths (the port builds
    # its own under build/torch_kernels and build/native)
    cache = os.path.join(ROOT, "build", "plonkbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"plonkbench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from plonkbench import harness
    result, checks = harness.run(ROOT, bench, cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"plonkbench: JAX modules were imported: {found}",
              file=sys.stderr)
        return 3
    for name, value in checks.items():
        print(f"check {name} {value} limit 0", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
