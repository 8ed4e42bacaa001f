#!/usr/bin/env python3
"""The host's share of a proof before round 1, step by step, on the
machine that drives the card.

    python3 tools/synth_split.py [--k 20 16] [--reps 5]

For bench.py's 2^k circuit (chip_smoke.py::bench_circuit), the steps of
TorchEngine._synthesize_fast and create_proof up to the `wire_pack` mark,
each timed alone on the host clock, `reps` times (median and all):
  composer   circuit.synthesize(FastPlonk), the witness-only composer;
  to_bytes   the witness list serialised, 32 little-endian bytes a value;
  staging    those bytes into a pinned (nw + 1, 8) int32 buffer and one
             non-blocking copy to the card, ended by a synchronise;
  gather     K15 (kernels.wire_gather) on the card table through a plan of
             the circuit's own wire columns, ended by a synchronise.
Prints one JSON line a size with the card's name and power limit.  Fails
without a CUDA card."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, reps):
    """(median s, all s, last result) of fn() over `reps` calls."""
    out, secs = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), secs, out


def split(k, reps):
    import numpy as np
    import torch
    from chip_smoke import bench_circuit
    from dusk_plonk_torch.composer.composer import FastPlonk, Plonk
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.ops.limb import fr_field
    from dusk_plonk_torch.proving.engine import TorchEngine

    circuit = bench_circuit(k)(3)
    dev = torch.device("cuda")

    def composer():
        cs = FastPlonk.initialize()
        circuit.synthesize(cs)
        return cs

    res = {"k": k}
    res["composer_s"], res["composer_runs"], cs = timed(composer, reps)
    nw = len(cs.witness)
    res["to_bytes_s"], res["to_bytes_runs"], buf = timed(
        lambda: b"".join(v.to_bytes(32, "little") for v in cs.witness), reps)
    host = torch.zeros((nw + 1, 8), dtype=torch.int32, pin_memory=True)
    table = torch.empty((nw + 1, 8), dtype=torch.int32, device=dev)

    def staging():
        host.numpy()[:nw] = np.frombuffer(buf, "<i4").reshape(nw, 8)
        table.copy_(host, non_blocking=True)
        torch.cuda.synchronize()

    res["staging_s"], res["staging_runs"], _ = timed(staging, reps)
    full = Plonk.initialize()
    circuit.synthesize(full)
    cols, _, _ = TorchEngine.build_wire_plan(full, 1 << k)
    cols = torch.from_numpy(cols.astype(np.int32)).to(dev)
    F = fr_field()

    def gather():
        kernels.wire_gather(F, table, cols)
        torch.cuda.synchronize()

    gather()                                     # the kernels' build
    res["gather_s"], res["gather_runs"], _ = timed(gather, reps)
    res["witnesses"] = nw
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[20, 16])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("synth_split: no CUDA card")
    sys.path.insert(0, REPO)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    for k in args.k:
        print(json.dumps({"gpu": gpu, **split(k, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
