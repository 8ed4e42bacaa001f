#!/usr/bin/env python3
"""One torch.profiler trace of a warm proof of the torch port on one NVIDIA
GPU, read by round.

    python3 tools/profile_proof.py [--root DIR] [--k 16] [--out FILE]

`--root` is the checkout whose dusk_plonk_torch is imported (default: the
one this script sits in), so that one command can profile two trees, e.g.
a parent commit unpacked with `git archive` into a gitignored directory.
The script builds bench.py's 2^k circuit key with PlonkParams.setup_device
and PlonkKey.compile_device, proves once unprofiled (warm) and once more
unprofiled (timed), then proves once under torch.profiler (CPU and CUDA
activities).  The rounds are the spans between the engine's Marks (each
mark synchronises the device first); a zero-length profiler annotation at
each mark places them on the trace's clock.  Per round, and for the whole
proof:
  wall_ms     the span's length;
  kernel_ms   device time of the repository's hand-written kernels (every
              __global__ function of <root>/dusk_plonk_torch/csrc);
  plain_ms    device time of every other device activity: PyTorch's own
              kernels, copies and fills (the plain-torch steps);
  busy_ms     the union of the device intervals;
  idle_ms     wall - busy: the card waits on the host;
  idle_share  idle / wall;
  launches    device activities in the span;
and the round's five largest device activities by name.  Prints one JSON
line (with the card's name and power limit) and writes it to --out; the
chrome trace goes to build/profile/ (gitignored) and is deleted unless
--keep-trace.  Fails when the trace holds no device activity."""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_names(root):
    """The __global__ function names of root's csrc sources."""
    names = set()
    for path in glob.glob(os.path.join(root, "dusk_plonk_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            src = f.read()
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)", src))
    return sorted(names)


def union_ms(spans):
    """Length of the union of (start, end) intervals, ms (spans in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def read_trace(path, names):
    """(marks [(label, ts)], device events [(name, start, end, hand)])."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    marks, dev = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        if name.startswith("mark:") and cat != "gpu_user_annotation":
            marks.append((name[5:], float(ev["ts"])))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            start = float(ev["ts"])
            dev.append((name, start, start + float(ev.get("dur", 0.0)),
                        any(k in name for k in names)))
    marks.sort(key=lambda m: m[1])
    return marks, dev


def summarise(t0, t1, dev):
    """One span's figures from the device events that start in it."""
    inside = [(n, max(s, t0), min(e, t1), h) for n, s, e, h in dev
              if t0 <= s < t1]
    wall = (t1 - t0) / 1e3
    busy = union_ms([(s, e) for _, s, e, _ in inside])
    by_name = collections.Counter()
    for n, s, e, _ in inside:
        by_name[n[:80]] += (e - s) / 1e3
    return {"wall_ms": wall,
            "kernel_ms": sum(e - s for _, s, e, h in inside if h) / 1e3,
            "plain_ms": sum(e - s for _, s, e, h in inside if not h) / 1e3,
            "busy_ms": busy, "idle_ms": wall - busy,
            "idle_share": (wall - busy) / wall if wall else None,
            "launches": len(inside),
            "top": by_name.most_common(5)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "profile_proof.json"))
    ap.add_argument("--keep-trace", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_proof: torch.cuda.is_available() is false")
    sys.path.insert(0, root)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import dusk_plonk_torch
    if not os.path.abspath(dusk_plonk_torch.__file__).startswith(root):
        raise SystemExit(f"profile_proof: imported {dusk_plonk_torch.__file__}"
                         f", not the package under {root}")
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkKey, PlonkParams
    from dusk_plonk_torch.proving import engine as engine_mod
    from torch.profiler import ProfilerActivity, profile, record_function

    Bench = smoke.bench_circuit(args.k)
    rng = ChaCha12Rng.seed_from_u64(8349)
    pp = PlonkParams.setup_device(args.k, rng)
    prover, verifier = PlonkKey.compile_device(pp, Bench)
    proof, pis = prover.create_proof(rng, Bench(3))              # warm
    verifier.verify(proof, pis)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prover.create_proof(rng, Bench(3))
    torch.cuda.synchronize()
    unprofiled_s = time.perf_counter() - t0

    base = engine_mod.Marks

    class MarkedMarks(base):
        """The engine's Marks with a profiler annotation at each mark."""

        def __init__(self, device):
            super().__init__(device)
            with record_function("mark:start"):
                pass

        def __call__(self, label):
            super().__call__(label)
            with record_function(f"mark:{label}"):
                pass

    engine_mod.Marks = MarkedMarks
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            proof, pis = prover.create_proof(rng, Bench(3))
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
    finally:
        engine_mod.Marks = base
    verifier.verify(proof, pis)

    trace_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(trace_dir, exist_ok=True)
    trace = os.path.join(trace_dir, f"proof_k{args.k}_{os.getpid()}.json")
    prof.export_chrome_trace(trace)
    names = kernel_names(root)
    marks, dev = read_trace(trace, names)
    if not args.keep_trace:
        os.remove(trace)
    if not dev:
        raise SystemExit("profile_proof: the trace holds no device activity")
    if not marks or marks[0][0] != "start":
        raise SystemExit(f"profile_proof: marks not found: {marks[:3]}")
    rounds = {label: summarise(prev, ts, dev)
              for (_, prev), (label, ts) in zip(marks, marks[1:])}
    whole = summarise(marks[0][1], marks[-1][1], dev)
    out = {"root": os.path.relpath(root, REPO), "k": args.k,
           "gpu": smoke.nvidia_smi_line(),
           "device": torch.cuda.get_device_name(0),
           "unprofiled_proof_s": unprofiled_s, "profiled_proof_s": profiled_s,
           "hand_written_kernels": names, "proof": whole, "rounds": rounds}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
