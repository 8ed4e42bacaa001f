"""One run of one cell: set-up, the measured window, the traced stretch,
the reference's check and the result line's fields.

The program is driven through its public entries only:
PlonkParams.setup_device(k, rng), PlonkKey.compile_device(pp, circuit_cls)
and Prover.create_proof(rng, circuit) on the prover that compile_device
returned.  `run` takes the device as an argument so that the tests can
drive it on the CPU; run.py refuses to run without a CUDA card.
"""

from __future__ import annotations

import gc
import os
import random
import resource
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass

from . import spec, stats, trace as tracing, traffic
from .reference import check
from .reference.constants import R_MOD

GIB = 1 << 30


@dataclass
class Record:
    request: traffic.Request
    start: float
    end: float
    proof: object = None
    public_inputs: list = None
    error: str | None = None
    timings: dict | None = None


@dataclass
class RunView:
    """What a per-layer metric's reader reads."""
    cell: dict
    config: dict
    proof_seconds: list        # host clock around each proof of the window
    engine_timings: list       # the engine's round times of each of them
    setup: dict                # srs_setup_s, key_compile_s, warm_s
    trace: tracing.TraceView | None


def _query_gpu(fields: str) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    return _query_gpu("name,power.limit")


def cpu_model() -> str | None:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def _cpu_now() -> int | None:
    """The CPU this process last ran on (/proc/self/stat, field 39)."""
    try:
        with open("/proc/self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return None


def cpu_probe_ms(reps: int = 3) -> float:
    """Best of `reps` timings of a fixed pure-Python loop of 255-bit
    modular multiplies, in ms: the host's single-thread speed as this
    process sees it, beside the proofs' host work."""
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        x = 3
        for _ in range(50_000):
            x = x * x % R_MOD
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def host_state() -> dict:
    """This process's CPU time, context switches and CPU, and the host's
    load."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime,
            "ctx_invol": ru.ru_nivcsw, "ctx_vol": ru.ru_nvcsw,
            "cpu": _cpu_now(), "load1": os.getloadavg()[0]}


class GcClock:
    """Seconds the garbage collector ran, and full collections, while
    on."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.full += info.get("generation") == 2
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _window(prover, circuit_cls, stream, seconds, prove_rng, note_peaks,
            log):
    """Proofs for `seconds` in a closed loop: each request is sent when
    the last proof returns."""
    engine = prover.engine
    recs = []
    start = time.perf_counter()
    end = start + seconds
    i = 0
    while time.perf_counter() < end:
        req = stream.request(i)
        rec = Record(req, time.perf_counter(), 0.0)
        try:
            rec.proof, rec.public_inputs = prover.create_proof(
                prove_rng(req.blinder_seed), circuit_cls(**req.inputs))
            rec.timings = dict(engine.last_timings)
        except Exception as exc:  # a proof that raises counts as failed
            rec.error = f"{type(exc).__name__}: {exc}"
            if not any(r.error for r in recs):
                traceback.print_exc(file=log)
        rec.end = time.perf_counter()
        recs.append(rec)
        note_peaks(engine.last_peaks)
        i += 1
    return start, recs


def _five(values):
    """min, quartiles and max of the values (None when fewer than 2)."""
    xs = sorted(values)
    if len(xs) < 2:
        return None
    return [xs[0], *statistics.quantiles(xs, n=4), xs[-1]]


def _e2e(name: str, start: float, recs: list, setup_s: float,
         peak: int | None):
    done = [r for r in recs if r.error is None]
    if name == "setup_s":
        return setup_s
    if name == "peak_mem_gib":
        return None if peak is None else peak / GIB
    if not done:
        return None
    if name == "proof_s":
        return stats.seconds_per_item(start, [r.end for r in recs],
                                      len(done))
    raise KeyError(f"no end-to-end metric named {name!r}")


def run(root, bench, cell, seed, seconds, trace, device, t0,
        prove_rng=None, log=None):
    """-> (result fields, the numbers compared by the check)."""
    log = log or sys.stderr
    cfg = spec.config(root, bench, cell["config"])
    mix = spec.traffic(root, cell["traffic"])
    circuit_mod = spec.circuit(root, cfg)
    params = cfg["circuit"]["params"]
    circuit_cls = circuit_mod.build(params)
    stream = traffic.Stream(mix, circuit_mod.input_bounds(params), seed)
    e2e = [m for m in bench["end_to_end"] if spec.applies(m, cell["name"])]
    layer = [m for m in bench["per_layer"]
             if spec.applies(m, cell["name"])] if trace else []
    readers = {m["name"]: spec.metric(root, m["name"]) for m in layer}

    import torch
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkKey, PlonkParams
    from dusk_plonk_torch.utils.config import get_config

    prove_rng = prove_rng or ChaCha12Rng.seed_from_u64
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    peaks = []

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def note_peaks(step_peaks):
        """The program's per-step peaks, and the counter since the last
        mark (Marks resets it at every mark)."""
        peaks.extend(step_peaks.values())
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated(dev))

    srs_seed = traffic.derive(seed, "srs")
    t = time.perf_counter()
    pp = PlonkParams.setup_device(cfg["k"], ChaCha12Rng.seed_from_u64(
        srs_seed), device)
    sync()
    srs_setup_s = time.perf_counter() - t
    note_peaks(getattr(pp, "setup_peaks", {}))
    t = time.perf_counter()
    prover, verifier = PlonkKey.compile_device(pp, circuit_cls,
                                               device=device)
    sync()
    key_compile_s = time.perf_counter() - t
    engine = prover.engine
    note_peaks(engine.compile_peaks)
    t = time.perf_counter()
    warm_failed = 0
    for i in range(stream.warmup):
        req = stream.warm(i)
        try:
            prover.create_proof(prove_rng(req.blinder_seed),
                                circuit_cls(**req.inputs))
        except Exception:  # a proof that raises counts as failed
            warm_failed += 1
            traceback.print_exc(file=log)
        note_peaks(engine.last_peaks)
    gc.collect()
    sync()
    warm_s = time.perf_counter() - t
    # the host as the window meets it (read outside the window)
    probe_before = cpu_probe_ms()
    host_before = host_state()
    setup_s = time.perf_counter() - t0

    with GcClock() as gc_clock:
        start, recs = _window(prover, circuit_cls, stream, seconds,
                              prove_rng, note_peaks, log)
    window_end = time.perf_counter()
    host_after = host_state()
    probe_after = cpu_probe_ms()
    gpu_after = _query_gpu("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
                           "clocks_throttle_reasons.active") if cuda else None
    done = [r for r in recs if r.error is None]

    view = None
    if trace:
        probe = tracing.Probe()
        try:
            wrapped = set()
            for mod in readers.values():
                for entry in getattr(mod, "ENTRIES", ()):
                    if entry[:2] not in wrapped:
                        wrapped.add(entry[:2])
                        probe.wrap(*entry)
            probe.wrap(*tracing.PROOF_ENTRY, tracing.PROOF_LAYER)
            probe.mark_rounds()
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            sync()
            with profile(activities=acts) as prof:
                for j in range(cfg["trace_proofs"]):
                    req = stream.warm(stream.warmup + j)
                    prover.create_proof(prove_rng(req.blinder_seed),
                                        circuit_cls(**req.inputs))
                    note_peaks(engine.last_peaks)
                sync()
            events = tracing.export(prof)
        finally:
            probe.restore()
        view = tracing.read(events, probe)
        idle = sorted(lay for lay in probe.calls if not view.calls.get(lay))
        if idle:
            raise RuntimeError(f"traced layer entries saw no call in the "
                               f"traced proofs: {idle}")
    peak = max(peaks) if cuda else None

    # what the reference judges, then the program's state is freed
    rnd = random.Random(traffic.derive(seed, "sample"))
    n_pow = len(pp.powers)
    idx = {0, 1, n_pow - 1} | set(rnd.sample(range(n_pow), min(
        cfg["reference"]["srs_points"], n_pow)))
    srs = ({i: pp.powers[i] for i in sorted(idx)}, pp.h, pp.beta_h)
    vk, ok = verifier.verifier_key, verifier.opening_key
    vk_view = (dict(vk.commitments), vk.n, vk.n_inv, vk.generator,
               vk.generator_inv, (ok.g, ok.h, ok.beta_h))
    sample = sorted(rnd.sample(range(len(done)), min(
        cfg["reference"]["proofs"], len(done))))
    program_config = get_config()
    del pp, prover, verifier, engine
    for i, r in enumerate(done):
        if i not in sample:
            r.proof = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    key = check.CircuitKey(circuit_cls(), check.derive_tau(srs_seed), device)
    counts = dict.fromkeys(check.CHECKS, 0)
    counts["proofs_failed"] = warm_failed + len(recs) - len(done)
    counts["srs_mismatch"] = key.check_srs(*srs)
    counts["vk_mismatch"] = key.check_vk(*vk_view)
    for i in sample:
        r = done[i]
        comms = {f: getattr(r.proof, f) for f in check.COMMITMENTS}
        try:
            bad = key.check_proof(circuit_cls(**r.request.inputs),
                                  r.request.blinder_seed, comms,
                                  dict(r.proof.evaluations),
                                  r.public_inputs)
        except ValueError as exc:
            print(f"plonkbench: proof {r.request.index}: {exc}", file=log)
            bad = dict.fromkeys(check.CHECKS[3:], 1)
        for k, v in bad.items():
            counts[k] += v
    reference_s = time.perf_counter() - t
    correct = bool(sample) and all(v == 0 for v in counts.values())

    metrics = {}
    if trace:
        rv = RunView(cell, cfg, [r.end - r.start for r in done],
                     [r.timings for r in done],
                     {"srs_setup_s": srs_setup_s,
                      "key_compile_s": key_compile_s, "warm_s": warm_s},
                     view)
        for m in layer:
            value = readers[m["name"]].read(rv)
            if value is None:
                # a metric listed for this cell always has something to
                # read; only a run off the card has no device trace
                if cuda or m["source"] != "device_trace":
                    raise RuntimeError(f"per-layer metric {m['name']} read "
                                       f"nothing in {cell['name']}")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = _e2e(m["name"], start, recs, setup_s, peak)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if cuda:
        device_fields = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(dev),
                         "count": cell["chips"], "memory_peak_bytes": peak}
    else:
        device_fields = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": len(recs),
              "failed": len(recs) - len(done), "metrics": metrics,
              "device": device_fields}
    result["host"] = {
        "cpu_model": cpu_model(), "cpus": sorted(os.sched_getaffinity(0)),
        "probe_ms": [probe_before, probe_after],
        "cpu_on": [host_before["cpu"], host_after["cpu"]],
        "load1": [host_before["load1"], host_after["load1"]],
        "window_s": window_end - start,
        "window_cpu_s": host_after["cpu_s"] - host_before["cpu_s"],
        "window_sys_s": host_after["sys_s"] - host_before["sys_s"],
        "window_ctx_invol": host_after["ctx_invol"] - host_before[
            "ctx_invol"],
        "window_ctx_vol": host_after["ctx_vol"] - host_before["ctx_vol"],
        "gc_s": gc_clock.seconds, "gc_full": gc_clock.full,
        "round_ms_median": {
            k: 1e3 * statistics.median(r.timings[k] for r in done)
            for k in (done[0].timings if done else {})
            if all(k in r.timings for r in done)},
        "gpu_after_window": gpu_after}
    if view is not None:
        device_fields["busy_s"] = view.busy_s()
        device_fields["window_s"] = view.window_s
        result["breakdown"] = tracing.breakdown(view)
    print("plonkbench: " + repr({
        "cell": cell["name"], "seed": seed, "power": power_limit(),
        "program_config": program_config, "srs_setup_s": srs_setup_s,
        "key_compile_s": key_compile_s, "warm_s": warm_s,
        "setup_s": setup_s, "proofs": len(recs), "checked": len(sample),
        "proof_s_min_q1_q2_q3_max": _five(r.end - r.start for r in done),
        "reference_s": reference_s,
        "traced": None if view is None else {
            "proofs": view.proofs, "activities": len(view.activities),
            "unmatched": view.unmatched,
            "calls": {k: len(v) for k, v in view.calls.items()}}}),
        file=log)
    return result, counts
