"""The traced run's instruments and the reading of its trace.

`Probe` wraps layer entries of the program, from outside and only in the
traced run, in torch.profiler ranges named `pb:<layer>:<call>`, logs each
call's work (from the call's arguments, by the work functions of work.py),
and marks the engine's rounds: the engine's `Marks` is swapped for a
subclass that leaves a zero-length `pb.mark:<label>` range at each mark
(each mark synchronises the device first).

`read` takes the profiler's chrome trace (written under TMPDIR and deleted)
and attributes each device activity (kernel, copy, fill) to the ranges in
which its launch lies, by the launch's correlation id, so that a kernel
added or renamed inside a layer entry stays counted.
"""

from __future__ import annotations

import bisect
import collections
import functools
import importlib
import inspect
import json
import os
import tempfile
from dataclasses import dataclass, field

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE = "pb:"
MARK = "pb.mark:"
PROOF_LAYER = "proof"
PROOF_ENTRY = ("dusk_plonk_torch.proving.prover", "Prover.create_proof")
MARKS_HOME = "dusk_plonk_torch.proving.engine"


@dataclass
class Call:
    layer: str
    index: int
    work: tuple | None                 # (products, bytes) or None
    start: float = 0.0                 # seconds on the trace's clock
    end: float = 0.0
    device_s: float = 0.0              # activities launched inside
    activities: int = 0


@dataclass
class Activity:
    name: str
    start: float
    end: float
    launch: float | None


@dataclass
class TraceView:
    proofs: int
    window: tuple
    activities: list
    calls: dict = field(default_factory=dict)   # layer -> [Call]
    marks: list = field(default_factory=list)   # [(label, t)]
    unmatched: int = 0                  # activities with no launch found

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.union_seconds([(a.start, a.end)
                                    for a in self.activities])


class Probe:
    """Ranges around layer entries and the engine's round marks."""

    def __init__(self):
        from torch.profiler import record_function
        self._rf = record_function
        self.calls: dict[str, list[Call]] = collections.defaultdict(list)
        self._undo = []

    def wrap(self, module: str, qualname: str, layer: str, work=None):
        """Wrap module.qualname (a function or a method); `work(name,
        args, kwargs)` gives the call's (products, bytes).  Raises when the
        entry is gone."""
        owner = importlib.import_module(module)
        *path, name = qualname.split(".")
        for part in path:
            owner = getattr(owner, part)
        raw = inspect.getattr_static(owner, name)
        fn = getattr(owner, name)
        if isinstance(raw, (staticmethod, classmethod)):
            fn = raw.__func__
        calls, rf = self.calls[layer], self._rf

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            call = Call(layer, len(calls),
                        work(name, args, kwargs) if work else None)
            calls.append(call)
            with rf(f"{RANGE}{layer}:{call.index}"):
                return fn(*args, **kwargs)

        new = type(raw)(wrapper) if isinstance(
            raw, (staticmethod, classmethod)) else wrapper
        setattr(owner, name, new)
        self._undo.append(lambda: setattr(owner, name, raw))

    def mark_rounds(self):
        mod = importlib.import_module(MARKS_HOME)
        base, rf = mod.Marks, self._rf

        class MarkedMarks(base):
            def __init__(self, device):
                super().__init__(device)
                with rf(MARK + "start"):
                    pass

            def __call__(self, label):
                super().__call__(label)
                with rf(MARK + label):
                    pass

        mod.Marks = MarkedMarks
        self._undo.append(lambda: setattr(mod, "Marks", base))

    def restore(self):
        while self._undo:
            self._undo.pop()()


def export(prof) -> list:
    """The profiler's events, through a chrome trace under TMPDIR."""
    fd, path = tempfile.mkstemp(prefix="plonkbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def read(events: list, probe: Probe) -> TraceView:
    """Attribute the device activities of the traced proofs to the
    probe's calls; the window runs from the first traced proof's start to
    the last one's end."""
    ranges, marks, launches, dev = [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        ts = float(ev.get("ts", 0.0)) * 1e-6
        dur = float(ev.get("dur", 0.0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((name, ts, ts + dur, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat == "gpu_user_annotation":
            continue
        elif name.startswith(MARK):
            marks.append((name[len(MARK):], ts))
        elif name.startswith(RANGE):
            layer, idx = name[len(RANGE):].rsplit(":", 1)
            ranges.append((layer, int(idx), ts, ts + dur))
    proofs = sorted((s, e) for layer, _, s, e in ranges
                    if layer == PROOF_LAYER)
    if not proofs:
        raise RuntimeError("the trace holds no traced proof")
    window = (proofs[0][0], proofs[-1][1])
    acts, unmatched = [], 0
    for name, s, e, corr in dev:
        if e <= window[0] or s >= window[1]:
            continue
        launch = launches.get(corr)
        unmatched += launch is None
        acts.append(Activity(name, max(s, window[0]), min(e, window[1]),
                             launch))
    by_launch = sorted((a.launch, i) for i, a in enumerate(acts)
                       if a.launch is not None)
    keys = [t for t, _ in by_launch]
    for layer, idx, s, e in ranges:
        call = probe.calls[layer][idx]
        call.start, call.end = s, e
        lo, hi = bisect.bisect_left(keys, s), bisect.bisect_right(keys, e)
        for _, i in by_launch[lo:hi]:
            call.device_s += acts[i].end - acts[i].start
            call.activities += 1
    calls = {layer: [c for c in cs if c.end > 0]
             for layer, cs in probe.calls.items()}
    return TraceView(len(proofs), window, acts, calls, sorted(
        marks, key=lambda m: m[1]), unmatched)


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations with the most time, and the idle gaps' time
    by what the host was doing: the engine round that holds the gap, and
    the innermost traced layer entry around it."""
    by_op = collections.Counter()
    for a in view.activities:
        by_op[a.name[:120]] += a.end - a.start
    spans = [(a.start, a.end) for a in view.activities]
    mark_ts = [t for _, t in view.marks]
    layers = [c for layer, cs in view.calls.items()
              if layer != PROOF_LAYER for c in cs]
    by_gap = collections.Counter()
    for s, e in stats.gaps(spans, *view.window):
        mid = (s + e) / 2
        i = bisect.bisect_right(mark_ts, mid)
        label = view.marks[i][0] if i < len(view.marks) else "after"
        if label == "start":
            label = "between proofs"
        inner = [c for c in layers if c.start <= mid <= c.end]
        if inner:
            label += "/" + min(inner, key=lambda c: c.end - c.start).layer
        by_gap[label] += e - s
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_gap.most_common(top)]}
