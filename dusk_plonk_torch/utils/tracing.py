"""Tracing and counters (counterpart of dusk_plonk_tpu/utils/tracing.py,
with the same names and report format): wall-clock spans and monotonic
counters, cheap enough to stay always on.

What writes to the global `tracer`:
  * spans `prove.<label>`: each round of TorchEngine.create_proof (the
    seconds of its `Marks`);
  * `msm_dispatch`, `msm_points`: each MSM dispatch (ops/msm.py,
    parallel/msm.py);
  * `collective_ops`, `collective_bytes`: each collective of the
    distributed NTT, the sharded scans and the sharded MSMs
    (parallel/), counted as the JAX package counts them, the quantity of
    parallel/model.py;
  * `gather_bytes`, `relayout_bytes`, `halo_bytes`: the bytes that
    cross shards outside that model (parallel/mesh.py): the gathers of
    the steps the sharded engine runs whole on the lead device, the
    re-layouts between element widths, the quotient's boundary halo.

Usage:
    from dusk_plonk_torch.utils.tracing import tracer
    with tracer.span("round1"):
        ...
    tracer.count("msm_commits", 1)
    print(tracer.report())
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Tracer:
    def __init__(self):
        self.spans: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.enabled = True

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def count(self, name: str, inc: int = 1):
        if self.enabled:
            self.counters[name] += inc

    def add_span(self, name: str, seconds: float):
        """Record an externally-timed span (the engine's per-round marks,
        so its timing dict and the tracer stay in sync)."""
        if self.enabled:
            self.spans[name] += seconds
            self.calls[name] += 1

    def reset(self):
        self.spans.clear()
        self.calls.clear()
        self.counters.clear()

    def report(self) -> dict:
        """{"spans": {name: {"seconds", "calls"}}, "counters": {...}}"""
        return {
            "spans": {k: {"seconds": round(v, 4), "calls": self.calls[k]}
                      for k, v in sorted(self.spans.items())},
            "counters": dict(sorted(self.counters.items())),
        }


tracer = Tracer()
