"""Wall-time marks for the one-time and per-proof phases."""

from __future__ import annotations

import time

import torch


class Marks:
    """`marks("label")` records the wall time since the previous mark,
    after the device has finished its queued work, into `marks.times`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[label] = now - self._t
        self._t = now
