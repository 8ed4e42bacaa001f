"""Wall-time and peak-memory marks for the one-time and per-proof phases."""

from __future__ import annotations

import time

import torch


class Marks:
    """`marks("label")` records the wall time since the previous mark,
    after the device has finished its queued work, into `marks.times`; on
    a CUDA device also the peak bytes allocated since the previous mark
    into `marks.peaks`.  The peak is torch's one counter, so Marks resets
    it when it is made and at every mark."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: dict[str, float] = {}
        self.peaks: dict[str, int] = {}
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t = time.perf_counter()

    def __call__(self, label: str) -> None:
        if self._cuda:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[label] = now - self._t
        if self._cuda:
            self.peaks[label] = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t = now
