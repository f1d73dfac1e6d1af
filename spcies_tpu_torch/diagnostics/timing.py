"""Host-side phase timing, the analogue of the reference's MEASURE_TIME
instrumentation (snippets/read_time.c, get_elapsed_time.c; semantics in
docs/timing.md): update / solve / polish / run phase timers in ms.

PyTorch returns before a CUDA device finishes its work, so on a CUDA
device every mark first synchronises the device; each phase then holds the
device work it enqueued.
"""

from __future__ import annotations

import time

import torch


class PhaseTimer:
    """Collects named phase durations in ms (update/solve/polish/run)."""

    def __init__(self, device: torch.device | None = None):
        self._cuda = device is not None and device.type == "cuda"
        self._device = device
        self.times_ms: dict[str, float] = {}
        self._start = time.perf_counter()
        self._last = self._start

    def _now(self):
        if self._cuda:
            torch.cuda.synchronize(self._device)
        return time.perf_counter()

    def mark(self, phase: str):
        now = self._now()
        self.times_ms[phase] = (now - self._last) * 1e3
        self._last = now

    def finish(self):
        self.times_ms["run"] = (self._now() - self._start) * 1e3
        return self.times_ms
