"""Phase timing, the analogue of the reference's MEASURE_TIME
instrumentation (snippets/read_time.c, get_elapsed_time.c; semantics in
docs_torch/timing.md): update / solve / polish / run phase timers in ms.

On a CUDA device each stamp is a CUDA event recorded on the device's
current stream, where the solver's kernels and operations run: a phase is
the stream's time between two stamps, and nothing synchronises until
finish(), which waits once, on the last stamp. On the CPU the stamps are
the host clock.
"""

from __future__ import annotations

import time

import torch


class PhaseTimer:
    """Collects named phase durations in ms (update/solve/polish/run).

    mark(phase) closes the phase that began at the previous stamp (or at
    construction); finish() adds run, construction to the last stamp on a
    CUDA device and to the call on the CPU, and returns the dict."""

    def __init__(self, device: torch.device | None = None):
        self._cuda = device is not None and device.type == "cuda"
        self.times_ms: dict[str, float] = {}
        if self._cuda:
            self._stream = torch.cuda.current_stream(device)
            self._stamps = [(None, self._event())]
        else:
            self._start = time.perf_counter()
            self._last = self._start

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def mark(self, phase: str):
        if self._cuda:
            self._stamps.append((phase, self._event()))
            return
        now = time.perf_counter()
        self.times_ms[phase] = (now - self._last) * 1e3
        self._last = now

    def finish(self):
        if not self._cuda:
            self.times_ms["run"] = (time.perf_counter() - self._start) * 1e3
            return self.times_ms
        first, last = self._stamps[0][1], self._stamps[-1][1]
        # the one wait: every earlier stamp, and the work between them, is
        # done once the last one is
        last.synchronize()
        for (_, a), (phase, b) in zip(self._stamps, self._stamps[1:]):
            self.times_ms[phase] = a.elapsed_time(b)
        self.times_ms["run"] = first.elapsed_time(last)
        return self.times_ms
