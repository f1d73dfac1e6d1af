"""The device trace of a window: torch.profiler's CUDA activity (kernels,
copies and fills on the card), reduced to busy time, time by operation
and the device's idle gaps, each gap named by what the caller was doing
on the host at its middle.

The profiler records device activity only: it adds no callback to the
host's operations, so the caller's own spans (harness/drivers.py) name
the gaps. Its timestamps are nanoseconds since the epoch, as
time.time_ns() reads them.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ns: int                      # sum of every operation's time
    by_name: dict = field(default_factory=dict)    # name -> [ns, count]
    idle_by_host: dict = field(default_factory=dict)  # label -> ns
    kernel_ns: int = 0                  # the cell's kernel's time

    def matching(self, part: str):
        """(ns, launches) of the operations whose name holds `part`."""
        ns = sum(v[0] for k, v in self.by_name.items() if part in k)
        n = sum(v[1] for k, v in self.by_name.items() if part in k)
        return ns, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[name[:160], ns / 1e9] for name, (ns, _)
                                in ops],
                    idle_gaps=[[label, ns / 1e9] for label, ns in gaps])


class DeviceTrace:
    """A profiler run around a window: start(), then stop(spans)
    after the window, with the caller's spans in perf_counter ns."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        self._prof.__enter__()
        # the offset from perf_counter to the profiler's clock
        self.offset = time.time_ns() - time.perf_counter_ns()

    def stop(self, start: int, end: int, spans) -> Summary:
        """End the profiler run and reduce it over the window [start, end]
        (perf_counter ns)."""
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        ops = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        return reduce_ops(ops, start + self.offset, end + self.offset,
                          [(label, a + self.offset, b + self.offset)
                           for label, a, b in spans])


def reduce_ops(ops, w0: int, w1: int, spans) -> Summary:
    """Reduce device operations [(name, start_ns, duration_ns)] over the
    window [w0, w1] (ns on the profiler's clock); `spans` [(label, a, b)]
    are the host's, sorted by start."""
    by_name: dict = {}
    device_ns = 0
    intervals = []
    for name, s, d in ops:
        rec = by_name.setdefault(name, [0, 0])
        rec[0] += d
        rec[1] += 1
        device_ns += d
        intervals.append((s, s + d))
    intervals.sort()
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(max(0, min(b, w1) - max(a, w0)) for a, b in merged)
    # the idle gaps inside the window, named by the host span at their
    # middle
    starts = [a for _, a, _ in spans]
    idle: dict = {}
    prev = w0
    for a, b in merged + [[w1, w1]]:
        a, b = max(a, w0), min(b, w1)
        if a > prev:
            mid = (prev + a) // 2
            j = bisect.bisect_right(starts, mid) - 1
            label = (spans[j][0] if j >= 0 and spans[j][2] >= mid
                     else "caller between requests")
            idle[label] = idle.get(label, 0) + (a - prev)
        prev = max(prev, b)
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                   device_ns=device_ns, by_name=by_name, idle_by_host=idle)
