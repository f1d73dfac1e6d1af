"""Host spans and kernel launch records of the solve path, taken only while
a torch profiler session is open (semantics in docs_torch/timing.md).

Recording is on exactly while `torch.autograd.profiler._is_profiler_enabled`
is set, which torch sets on every profiler start and clears on every stop,
whatever the activities: a program under `torch.profiler.profile` records,
every other call records nothing. There is no other switch (a graph's
capture, below, collects its launch records apart). Off, a site costs one
read of that flag: `begin()` returns 0 without reading a clock,
`end(name, 0)` does nothing, and a kernel wrapper asks `recording()`
before it forms a launch record.

A span is (name, t0_ns, t1_ns) on `time.perf_counter_ns()`, the clock of a
caller's own spans. Its sites, one each:

    adapter.prepare  FusedBoxADMMSolve.prepare, FusedSplitSolve.prepare
                     (solvers/fused_backend.py): the enqueueing of the
                     kernel's inputs
    kernel.launch    fused_admm_solve, fused_split_solve: the checks, the
                     output allocations, the kernel's load and launch (the
                     plain version on the CPU)
    rollout.step     one step of runtime.closed_loop_rollout's loop
    rollout.carry    its warm-start carry (the stagewise shift)
    rollout.replay   one episode replayed as a CUDA graph
                     (runtime.rollout.EpisodeGraph): the copies of its
                     inputs, the replay, the clones of its outputs

rollout.step and rollout.carry (and the prepare and launch inside a step)
fire on the loop alone: an episode that runs as a graph records them
only while the graph is captured, and its replays record rollout.replay.

A launch record is (kernel, t_ns, lanes a block, refill, counts): counts is
the launch's own [2, blocks] int32 tensor of each block's iterations and
lane-iterations (the kernel writes them), kept by reference; nothing is
copied or synchronised at launch time, so a reader moves the counts to the
host once the work is done. Inside `capture()` (a CUDA graph's capture,
whose launches run only when the graph is replayed) the launch records go
to the list it yields, whatever the profiler; a replay records them again,
each with a copy of its counts.

Nothing here is a profiler event: the records stay in two bounded buffers
of this module (the oldest dropped past MAX_RECORDS) until `clear()`.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

from torch.autograd import profiler as _profiler

# records kept in each buffer; the oldest go first
MAX_RECORDS = 2 ** 20

_spans: deque = deque(maxlen=MAX_RECORDS)
_launches: deque = deque(maxlen=MAX_RECORDS)
# the launch records of the capture under way, or None
_captured: list | None = None


def recording() -> bool:
    """Whether launch records are taken: a torch profiler session is open,
    or a capture() collects them."""
    return _profiler._is_profiler_enabled or _captured is not None


def begin() -> int:
    """A span's start: perf_counter_ns() while recording, else 0."""
    return time.perf_counter_ns() if _profiler._is_profiler_enabled else 0


def end(name: str, t0: int) -> None:
    """Close the span `name` begun at t0 (nothing when t0 is 0)."""
    if t0:
        _spans.append((name, t0, time.perf_counter_ns()))


def record_launch(kernel: str, lanes: int, refill: bool, counts) -> None:
    """Keep a launch's record, its [2, blocks] counts tensor by reference.
    A wrapper calls it only while `recording()`, so that off it forms no
    view of its counts."""
    rec = (kernel, time.perf_counter_ns(), int(lanes), bool(refill), counts)
    (_launches if _captured is None else _captured).append(rec)


@contextlib.contextmanager
def capture():
    """Collect the launch records made inside into the list this yields,
    whether or not a profiler session is open, and none into the buffer:
    the launches of a CUDA graph's capture, which run only at its
    replays."""
    global _captured
    outer, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = outer


def spans(since_ns: int, until_ns: int) -> list:
    """The spans that lie within [since_ns, until_ns], oldest first."""
    return [s for s in _spans if s[1] >= since_ns and s[2] <= until_ns]


def launches(since_ns: int, until_ns: int) -> list:
    """The launch records taken within [since_ns, until_ns], oldest
    first."""
    return [r for r in _launches if since_ns <= r[1] <= until_ns]


def clear() -> None:
    """Drop every span and launch record."""
    _spans.clear()
    _launches.clear()
