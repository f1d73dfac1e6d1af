"""The callers: one closed loop, one request at a time, each sent once the
previous one's results are on the host.

Every request records its own host-clock span (perf_counter
nanoseconds), the spans of what the caller did inside it (the trace
names the device's idle gaps by them), its results as NumPy arrays and
the pool batch it served.
"""

from __future__ import annotations

import time

import numpy as np


def _field(res, key: str):
    return getattr(res, key) if hasattr(res, key) else res.sol[key]


class Requests:
    """One `BatchedSolver.__call__` a request, on a pool batch; the
    traffic's readback fields are copied to the host."""

    kind = "requests"

    def __init__(self, solver, traffic: dict, pool: list):
        self.solver, self.pool = solver, pool
        self.readback = tuple(traffic["readback"])

    def request(self, i: int) -> dict:
        p = i % len(self.pool)
        t0 = time.perf_counter_ns()
        res = self.solver(*self.pool[p])
        t1 = time.perf_counter_ns()
        out = {key: _field(res, key).cpu().numpy() for key in self.readback}
        t2 = time.perf_counter_ns()
        return dict(pool=p, start=t0, end=t2, out=out,
                    times_ms=res.sol.get("times_ms"),
                    spans=(("solver call: api update, adapter, launch and "
                            "the wait at its end", t0, t1),
                           ("readback to the host", t1, t2)))


class Rollout:
    """One `closed_loop_rollout` episode a request, from a pool batch's
    initial states and set points; the traffic's readback fields are
    copied to the host after the episode."""

    kind = "rollout"

    def __init__(self, solver, traffic: dict, pool: list, A, B):
        from spcies_tpu_torch.runtime import closed_loop_rollout
        self.rollout = closed_loop_rollout
        self.solver, self.pool, self.A, self.B = solver, pool, A, B
        self.steps = int(traffic["steps"])
        self.warm_start = traffic["warm_start"]
        self.readback = tuple(traffic["readback"])

    def request(self, i: int) -> dict:
        p = i % len(self.pool)
        x0, xr, ur = self.pool[p]
        t0 = time.perf_counter_ns()
        out = self.rollout(self.solver, self.A, self.B, x0, xr, ur,
                           n_steps=self.steps, warm_start=self.warm_start)
        t1 = time.perf_counter_ns()
        host = {key: out[key].cpu().numpy() for key in self.readback}
        t2 = time.perf_counter_ns()
        return dict(pool=p, start=t0, end=t2, out=host, times_ms=None,
                    host_ms=(t1 - t0) / 1e6,
                    spans=(("rollout host loop: shift, solve, plant update",
                            t0, t1),
                           ("readback to the host, waiting on the device",
                            t1, t2)))


def make(solver, traffic: dict, pool: list, A, B):
    if traffic["driver"] == "requests":
        return Requests(solver, traffic, pool)
    if traffic["driver"] == "rollout":
        return Rollout(solver, traffic, pool, A, B)
    raise ValueError(f"unknown driver {traffic['driver']!r}")


def window(driver, seconds: float, first: int = 0):
    """Requests back to back, the first numbered `first`, until `seconds`
    have passed; the request running at the deadline finishes. Returns
    (records, start, end) in perf_counter nanoseconds."""
    records = []
    start = time.perf_counter_ns()
    deadline = start + int(seconds * 1e9)
    i = first
    while True:
        records.append(driver.request(i))
        i += 1
        if time.perf_counter_ns() >= deadline:
            break
    return records, start, records[-1]["end"]


def latencies_ms(records) -> np.ndarray:
    return np.array([(r["end"] - r["start"]) / 1e6 for r in records])
