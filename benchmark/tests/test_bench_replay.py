"""The readers of the program's span `rollout.replay` (an episode of the
closed-loop rollout replayed as a CUDA graph): rollout_graph_share.fleet
and replay_ms.fleet on a synthetic context and a recorder filled by hand
(the window, the episodes that hold a replay, None where the program
recorded none or has no recorder, or outside a rollout cell); and a CPU
run of the fleet cell under a profiler session, once on the loop, where
neither reads, and once through a stand-in for the graph, where both
do."""

import time

import numpy as np
import pytest

from bench_small import small_run
from harness import spans as hs
from harness.runner import Context
from harness.spec import load_module
from harness.trace import reduce_ops

MS = 1_000_000
REPLAY_METRICS = ("rollout_graph_share.fleet", "replay_ms.fleet")


@pytest.fixture
def rec():
    spans = pytest.importorskip("spcies_tpu_torch.diagnostics.spans")
    spans.clear()
    yield spans
    spans.clear()


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def _episodes(ks, t0=100 * MS, each=40 * MS, kind="rollout"):
    """The fleet's context: one episode a [steps, lanes] k array, back to
    back from t0, `each` ns apiece."""
    records = [dict(start=t0 + i * each, end=t0 + (i + 1) * each,
                    out=dict(ks=np.asarray(k)))
               for i, k in enumerate(ks)]
    return Context(records=records, driver_kind=kind,
                   config=dict(kernel="k1"))


def test_replay_readers_count_the_episodes_that_replayed(rec):
    # three episodes of 4 steps: 100-140, 140-180 and 180-220 ms
    ctx = _episodes([np.ones((4, 8))] * 3)
    for name, a, b in [("rollout.replay", 141, 143),
                       ("rollout.replay", 181, 184),
                       ("rollout.step", 101, 102),
                       ("rollout.replay", 90, 95),      # before the window
                       ("rollout.replay", 219, 221)]:   # ends after it
        rec._spans.append((name, a * MS, b * MS))
    assert _read("rollout_graph_share.fleet", ctx) == pytest.approx(
        100.0 * 8 / 12)
    assert _read("replay_ms.fleet", ctx) == pytest.approx(2.5)
    # every episode replayed
    rec._spans.append(("rollout.replay", 110 * MS, 111 * MS))
    assert _read("rollout_graph_share.fleet", ctx) == pytest.approx(100.0)
    assert _read("replay_ms.fleet", ctx) == pytest.approx(2.0)


def test_the_share_weighs_episodes_by_their_steps(rec):
    ctx = _episodes([np.ones((2, 8)), np.ones((6, 8))])
    rec._spans.append(("rollout.replay", 150 * MS, 151 * MS))
    assert _read("rollout_graph_share.fleet", ctx) == pytest.approx(75.0)


def test_replay_readers_read_nothing_without_a_replay(rec, monkeypatch):
    ctx = _episodes([np.ones((4, 8))] * 2)
    for a in (100, 110, 140, 150):
        rec._spans.append(("rollout.step", a * MS, (a + 8) * MS))
    for name in REPLAY_METRICS:
        assert _read(name, ctx) is None, name
    # a request cell has no episodes
    rec._spans.append(("rollout.replay", 101 * MS, 102 * MS))
    assert _read("rollout_graph_share.fleet", ctx) is not None
    req = _episodes([np.ones((4, 8))] * 2, kind="requests")
    assert _read("rollout_graph_share.fleet", req) is None
    # a program without a recorder, as before it had one
    monkeypatch.setattr(hs, "recorder", lambda: None)
    for name in REPLAY_METRICS:
        assert _read(name, ctx) is None, name


def _cpu_session(solve):
    """A CPU profiler session around the window (so the program records),
    and one launch of K1 made at its start (`solve`, its wrapper), so the
    window is whole."""

    class Session:
        def start(self):
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU])
            self._prof.__enter__()
            solve.launches += 1

        def stop(self, start, end, spans):
            self._prof.__exit__(None, None, None)
            return reduce_ops([(solve.__name__, start, (end - start) // 2)],
                              start, end, spans)

    return Session


class _Graph:
    """A stand-in for the rollout's EpisodeGraph on the CPU: each call runs
    the loop inside the span a replay records."""

    def __init__(self, episode, kernel, inputs):
        self.episode = episode

    def __call__(self, *inputs):
        from spcies_tpu_torch.diagnostics import spans
        t0 = time.perf_counter_ns()
        out = self.episode(*inputs)
        spans._spans.append(("rollout.replay", t0, time.perf_counter_ns()))
        return out


def _traced_fleet(monkeypatch):
    from harness import runner
    from harness.peaks import PEAKS
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    monkeypatch.setattr(runner, "peaks",
                        lambda kind: PEAKS["NVIDIA H100 80GB HBM3"])
    res = small_run("laxmpc_admm.fleet_shift", trace=True,
                    tracer_type=_cpu_session(fused_admm_solve))
    assert res["correct"] is True
    return {k: v["value"] for k, v in res["metrics"].items()}


def test_a_traced_fleet_on_the_loop_reads_no_replay(rec, monkeypatch):
    m = _traced_fleet(monkeypatch)
    assert m["step_host_ms.fleet"] > 0
    for name in REPLAY_METRICS:
        assert name not in m, name


def test_a_traced_fleet_on_a_graph_reads_the_replays(rec, monkeypatch):
    rollout = pytest.importorskip("spcies_tpu_torch.runtime.rollout")
    monkeypatch.setattr(rollout, "_graphed", lambda s: True)
    monkeypatch.setattr(rollout, "EpisodeGraph", _Graph)
    m = _traced_fleet(monkeypatch)
    assert m["rollout_graph_share.fleet"] == pytest.approx(100.0)
    assert m["replay_ms.fleet"] > 0
    # the loop inside the stand-in's replay still records its steps
    assert m["replay_ms.fleet"] >= m["step_host_ms.fleet"]
