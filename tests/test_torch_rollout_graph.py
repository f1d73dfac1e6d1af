"""The closed-loop rollout's CUDA graph (spcies_tpu_torch.runtime.rollout
EpisodeGraph): which solvers take it, which episode shapes share a graph
and when the loop runs instead, the bookkeeping of a replay (the kernel's
launch count, the launch records with their own counts, the outputs the
caller keeps), and diagnostics.spans' capture log; on the CPU, through
stand-ins for the graph and for torch.cuda.

The tests marked `card` hold the graph to the eager loop on a CUDA device,
bit for bit, and skip without one: the fused laxMPC-ADMM solver at
B=4096, N=30, 50 steps, cold, carried and shifted, with and without
process noise, over three calls on new inputs, a recorded replay's launch
records, and equMPC-ADMM and MPCT-ADMM-cs on the same adapter. This file
imports no JAX,
so on a machine with a card they run alone:

    python -m pytest tests/test_torch_rollout_graph.py --noconftest -m card
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spcies_tpu_torch as tsp
from spcies_tpu_torch.diagnostics import spans
from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
from spcies_tpu_torch.runtime import closed_loop_rollout
from spcies_tpu_torch.runtime import rollout

torch.set_num_threads(2)

ALL = (0, 2 ** 63 - 1)
CUDA = torch.device("cuda")
KEYS = ("xs", "us", "ks", "e_flags")


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _laxmpc(device="cpu", backend="fused", method="ADMM", N=30):
    """laxMPC at the benchmark's closed-loop settings (fp32, exact-k)."""
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param, N=N)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    if method == "FISTA":
        o = tsp.default_options("laxMPC", "FISTA", tol=1e-4, k_max=1000)
    else:
        o = tsp.default_options("laxMPC", "ADMM", rho=10.0, tol=1e-4,
                                k_max=1000, relax_alpha=1.9,
                                tile_b=8 if device == "cpu" else 256,
                                check_every=16, exact_k=True)
    o.precision = "float"
    solver = tsp.make_solver(sys, param, formulation="laxMPC", method=method,
                             options=o, backend=backend, device=device)
    return solver, sys, st


def _box_admm(formulation, device="cpu", N=30):
    """equMPC-ADMM or MPCT-ADMM-cs on the fused box-ADMM kernel, as the
    bench runs laxMPC (fp32, exact-k)."""
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param, N=N)
    sub = "cs" if formulation == "MPCT" else ""
    if formulation == "MPCT":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
    o = tsp.default_options(formulation, "ADMM", sub, rho=10.0, tol=1e-4,
                            k_max=1000, tile_b=8 if device == "cpu" else 256,
                            check_every=16, exact_k=True)
    o.precision = "float"
    solver = tsp.make_solver(sys, param, formulation=formulation,
                             method="ADMM", submethod=sub, options=o,
                             backend="fused", device=device)
    return solver, sys, st


def _episode_inputs(sys, st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return (np.asarray(sys["A"]), np.asarray(sys["B"]), x0, st["xr"],
            st["ur"])


# ---- which solvers take the graph --------------------------------------------

@pytest.mark.parametrize("kind, graphed", [
    ("fused ADMM on the card", True),
    ("fused equMPC-ADMM on the card", True),
    ("fused MPCT-ADMM-cs on the card", True),
    ("fused ADMM on the CPU", False),
    ("dense ADMM on the card", False),
    ("fused FISTA on the card", False)])
def test_only_a_capturable_solve_on_a_card_is_graphed(kind, graphed):
    """The graph is chosen for a CUDA solver whose solve declares itself
    capturable (the box-ADMM kernel's, for laxMPC, equMPC and MPCT-cs),
    and for nothing else: the dense engine reads "all done" on the host
    inside its loop, and the FISTA kernel's solve declares nothing. The
    solvers are built on the CPU, and stand-ins put them on the card."""
    backend = "dense" if "dense" in kind else "fused"
    method = "FISTA" if "FISTA" in kind else "ADMM"
    if "equMPC" in kind or "MPCT" in kind:
        solver, _, _ = _box_admm(kind.split()[1].split("-")[0], N=5)
    else:
        solver, _, _ = _laxmpc(backend=backend, method=method, N=5)
    if "card" in kind:
        solver = SimpleNamespace(device=CUDA, raw_fn=solver.raw_fn)
    assert rollout._graphed(solver) is graphed


class _Graph:
    """A stand-in for EpisodeGraph on the CPU: its replay runs the loop."""

    def __init__(self, episode, kernel, inputs):
        assert kernel is fused_admm_solve
        self.episode, self.replays = episode, 0
        self.shapes = tuple(a.shape for a in inputs)

    def __call__(self, *inputs):
        assert tuple(a.shape for a in inputs) == self.shapes
        self.replays += 1
        return self.episode(*inputs)


@pytest.fixture
def graphed(monkeypatch):
    """A fused CPU solver whose episodes take the graph path through
    _Graph, and a run(...) of closed_loop_rollout on it."""
    solver, sys, st = _laxmpc(N=5)
    monkeypatch.setattr(rollout, "_graphed", lambda s: True)
    monkeypatch.setattr(rollout, "EpisodeGraph", _Graph)

    def run(B=8, n_steps=2, warm_start="shift", noise=False, seed=0):
        A, Bm, x0, xr, ur = _episode_inputs(sys, st, B, seed)
        w = (1e-3 * np.random.default_rng(seed).standard_normal(
            (n_steps, B, A.shape[0])) if noise else None)
        return closed_loop_rollout(solver, A, Bm, x0, xr, ur,
                                   n_steps=n_steps, warm_start=warm_start,
                                   process_noise=w)

    return solver.raw_fn.episode_graphs, run


@pytest.mark.parametrize("change", [dict(B=16), dict(n_steps=3),
                                    dict(warm_start=True),
                                    dict(warm_start=False),
                                    dict(noise=True)])
def test_a_new_shape_takes_a_graph_of_its_own(graphed, change):
    graphs, run = graphed
    run()
    (first,) = graphs.values()
    run(seed=1)
    assert len(graphs) == 1 and first.replays == 2
    run(**change)
    assert len(graphs) == 2 and first.replays == 2
    (second,) = (g for g in graphs.values() if g is not first)
    assert second.replays == 1
    run(seed=2, **change)
    assert second.replays == 2 and first.replays == 2


def test_past_max_graphs_the_loop_runs(graphed, monkeypatch):
    graphs, run = graphed
    monkeypatch.setattr(rollout, "_graphed", lambda s: False)
    eager = run(B=16, warm_start=True, seed=3)
    monkeypatch.setattr(rollout, "_graphed", lambda s: True)
    for n_steps in range(1, rollout.MAX_GRAPHS + 1):
        run(n_steps=n_steps)
    assert len(graphs) == rollout.MAX_GRAPHS
    out = run(B=16, warm_start=True, seed=3)
    assert len(graphs) == rollout.MAX_GRAPHS
    assert all(g.replays == 1 for g in graphs.values())
    for key in KEYS:
        assert torch.equal(out[key], eager[key]), key


# ---- a replay's bookkeeping, through stand-ins for torch.cuda ----------------

class _CUDAGraph:
    replays = 0

    def replay(self):
        _CUDAGraph.replays += 1


def _fake_cuda(monkeypatch):
    """torch.cuda's streams and graphs as no-ops: a "capture" runs the
    episode on the CPU, and a "replay" leaves its outputs as they are."""
    class _Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CUDAGraph)
    monkeypatch.setattr(_CUDAGraph, "replays", 0)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())


def test_a_replay_keeps_the_counts_and_hands_out_copies(monkeypatch):
    _fake_cuda(monkeypatch)
    kernel = SimpleNamespace(launches=0)
    steps = 3

    def episode(x0):
        out = torch.empty((steps,) + x0.shape)
        for t in range(steps):
            kernel.launches += 1
            counts = torch.full((2, 4), 10 * kernel.launches + t,
                                dtype=torch.int32)
            if spans.recording():
                spans.record_launch("fused_admm", 32, False, counts)
            out[t] = x0 + t
        return dict(xs=out)

    x0 = torch.ones(2, 3)
    graph = rollout.EpisodeGraph(episode, kernel, (x0,))
    # the warm-up ran its launches; the capture's are undone, and its
    # records kept apart from the buffer
    assert kernel.launches == steps and spans.launches(*ALL) == []
    assert len(graph.records) == steps and graph.launches == steps
    assert graph.inputs[0] is not x0
    out = graph(2 * x0)
    assert _CUDAGraph.replays == 1 and kernel.launches == 2 * steps
    assert torch.equal(graph.inputs[0], 2 * x0)
    assert out["xs"] is not graph.outputs["xs"]
    assert torch.equal(out["xs"], graph.outputs["xs"])
    # off, a replay records nothing
    assert spans.launches(*ALL) == [] and spans.spans(*ALL) == []
    with profile(activities=[ProfilerActivity.CPU]):
        graph(x0)
    got = spans.launches(*ALL)
    assert [r[0] for r in got] == ["fused_admm"] * steps
    assert [r[2:4] for r in got] == [(32, False)] * steps
    for rec, was in zip(got, graph.records):
        assert rec[4] is not was[4] and torch.equal(rec[4], was[4])
        assert rec[4].data_ptr() != was[4].data_ptr()
    assert [s[0] for s in spans.spans(*ALL)] == ["rollout.replay"]
    assert kernel.launches == 3 * steps


def test_capture_collects_launch_records_apart():
    assert not spans.recording()
    with spans.capture() as outer:
        assert spans.recording()
        spans.record_launch("a", 8, False, "counts a")
        with spans.capture() as inner:
            spans.record_launch("b", 16, True, "counts b")
        spans.record_launch("c", 8, False, "counts c")
    assert not spans.recording()
    assert [r[0] for r in outer] == ["a", "c"]
    assert [r[0] for r in inner] == ["b"] and inner[0][2:] == (16, True,
                                                               "counts b")
    assert spans.launches(*ALL) == []


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    torch.set_float32_matmul_precision("highest")
    return CUDA


STEPS, LANES = 50, 4096


def _card_run(solver, sys, st, seed, warm_start, noise):
    args = _episode_inputs(sys, st, LANES, seed)
    w = None
    if noise:
        w = 1e-3 * torch.randn((STEPS, LANES, args[0].shape[0]),
                               generator=torch.Generator().manual_seed(seed))
    return closed_loop_rollout(solver, *args, n_steps=STEPS,
                               warm_start=warm_start, process_noise=w)


def _eager(monkeypatch, run):
    with monkeypatch.context() as m:
        m.setattr(rollout, "MAX_GRAPHS", 0)
        return run()


@pytest.mark.card
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("warm_start", [False, True, "shift"])
def test_the_graph_gives_the_loops_bits_on_the_card(cuda_device, monkeypatch,
                                                    warm_start, noise):
    solver, sys, st = _laxmpc(cuda_device)
    firsts = None
    for seed in (11, 12, 13):
        def run():
            return _card_run(solver, sys, st, seed, warm_start, noise)
        want = _eager(monkeypatch, run)
        launches = fused_admm_solve.launches
        got = run()
        torch.cuda.synchronize()
        # the first call runs the loop once to warm up, then replays
        assert fused_admm_solve.launches - launches == STEPS * (
            2 if firsts is None else 1)
        for key in KEYS:
            assert torch.equal(got[key], want[key]), (seed, key)
        if firsts is None:
            firsts = got, {key: got[key].clone() for key in KEYS}
    assert len(solver.raw_fn.episode_graphs) == 1
    # later calls left the first call's results as they were
    for key in KEYS:
        assert torch.equal(firsts[0][key], firsts[1][key]), key


@pytest.mark.card
def test_a_recorded_replay_records_each_launch_on_the_card(cuda_device,
                                                           monkeypatch):
    solver, sys, st = _laxmpc(cuda_device)

    def run(seed):
        return _card_run(solver, sys, st, seed, "shift", False)

    with profile(activities=[ProfilerActivity.CPU]):
        _eager(monkeypatch, lambda: run(21))
    torch.cuda.synchronize()
    want = [r[4].cpu() for r in spans.launches(*ALL)]
    assert len(want) == STEPS
    run(22)                      # the capture
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        run(21)
    got = spans.launches(*ALL)
    names = [s[0] for s in spans.spans(*ALL)]
    run(23)                      # another replay, unrecorded
    torch.cuda.synchronize()
    assert names == ["rollout.replay"]
    assert len(got) == STEPS and len({r[4].data_ptr() for r in got}) == STEPS
    for t, (rec, counts) in enumerate(zip(got, want)):
        assert rec[0] == "fused_admm" and rec[2:4] == (32, False)
        assert torch.equal(rec[4].cpu(), counts), t


@pytest.mark.card
@pytest.mark.parametrize("formulation, warm_start", [("equMPC", "shift"),
                                                     ("MPCT", True)])
def test_the_other_box_admm_families_replay_on_the_card(
        cuda_device, monkeypatch, formulation, warm_start):
    """equMPC-ADMM and MPCT-ADMM-cs share the laxMPC solve's adapter, so
    they take the graph too, bit for bit with the loop."""
    solver, sys, st = _box_admm(formulation, cuda_device)
    for seed in (31, 32):
        args = _episode_inputs(sys, st, 1024, seed)

        def run():
            return closed_loop_rollout(solver, *args, n_steps=10,
                                       warm_start=warm_start)
        want = _eager(monkeypatch, run)
        got = run()
        for key in KEYS:
            assert torch.equal(got[key], want[key]), (seed, key)
    assert len(solver.raw_fn.episode_graphs) == 1
