"""diagnostics.PhaseTimer's CUDA branch, driven on the CPU through a stub of
torch.cuda's events, streams and synchronize: each stamp is an event
recorded on the device's current stream, nothing synchronises before
finish(), finish() waits once, on the last stamp, and the four phases come
from the events' elapsed times. BatchedSolver.__call__ drives the timer
with three marks and one finish, and records no event with timing off.
(The host-clock branch: tests/test_torch_api.py::test_timing_phase_times.)
Also the update phase's host cast in broadcast_inputs: numpy's bits are
torch's."""

import numpy as np
import pytest
import torch

import spcies_tpu_torch as tsp
from spcies_tpu_torch.diagnostics import timing
from spcies_tpu_torch.diagnostics.timing import PhaseTimer

torch.set_num_threads(2)

# the stream times, in ms, at which the stub's events complete: the
# construction stamp, then update, solve and polish
STAMPS = (10.0, 10.25, 38.75, 38.8)


class _Cuda:
    """The stub: events take their times from STAMPS in the order they are
    recorded; every wait is logged in order with the work done before it."""

    def __init__(self):
        self.log = []
        self.events = []
        self.stream = object()
        cuda = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = None
                cuda.events.append(self)

            def record(self, stream=None):
                assert stream is cuda.stream
                assert self.t is None
                self.t = STAMPS[len([e for e in cuda.events
                                     if e.t is not None])]
                cuda.log.append("record")

            def synchronize(self):
                cuda.log.append(("event.synchronize", self.t))

            def elapsed_time(self, end):
                assert ("event.synchronize", STAMPS[-1]) in cuda.log
                return end.t - self.t

        self.Event = Event

    def current_stream(self, device=None):
        assert torch.device(device).type == "cuda"
        self.log.append("current_stream")
        return self.stream

    def synchronize(self, device=None):
        self.log.append("synchronize")


@pytest.fixture
def cuda(monkeypatch):
    stub = _Cuda()
    monkeypatch.setattr(torch.cuda, "Event", stub.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", stub.current_stream)
    monkeypatch.setattr(torch.cuda, "synchronize", stub.synchronize)
    return stub


def test_cuda_timer_records_events_and_waits_once(cuda):
    timer = PhaseTimer(torch.device("cuda", 0))
    for phase in ("update", "solve", "polish"):
        timer.mark(phase)
    assert cuda.log == ["current_stream"] + ["record"] * 4
    assert timer.times_ms == {}
    times = timer.finish()
    waits = [e for e in cuda.log if e != "record" and e != "current_stream"]
    assert waits == [("event.synchronize", STAMPS[-1])]
    assert times == pytest.approx(dict(
        update=STAMPS[1] - STAMPS[0], solve=STAMPS[2] - STAMPS[1],
        polish=STAMPS[3] - STAMPS[2], run=STAMPS[3] - STAMPS[0]))
    assert list(times) == ["update", "solve", "polish", "run"]


def test_cpu_timer_uses_no_cuda(cuda):
    """On the CPU (and with no device) the stamps are the host clock."""
    for device in (torch.device("cpu"), None):
        timer = PhaseTimer(device)
        timer.mark("update")
        times = timer.finish()
        assert set(times) == {"update", "run"}
        assert times["run"] >= times["update"] >= 0.0
    assert cuda.log == [] and cuda.events == []


class _CudaTimer(PhaseTimer):
    """PhaseTimer of a CPU solver's request, on the stub's CUDA branch."""

    def __init__(self, device=None):
        assert device.type == "cpu"
        super().__init__(torch.device("cuda"))


@pytest.mark.parametrize("timing_on", [True, False])
def test_request_path_drives_the_timer(cuda, monkeypatch, timing_on):
    """A request marks update, solve and polish and finishes once, with
    one wait, after its work; with timing off it records no event and
    waits for nothing, and gives the same bits."""
    monkeypatch.setattr(timing, "PhaseTimer", _CudaTimer)
    sys_, param, st = tsp.systems.tester_fixture()
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=500)
    solver = tsp.make_solver(sys_, param, formulation="laxMPC",
                             method="ADMM", options=opt, device="cpu")
    reference = tsp.make_solver(sys_, param, formulation="laxMPC",
                                method="ADMM", options=opt, device="cpu")
    reference.options.timing = False
    want = reference(st["x"], st["xr"], st["ur"])
    solver.options.timing = timing_on
    cuda.log.clear()
    res = solver(st["x"], st["xr"], st["ur"])
    np.testing.assert_array_equal(res.u.numpy(), want.u.numpy())
    np.testing.assert_array_equal(res.k.numpy(), want.k.numpy())
    if not timing_on:
        assert cuda.log == [] and "times_ms" not in res.sol
        return
    assert cuda.log == (["current_stream"] + ["record"] * 4
                        + [("event.synchronize", STAMPS[-1])])
    assert res.sol["times_ms"] == pytest.approx(dict(
        update=0.25, solve=28.5, polish=0.05, run=28.8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_broadcast_inputs_host_cast_keeps_bits(dtype):
    """broadcast_inputs casts host data with numpy before placing it (a
    card's first requests paid 5-20 ms a call in torch's cast inside the
    copy): every bit equals torch's own cast, rounding ties, float32
    subnormals and overflow, signed zeros and NaN included, for arrays,
    lists and scalars, and tensors pass through as before."""
    from spcies_tpu_torch.api import broadcast_inputs
    rng = np.random.default_rng(17)
    tie = np.float64(np.float32(1.0)) * (1 + 2.0 ** -24)   # halfway
    edge = np.array([tie, -tie, 1e-40, -1e-45, 3e-39, 1e39, -1e300, 0.0,
                     -0.0, np.nan, np.inf, 1 / 3])
    x = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -30, 30, 500), edge]).reshape(4, -1)
    inputs = (x, x[0].tolist(), 0.1, torch.as_tensor(x))
    got = broadcast_inputs(dtype, "cpu", *inputs, core_ndims=(1, 1, 0, 1))
    itype = torch.int32 if dtype == torch.float32 else torch.int64
    for a, g in zip(inputs, got):
        want = torch.as_tensor(a, dtype=dtype)
        want = want[None] if want.ndim < g.ndim else want
        assert g.dtype == dtype
        assert torch.equal(g.contiguous().view(itype),
                           want.expand_as(g).contiguous().view(itype))
