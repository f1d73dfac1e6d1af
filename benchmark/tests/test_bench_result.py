"""A run's result line has the contract's keys; a run without the card
or without the program prints no result; the trace's reduction; a traced
window whose trace is not whole is measured again."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_small import small_run
from harness.spec import BENCH, ROOT, Cell
from harness.trace import reduce_ops


def test_result_line_keys():
    res = small_run("laxmpc_admm.sweep")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    names = [m["name"] for m in Cell("laxmpc_admm.sweep").end_to_end]
    assert sorted(res["metrics"]) == sorted(names)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(res)


def test_rollout_result_line():
    res = small_run("laxmpc_admm.fleet_shift")
    assert res["correct"] is True
    assert set(res["checks"]) == {"u_gap", "x_gap", "k_gap_mean",
                                  "eflag_mismatch_share"}


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "laxmpc_admm.sweep", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})


def test_cli_without_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a card")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_cli_without_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_trace_reduction():
    ms = 1_000_000
    ops = [("void fused_admm_kernel<32>(Params)", 2 * ms, 5 * ms),
           ("Memcpy HtoD (Pageable -> Device)", 1 * ms, ms // 2),
           ("elementwise", 6 * ms, 2 * ms),       # overlaps the kernel
           ("void fused_admm_kernel<32>(Params)", 10 * ms, 3 * ms)]
    spans = [("solver call", 0, 7 * ms), ("readback", 7 * ms, 9 * ms),
             ("solver call", 9 * ms, 13 * ms)]
    s = reduce_ops(ops, 0, 14 * ms, spans)
    # busy: [1, 1.5] + [2, 8] + [10, 13]
    assert s.busy_s == pytest.approx(9.5e-3)
    assert s.window_s == pytest.approx(14e-3)
    assert s.matching("fused_admm") == (8 * ms, 2)
    assert s.device_ns == 10.5 * ms
    # idle: [0, 1] and [1.5, 2] in the call, [8, 10] named by its middle
    # (9 ms, the next call), [13, 14] after the spans
    assert s.idle_by_host == {"solver call": 3.5 * ms,
                              "caller between requests": ms}
    b = s.breakdown()
    assert b["device_ops"][0] == ["void fused_admm_kernel<32>(Params)",
                                  8e-3]
    assert b["idle_gaps"][0] == ["solver call", 3.5e-3]


class _Trace:
    """A stand-in for the device trace: sessions after the first `lost`
    see the window whole, each with three launches of K1 made at its
    start; the first `lost` see no device time."""

    lost = 1
    made = 0

    def __init__(self):
        type(self).made += 1
        self.whole = type(self).made > type(self).lost

    def start(self):
        from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
        fused_admm_solve.launches += 3

    def stop(self, start, end, spans):
        step = (end - start) // 8
        ops = ([("void fused_admm_kernel<32>(Params)", start + i * 2 * step,
                 step) for i in range(3)] if self.whole else [])
        return reduce_ops(ops, start, end, spans)


def _traced_run(monkeypatch, lost: int) -> dict:
    from harness import runner
    from harness.peaks import PEAKS
    monkeypatch.setattr(runner, "peaks",
                        lambda kind: PEAKS["NVIDIA H100 80GB HBM3"])
    monkeypatch.setattr(_Trace, "lost", lost)
    monkeypatch.setattr(_Trace, "made", 0)
    return small_run("laxmpc_admm.sweep", trace=True, tracer_type=_Trace)


@pytest.mark.parametrize("lost", [0, 1, 2])
def test_trace_not_whole_is_measured_again(monkeypatch, capsys, lost):
    res = _traced_run(monkeypatch, lost)
    assert _Trace.made == lost + 1
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert res["metrics"]["k1_roofline"]["value"] > 0
    assert capsys.readouterr().err.count("not whole") == lost


def test_no_whole_trace_prints_no_result(monkeypatch):
    from harness import runner
    with pytest.raises(SystemExit, match="no traced window"):
        _traced_run(monkeypatch, runner.TRACE_WINDOWS)
    assert _Trace.made == runner.TRACE_WINDOWS
