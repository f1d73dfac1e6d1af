"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result line.

Order of a run: build the program's solver and draw the pool from the
seed, warm up (two requests), and count all of that as set-up; measure
for `seconds`, under the profiler when traced; read the device's memory
peak; check the import guard; free the program's state; work out the
reference's answer for every pool batch the window served; compare
every request with it; read the cell's metrics; print.

A traced window whose trace is not whole (the profiler failed, saw no
device time, or saw another number of the cell's kernel launches than
the program made) is measured again, up to TRACE_WINDOWS windows in
all, each under a profiler session of its own; the metrics are read
from the whole one, and every window's requests are checked.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np

from harness import compare, drivers, guard
from harness.peaks import peaks
from harness.plant import options, sys_param
from harness.spec import Cell, load_module
from harness.trace import DeviceTrace
from harness.traffic import draw_pool
from reference.common import Arith, plant_matrices

WARM_REQUESTS = 2
TRACE_WINDOWS = 3


class Context:
    """What a metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def launch_ks(self):
        """Per-lane k of every kernel launch in the window, in order."""
        key = "k" if self.driver_kind == "requests" else "ks"
        for rec in self.records:
            ks = rec["out"][key]
            yield from ([ks] if self.driver_kind == "requests" else ks)

    def kernel_work(self):
        """(FLOP, bytes) of every kernel launch in the window."""
        lanes = int(self.traffic["batch"])
        for k in self.launch_ks():
            yield (self.work.flops(self.problem, k),
                   self.work.nbytes(self.problem, lanes))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def read_trace(tracer, records, start: int, end: int, work,
               launches: int):
    """(the window's trace summary, None) where the trace is whole, else
    (None, why)."""
    spans = sorted((s for r in records for s in r["spans"]),
                   key=lambda s: s[1])
    try:
        summary = tracer.stop(start, end, spans)
    except Exception as exc:        # the profiler's own failure
        return None, f"the profiler failed: {exc!r}"
    seen_ns, seen = summary.matching(work.TRACE_NAME)
    if summary.device_ns <= 0 or seen != launches:
        return None, (f"the trace saw {summary.device_ns} ns of device time "
                      f"and {seen} launches of {work.TRACE_NAME}; the "
                      f"program made {launches}")
    summary.kernel_ns = seen_ns
    return summary, None


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
        t_process: float, traffic_override: dict | None = None,
        tracer_type=DeviceTrace) -> dict:
    """One run; returns the result line's dict (checks last)."""
    import torch
    import spcies_tpu_torch as sp
    from spcies_tpu_torch.kernels import _build

    marks = [("imports", time.perf_counter())]
    config = cell.config
    traffic = dict(cell.traffic, **(traffic_override or {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    work = load_module("work", config["kernel"])
    A, B = plant_matrices(config)
    sysd, param = sys_param(config)
    solver = sp.make_solver(sysd, param, formulation=config["formulation"],
                            method=config["method"],
                            submethod=config.get("submethod", ""),
                            options=options(sp, config),
                            backend=config["backend"], device=dev)
    marks.append(("solver", time.perf_counter()))
    pool = draw_pool(traffic, A, B, seed)
    driver = drivers.make(solver, traffic, pool, A, B)
    marks.append(("pool", time.perf_counter()))
    for i in range(WARM_REQUESTS):
        driver.request(i)
    if on_card:
        torch.cuda.synchronize(dev)
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - t_process
    parts = {name: t - prev for (name, t), prev
             in zip(marks, [t_process] + [t for _, t in marks])}
    build = _build.build_record(work.LIBRARY) or {}

    # `records`: the measured window's requests; `checked`: every
    # window's, all compared with the reference
    checked, summary = [], None
    for attempt in range(1, (TRACE_WINDOWS if trace else 1) + 1):
        launches0 = work.launches()
        tracer = tracer_type() if trace else None
        if tracer:
            tracer.start()
        records, w0, w1 = drivers.window(driver, seconds, len(checked))
        checked += records
        if tracer is None:
            break
        summary, why = read_trace(tracer, records, w0, w1, work,
                                  work.launches() - launches0)
        if summary is not None:
            break
        print(f"benchmark: traced window {attempt} of {TRACE_WINDOWS} not "
              f"whole: {why}", file=sys.stderr)
    if trace and summary is None:
        raise SystemExit(f"benchmark: no traced window of {TRACE_WINDOWS} "
                         f"was whole: no device metric is read")
    memory_peak = 0
    if on_card:
        torch.cuda.synchronize(dev)
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
    guard.check()
    driver_kind = driver.kind
    del driver, solver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the plain reference, on the same device, in float64
    t_check = time.perf_counter()
    ref = load_module("reference", config["reference"])
    problem = ref.Problem(config)
    arith = Arith("fp64", dev)
    used = sorted({r["pool"] for r in checked})
    expected = dict(zip(used, compare.expected_answers(
        ref, problem, traffic, [pool[p] for p in used], arith)))
    nums = compare.numbers(cell.limits, checked, expected)
    check_s = time.perf_counter() - t_check

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    ctx = Context(records=records, window_s=(w1 - w0) / 1e9,
                  setup_s=setup_s, traffic=traffic, driver_kind=driver_kind,
                  trace=summary, problem=problem,
                  work=work, config=config,
                  peaks=peaks(kind) if summary else None)
    if summary is not None:
        ctx.kernel_ns = summary.kernel_ns
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])

    # a lane the solver gave up on (e_flag -1, k_max reached) has failed
    flag = next((k for k in ("e_flag", "e_flags")
                 if k in records[0]["out"]), None)
    failed = (sum(int(np.count_nonzero(r["out"][flag] != 1))
                  for r in checked) if flag else 0)
    device_out = dict(platform="gpu" if on_card else dev.type, kind=kind,
                      count=1, memory_peak_bytes=memory_peak)
    if summary is not None:
        device_out.update(busy_s=summary.busy_s, window_s=summary.window_s)
    lanes = int(traffic["batch"]) * int(traffic.get("steps", 1))
    result = dict(correct=compare.passed(nums),
                  attempted=lanes * len(checked), failed=failed,
                  metrics=metrics, device=device_out)
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["card"] = card_line() if on_card else "cpu"
    result["setup"] = dict(setup_s=setup_s,
                           build_s=float(build.get("seconds", 0.0)),
                           build_cached=bool(build.get("cached", True)),
                           **{f"{k}_s": v for k, v in parts.items()})
    # the reference's and the comparison's seconds, after the window
    result["check_s"] = check_s
    result["checks"] = nums
    guard.check()
    return result


def main(args, t_process: float) -> int:
    import torch
    cell = Cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 device="cuda", t_process=t_process)
    s = result["setup"]
    print(f"setup_s {s['setup_s']:.3f} (nvcc build {s['build_s']:.3f} s, "
          f"cached {s['build_cached']}); card {result['card']}",
          file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
