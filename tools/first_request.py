"""Where a fresh process's first request at the fused headline spends its
time, on a machine with a CUDA card (chip_smoke.py phase 23 (e) measures
the first request against warm ones; this script takes it apart).

    python3 tools/first_request.py [--variants plain,warm_copy,...]

Each variant runs in a fresh process, builds the headline solver
(laxMPC-ADMM, N=30, fused, exact-k, B=32768), times its first request and
five warm ones with the phase timer (times_ms, CUDA events) and the host
clock, and prints one JSON line:

- plain: as a user would;
- warm_copy: one 4-element fp64 array placed on the card as fp32 before the
  solver is built (the first pageable host-to-device copy with a cast);
- steps: before the first request, the update's three input placements
  one by one and again (each synchronised, host clock), the first matrix
  product on the card (cuBLAS's start-up), and K1's library load;
- second_solver: after the first solver's requests, a second headline
  solver built in the same process and its first request;
- eager: plain under CUDA_MODULE_LOADING=EAGER (every kernel module of
  the process loaded when the context starts, not at its first launch);
- copies: after the solver is built, the headline's x0 placed on the card
  ten times in each of three ways (as broadcast_inputs does, cast on the
  host then copied; copied as fp64 then cast on the card; cast by numpy
  then copied), each synchronised, with the host's minor page faults of
  each placement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("plain", "warm_copy", "steps", "second_solver", "eager",
            "copies")
COPIES = 10
WARM = 5


def _ms(t0):
    return (time.perf_counter() - t0) * 1e3


def child(variant: str) -> dict:
    import numpy as np
    import torch
    import chip_smoke as c
    import spcies_tpu_torch as sp
    from spcies_tpu_torch.kernels._build import load_kernel
    from spcies_tpu_torch.kernels.fused_admm import FUSED_ADMM_ARGTYPES

    out = dict(variant=variant, device=torch.cuda.get_device_name(0))
    if variant == "warm_copy":
        t0 = time.perf_counter()
        torch.as_tensor(np.zeros(4), dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        out["warm_copy_ms"] = _ms(t0)
    t0 = time.perf_counter()
    solver = c.fused_solver(sp, tile_b=c.TILE_B, check_every=c.CHECK_EVERY,
                            exact_k=True)
    torch.cuda.synchronize()
    out["build_ms"] = _ms(t0)
    _, _, inputs = c.problem(sp, 0, c.BATCH)
    if variant == "steps":
        steps = {}
        for rnd in ("first", "again"):
            for name, a in zip(("x0", "xr", "ur"), inputs):
                t0 = time.perf_counter()
                torch.as_tensor(a, dtype=torch.float32, device="cuda")
                torch.cuda.synchronize()
                steps[f"{rnd}_as_tensor_{name}_ms"] = _ms(t0)
        a = torch.ones((8, 8), device="cuda")
        for rnd in ("first", "again"):
            t0 = time.perf_counter()
            a @ a
            torch.cuda.synchronize()
            steps[f"{rnd}_matmul_ms"] = _ms(t0)
        t0 = time.perf_counter()
        load_kernel("fused_admm", "fused_admm_launch", FUSED_ADMM_ARGTYPES)
        steps["k1_library_load_ms"] = _ms(t0)
        out["steps"] = steps
    if variant == "copies":
        import resource
        x0 = inputs[0]
        ways = {
            "as_tensor": lambda: torch.as_tensor(x0, dtype=torch.float32,
                                                 device="cuda"),
            "cast_on_card": lambda: torch.as_tensor(x0, device="cuda").to(
                torch.float32),
            "numpy_cast": lambda: torch.as_tensor(x0.astype(np.float32),
                                                  device="cuda")}
        out["copies"] = {}
        for name, way in ways.items():
            rows = []
            for _ in range(COPIES):
                f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
                t0 = time.perf_counter()
                way()
                torch.cuda.synchronize()
                rows.append((round(_ms(t0), 3), resource.getrusage(
                    resource.RUSAGE_SELF).ru_minflt - f0))
            out["copies"][name] = rows
        bits = [way() for way in ways.values()]
        out["copies_same_bits"] = all(torch.equal(bits[0], b)
                                      for b in bits[1:])
    t0 = time.perf_counter()
    first = solver(*inputs)
    out["first_host_ms"] = _ms(t0)
    out["first"] = first.sol["times_ms"]
    out["warm"] = [solver(*inputs).sol["times_ms"] for _ in range(WARM)]
    if variant == "second_solver":
        second = c.fused_solver(sp, tile_b=c.TILE_B,
                                check_every=c.CHECK_EVERY, exact_k=True)
        out["second_first"] = second(*inputs).sol["times_ms"]
    assert bool((first.e_flag == 1).all())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child)), flush=True)
        return
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    for variant in args.variants.split(","):
        extra = {"CUDA_MODULE_LOADING": "EAGER"} if variant == "eager" else {}
        p = subprocess.run([sys.executable, __file__, "--child", variant],
                           cwd=ROOT, env={**env, **extra},
                           capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"{variant}: exit {p.returncode}\n"
                               f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        line = [s for s in p.stdout.splitlines() if s.startswith("RESULT ")]
        print(line[-1][len("RESULT "):], flush=True)


if __name__ == "__main__":
    main()
