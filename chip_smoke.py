#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spcies_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from csrc/, then
  1. runs the kernel and its plain PyTorch version on the same CUDA tensors
     at the laxMPC-ADMM headline (oscillating masses, N=30, rho=10,
     relax_alpha=1.9, tol 1e-4, k_max 1000, B=32768, exact-k with
     check_every=16), and at B=4096 in the checked, free-run, fixed_iters
     and bf16 modes, and holds them together: every lane converges, k
     agrees on >= 0.9985 of lanes, and u agrees within 1e-4 on the lanes
     with equal k;
  2. drives the main path — make_solver(..., backend="fused",
     device="cuda") — through four requests (three batches, then a warm
     start), checks that each went through the kernel and converged, and
     checks a small batch against the fp64 dense engine on the CPU;
  3. times the kernel, its plain version and the fp32 dense engine at the
     headline shape with CUDA events.
It exits non-zero, with no result line, when there is no CUDA device or
any check fails. The last line is the JSON result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 30
RHO = 10.0
RELAX_ALPHA = 1.9
TOL = 1e-4
K_MAX = 1000
BATCH = 32768
SMALL_BATCH = 4096
TILE_B = 256
CHECK_EVERY = 16
K_AGREE = 0.9985    # the JAX package's hardware bar for per-lane k parity
U_TOL = 1e-4        # kernel vs plain version, lanes with equal k
U_TOL_FP64 = 1e-3   # fp32 fused vs fp64 dense, tol 1e-4 solutions


def log(msg):
    print(msg, flush=True)


def require_cuda():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def build_kernel():
    from spcies_tpu_torch.kernels import _build
    from spcies_tpu_torch.kernels.fused_admm import FUSED_ADMM_ARGTYPES
    t0 = time.perf_counter()
    _build.load_kernel("fused_admm", "fused_admm_launch",
                       FUSED_ADMM_ARGTYPES)
    rec = _build.build_record("fused_admm")
    log(f"kernel build: fused_admm {time.perf_counter() - t0:.2f} s "
        f"(nvcc {rec['seconds']:.2f} s, cached={rec['cached']})")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")


def problem(sp, seed: int, B: int):
    """The bench inputs (bench.py): the tester fixture at N=30, x0 scaled
    per lane by a uniform factor in [-2, 2] drawn from `seed`."""
    sys_, param, st = sp.systems.tester_fixture()
    param30 = dict(param)
    param30["N"] = N
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2.0, 2.0, (B, 1))
    xr = np.tile(st["xr"], (B, 1))
    ur = np.tile(st["ur"], (B, 1))
    return sys_, param30, (x0, xr, ur)


def headline_options(sp, precision="float", **kw):
    o = sp.default_options("laxMPC", "ADMM", rho=RHO, tol=TOL, k_max=K_MAX,
                           relax_alpha=RELAX_ALPHA, **kw)
    o.precision = precision
    return o


def fused_solver(sp, device="cuda", **kw):
    sys_, param30, _ = problem(sp, 0, 1)
    return sp.make_solver(sys_, param30, formulation="laxMPC",
                          method="ADMM", options=headline_options(sp, **kw),
                          backend="fused", device=device)


def kernel_args(solver, inputs, fixed_iters=0):
    """The kernel's exact arguments for one call of the fused solver."""
    from spcies_tpu_torch.api import broadcast_inputs
    x = broadcast_inputs(torch.float32, solver.device, *inputs)
    z1p, v0p, lam0p, _order, _b = solver.raw_fn.prepare(*x)
    kw = dict(solver.raw_fn.kernel_kw, fixed_iters=fixed_iters)
    return (z1p, v0p, lam0p, *solver.raw_fn.operator), kw


def agreement(out_k, out_p, B, m, fixed):
    """k agreement and max |u_kernel - u_plain| over lanes with equal k."""
    k_k, k_p = out_k[3][:B], out_p[3][:B]
    same = k_k == k_p
    du = (out_k[1][:B, :m] - out_p[1][:B, :m]).abs().amax(dim=1)
    return dict(
        k_agree=float(same.float().mean()),
        conv_kernel=float((out_k[4][:B] == 1).float().mean()),
        conv_plain=float((out_p[4][:B] == 1).float().mean()),
        u_err=float(du[same].max()) if bool(same.any()) else float("inf"),
        k_mean=float(k_k.float().mean()), fixed=fixed)


def check_agreement(name, a):
    log(f"phase 1 {name}: " + json.dumps(a))
    if not a["fixed"]:
        assert a["conv_kernel"] == 1.0 and a["conv_plain"] == 1.0, name
    assert a["k_agree"] >= K_AGREE, (name, a["k_agree"])
    assert a["u_err"] <= U_TOL, (name, a["u_err"])


def phase_kernel_vs_plain(sp):
    """Kernel and plain version on the same CUDA tensors. Returns the
    headline comparison and the headline plain outputs."""
    from spcies_tpu_torch.kernels.fused_admm import (fused_admm_reference,
                                                     fused_admm_solve)
    modes = [
        ("headline exact-k B=32768", BATCH, 0,
         dict(tile_b=TILE_B, check_every=CHECK_EVERY, exact_k=True)),
        ("checked B=4096", SMALL_BATCH, 0, dict(tile_b=TILE_B)),
        ("free-run B=4096", SMALL_BATCH, 0,
         dict(tile_b=8, check_every=CHECK_EVERY)),
        ("fixed_iters=50 B=4096", SMALL_BATCH, 50, dict(tile_b=TILE_B)),
        ("bf16 exact-k B=4096", SMALL_BATCH, 0,
         dict(tile_b=TILE_B, check_every=CHECK_EVERY, exact_k=True,
              bf16_delta=True)),
    ]
    head = None
    for name, B, fixed, kw in modes:
        solver = fused_solver(sp, **kw)
        _, _, inputs = problem(sp, 0, B)
        args, kk = kernel_args(solver, inputs, fixed)
        out_k = fused_admm_solve(*args, **kk)
        torch.cuda.synchronize()
        out_p = fused_admm_reference(*args, **kk)
        torch.cuda.synchronize()
        a = agreement(out_k, out_p, B, solver.m, bool(fixed))
        check_agreement(name, a)
        if head is None:
            head = (a, out_p, solver.m)
    return head


def phase_main_path(sp, head_plain, m):
    """Four requests through make_solver(..., backend='fused',
    device='cuda'); every one must launch the kernel once."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    solver = fused_solver(sp, tile_b=TILE_B, check_every=CHECK_EVERY,
                          exact_k=True)
    requests = [problem(sp, seed, BATCH)[2] for seed in (0, 1, 2)]
    fused_admm_solve.launches = 0
    results, times = [], []
    for inputs in requests:
        t0 = time.perf_counter()
        results.append(solver(*inputs))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prev = results[-1]
    t0 = time.perf_counter()
    results.append(solver(*requests[-1], init=(prev.sol["z"], prev.sol["v"],
                                               prev.sol["lam"])))
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    launches = fused_admm_solve.launches

    names = ("seed 0", "seed 1", "seed 2", "seed 2 warm")
    for name, res, dt in zip(names, results, times):
        k_mean = float(res.k.float().mean())
        log(f"phase 2 request {name}: k_mean={k_mean} "
            f"converged={float((res.e_flag == 1).float().mean())} "
            f"host_ms={dt * 1e3:.3f} times_ms={res.sol['times_ms']}")
        assert tuple(res.u.shape) == (BATCH, m), res.u.shape
        assert res.u.is_cuda and bool(torch.isfinite(res.u).all())
        assert bool((res.e_flag == 1).all()), name
    assert launches == len(requests) + 1, launches
    assert float(results[3].k.float().mean()) < float(
        results[2].k.float().mean())
    # request 0 against the plain version of phase 1 (same inputs)
    same = results[0].k == head_plain[3][:BATCH]
    du = (results[0].u - head_plain[1][:BATCH, :m]).abs().amax(dim=1)
    log(f"phase 2 request seed 0 vs plain: k_agree="
        f"{float(same.float().mean())} u_err={float(du[same].max())} "
        f"(JAX package on its TPU, BENCH_r05_validation.json: k_mean 180.2)")
    assert float(same.float().mean()) >= K_AGREE
    assert float(du[same].max()) <= U_TOL

    # a small batch against the fp64 dense engine on the CPU
    sys_, param30, small = problem(sp, 5, 64)
    ref = sp.make_solver(sys_, param30, formulation="laxMPC", method="ADMM",
                         options=headline_options(sp, precision="double"))
    r64 = ref(*small)
    r32 = solver(*small)
    err = float((r32.u.cpu().double() - r64.u).abs().max())
    log(f"phase 2 fused fp32 (cuda) vs dense fp64 (cpu), B=64: "
        f"max|du|={err}")
    assert bool((r64.e_flag == 1).all()) and bool((r32.e_flag == 1).all())
    assert err <= U_TOL_FP64, err
    return launches, solver


def cuda_ms(fn, reps=1):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_times(sp, fused):
    """Kernel, plain version and fp32 dense engine at the headline shape,
    in turns (plain, kernel, kernel, plain), each a CUDA-event mean."""
    from spcies_tpu_torch.kernels.fused_admm import (fused_admm_reference,
                                                     fused_admm_solve)
    _, _, inputs = problem(sp, 0, BATCH)
    args, kk = kernel_args(fused, inputs)
    sys_, param30, _ = problem(sp, 0, 1)
    dense = sp.make_solver(sys_, param30, formulation="laxMPC",
                           method="ADMM",
                           options=headline_options(sp),
                           backend="dense", device="cuda")
    dense.options.timing = False
    x = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
         for a in inputs]
    kernel = lambda: fused_admm_solve(*args, **kk)  # noqa: E731
    plain = lambda: fused_admm_reference(*args, **kk)  # noqa: E731
    dense_fn = lambda: dense(*x)  # noqa: E731
    t = {"plain": [], "kernel": [], "dense": []}
    t["plain"].append(cuda_ms(plain))
    t["kernel"].append(cuda_ms(kernel, reps=5))
    t["kernel"].append(cuda_ms(kernel, reps=5))
    t["plain"].append(cuda_ms(plain))
    t["dense"].append(cuda_ms(dense_fn))
    t["dense"].append(cuda_ms(dense_fn))
    res = dense(*x)
    log(f"phase 3 dense fp32 engine: k_mean={float(res.k.float().mean())} "
        f"converged={float((res.e_flag == 1).float().mean())}")
    log("phase 3 times (ms per B=32768 solve, CUDA events): "
        + json.dumps(t))
    return {key: min(v) for key, v in t.items()}


def main():
    require_cuda()
    import spcies_tpu_torch as sp
    # full fp32 products everywhere, the plain versions included (this
    # also turns torch.backends.cuda.matmul.allow_tf32 off)
    torch.set_float32_matmul_precision("highest")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    build_kernel()
    head, head_plain, m = phase_kernel_vs_plain(sp)
    launches, fused = phase_main_path(sp, head_plain, m)
    times = phase_times(sp, fused)
    log(json.dumps({"kernels": [{
        "name": "fused_admm", "route": "cuda",
        "source": "spcies_tpu_torch/csrc/fused_admm.cu",
        "replaces": "spcies_tpu/kernels/fused_admm.py:74",
        "launches": launches, "max_abs_err": head["u_err"],
        "ms": times["kernel"], "plain_ms": times["plain"]}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
