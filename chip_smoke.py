#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spcies_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together), then
  1. runs the box-ADMM kernel and its plain PyTorch version on the same
     CUDA tensors at the laxMPC-ADMM headline (oscillating masses, N=30,
     rho=10, relax_alpha=1.9, tol 1e-4, k_max 1000, B=32768, exact-k with
     check_every=16), at the MPCT-ADMM-cs family (480 columns, B=8192), in
     the bf16 mode at B=32768 and 4096, and at B=4096 in the checked,
     free-run, fixed_iters and unrelaxed modes, and holds them together:
     every lane converges, k agrees on >= 0.9985 of lanes, and u agrees
     within 1e-4 on the lanes with equal k; every fp32 mode is also run at
     each number of lanes a block the kernel is built for and must give the
     8-lane build's k, e_flag, iterates and residuals bit for bit
     (tools/ab_kernels.py holds every build to the one-column-per-thread
     parent kernel, csrc/variants/fused_admm_parent.cu);
  2. drives the main path — make_solver(..., backend="fused",
     device="cuda") — through four requests (three batches, then a warm
     start), checks that each went through the kernel and converged, and
     checks a small batch against the fp64 dense engine on the CPU;
  3. times the kernel, its plain version and the fp32 dense engine at the
     headline shape with CUDA events;
  4. runs the dual-FISTA kernel and its plain version on the same CUDA
     tensors at the bench's N=30 families (bench.py:262-288: tol 1e-4,
     k_max 4000, tile_b 256, check_every 8, exact-k; laxMPC-FISTA with
     restart, equMPC-FISTA without) at the family batch B=8192, and at
     B=4096 in the checked, free-run, fixed_iters and exact-k (with and
     without restart) modes, held together as in 1, each mode at each
     number of lanes a block the kernel is built for, every build also held
     to the plain version and to the 8-lane build bit for bit;
  5. drives the slice's three paths — laxMPC-FISTA, equMPC-FISTA and
     equMPC-ADMM (rho 6, relax_alpha 1.8) through make_solver(...,
     backend="fused", device="cuda") — with a request and a warm start
     each at B=8192; each request launches its kernel once and converges
     on every lane, and a small batch agrees with the fp64 dense engine
     on the CPU;
  6. times the FISTA kernel, its plain version and the fp32 dense FISTA
     engine at B=8192 and 32768, with the lanes a block of the launch, its
     blocks' iterations against k_mean and its bound, and the equMPC-ADMM
     fused solve at 8192;
  7. runs the MPCT-EADMM kernel and its plain version on the same CUDA
     tensors at the bench's N=30 family (bench.py:289-296: T = 10 Q,
     S = R, rho_base 2, rho_mult 20, tol 1e-4, k_max 5000, checked) at
     B=8192, and at B=4096 in the free-run, exact-k and k_max-capped
     modes, held together as in 1, each mode at 8 and 16 lanes a block,
     every build also held to the plain version and to the 8-lane build
     bit for bit;
  8. drives MPCT-EADMM and MPCT-ADMM-cs (bench.py:297-302: rho 2, k_max
     4000, exact-k, check_every 8) through make_solver(...,
     backend="fused", device="cuda") as in 5;
  9. times the EADMM kernel, its plain version and the fp32 dense EADMM
     engine at B=8192 and 32768, with the lanes a block of the launch, its
     blocks' iterations against k_mean and two bounds (the products'
     FLOP counted over every column of C2m and C2t, and over their nd
     distinct columns, as the kernel computes them: the kernels line
     carries the second), and the MPCT-ADMM-cs fused solve and its fp32
     dense engine at 8192;
 10. runs the ellipMPC kernels and their plain versions on the same CUDA
     tensors at the bench's N=30 ellipMPC families (bench.py:309-326: T
     diagonalised, P = I, c = xr, r = 0.5, tol 1e-4): K4 (ellipMPC-ADMM,
     rho 5, k_max 4000, tile_b 256, exact-k, check_every 8) at B=8192 and
     at B=4096 checked, free-run, fixed_iters, capped and with a random
     SPD P and c != xr; K5 (ellipMPC-ADMM-soc, rho 5, sigma 4, k_max 5000,
     plain free-run with check_every 8, which takes tile_b 8 on the card,
     r_ellip 0.5) at B=8192 and at B=4096 checked, exact-k, capped in
     exact-k and in free-run and with a per-lane radius in [0.1, 1]; held
     together as in 1; K4 at each number of lanes a block its builds take
     held to the plain version and to its 8-lane build bit for bit in every
     mode, as K2 in 4, and K5's builds to its 8-lane build, as K1's in 1;
 11. drives both ellipMPC paths through make_solver(..., backend="fused")
     with the device left to its default, the card: a request and a warm
     start each at B=8192, each launching its kernel once and converging
     on every lane, and a small batch against the fp64 dense engine on
     the CPU;
 12. times K4 and K5, their plain versions and the fp32 dense engines at
     B=8192 and 32768, with the lanes a block of the launch, the mean k of
     its 8-lane groups and its blocks' iterations (the kernel's own count
     where it refills);
 13. runs the HMPC kernels and their plain versions on the same CUDA
     tensors at the bench's four N=30 HMPC families (bench.py:327-375: w =
     3 * 1.627 * 0.2, Te = Th = 10 N Q, Se = R, Sh = R / 2, tol 1e-4):
     K6 for HMPC-ADMM (rho 5, k_max 5000, plain free-run with check_every
     8, which takes tile_b 8 on the card) and ellipHMPC-ADMM (the three
     mass positions as outputs within +-0.1, Te = Th = N Q, rho 200,
     sigma 0.01, binding sinusoidal references) at B=8192, and at B=4096
     checked, exact-k, capped in exact-k and in free-run and with use_soc;
     K7 for HMPC-ADMM-split and HMPC-SADMM-split (rho 5, sigma 5, k_max
     4000, exact-k with check_every 8, tile_b 256) at B=8192, and at
     B=4096 checked, free-run, capped and with use_soc; held together as in
     1, and each kernel's builds to each other as K5's in 10 (K7's 8-, 16-
     and 32-lane builds also without refill, which it takes in every mode);
 14. drives the four HMPC paths through make_solver(..., backend="fused")
     with the device left to its default, as in 11;
 15. times K6 and K7, their plain versions and the fp32 dense engines at
     B=8192 and 32768 for HMPC-ADMM, HMPC-ADMM-split and ellipHMPC-ADMM,
     and at B=8192 for HMPC-SADMM-split, with iterations as in 12;
 16. drives the closed-loop rollout (spcies_tpu_torch.runtime) on the card
     at the bench's closed-loop settings (bench.py:388-445: the headline
     laxMPC-ADMM solver, B=4096 loops, 50 steps): the fused exact-k solver
     cold, carried and shifted, and the dense engine shifted, each timed
     (solves/s, k_mean, k_mean after step 0) and profiled once (device
     time against wall: the idle share); every fused step launches K1
     once, the shifted rows converge on every lane of every step, a lane
     of the cold and carried rows that does not reached k_max, shift's
     iterations after step 0 stay under 0.7 x cold's, and the fused shift
     trajectory lies within 1e-3 of the dense one;
 17. runs K1's wide build and its plain version on the same CUDA tensors at
     MPCT-ADMM-cs N=33 (544 columns) and N=64 (1024), B=8192, exact-k,
     held together as in 1 and timed, the wide build against the narrow
     one bit for bit at laxMPC-ADMM N=64 (512 columns), and checks that
     make_solver(..., backend="fused", device="cuda") refuses at build
     time a width past each kernel's cap of 1024 columns (1056); then
     K2-K7's wide builds (512 threads of two columns on the stage at 16
     or 8 lanes a block; K4-K7 with refill, K2 and K3 without): each
     forced at its family's N=30 width gives the narrow build's bits in
     every mode of the kernel's own phase (4, 7, 10 or 13) at each
     lanes-a-block build (K4-K7 with refill and without), and at the
     first oscillating-masses horizon whose padded width passes 512 and
     the widest whose widths stay at or under 1024 (WIDE_HORIZONS; one
     family a kernel at the bench's settings, B=8192; WIDE_EXTRA:
     ellipHMPC-ADMM at N=62 for K6's other family, HMPC-SADMM-split at
     N=58 for K7's half-step, and MPCT-EADMM on two random plants at 1024
     columns with 21 and 29 classes of columns, where K3's z2 chains read
     C2d by __ldg) it converges on every lane, agrees with its plain
     version as in 1 and is timed against it (kernel, plain once, kernel)
     with its bound and its plan, and every other lanes-a-block build
     gives the planned one's bits;
 18. runs every kernel away from the N=30 fixture, one family a kernel
     (laxMPC-ADMM, laxMPC-FISTA, MPCT-EADMM, ellipMPC-ADMM, -soc,
     HMPC-ADMM, HMPC-ADMM-split): on the three random plants of
     tests/test_fuzz_differential.py (random_plant) and the oscillating
     masses at N=10 and 31, B=1024, checked and exact-k: every lane
     converges, k agrees with the plain version on >= 0.9985 of lanes, u
     within 1e-4, and every lanes-a-block build that takes the shape gives
     the same bits; each launch plan is logged;
 19. drives the banded backends and the time-varying mode (plain torch, no
     kernel of csrc/) through make_solver(..., device="cuda") on the
     oscillating masses: each of laxMPC-ADMM, -FISTA, equMPC-ADMM, -FISTA,
     ellipMPC-ADMM and MPCT-ADMM-cs banded, and the time-varying
     laxMPC-ADMM (sequential, band_parallel_scan, tv_dense_w),
     laxMPC-FISTA, equMPC-ADMM, -FISTA and MPCT-ADMM-cs, each lane its own
     model (A, B and the Q and R diagonals scaled per lane in [0.97,
     1.03]), in fp64 at N=30, B=256 against the same solver on the CPU
     (every lane converged, k equal, a lane that moves named and by one
     iteration at most, u within 1e-8; the fp64 CPU runs of phases 19
     and 20 start before phase 18 in CPU_WORKERS processes of one thread
     each, beside the card's phases 18-20); then in fp32 at the JAX
     long-horizon record's sizes (BENCH_LONGN_r05.json; BAND_ROWS: banded
     and scan against dense at N=120, B=4096 and N=480, B=1024, MPCT-cs
     banded against dense at N=120, the time-varying rows at N=120,
     B=4096 and N=240, B=2048), each run to convergence on 1024 lanes
     (every lane converged; against the fp64 CPU run of 256 lanes k within
     one iteration and u within 1e-4 where k is equal), timed at
     fixed_iters=100 (one run), with its peak of allocated memory,
     and profiled twice for its launches and device time an iteration
     (the idle share); a tv_dense_w row that runs out of memory is logged,
     the one failure the phase records rather than raises;
 20. drives the banded backends of HMPC-ADMM, HMPC-ADMM-split,
     HMPC-SADMM-split and MPCT-ADMM-semiband (plain torch on the band
     solve of 19) through make_solver(..., device="cuda"): in fp64 at
     N=30, B=256 against the same solver on the CPU as in 19 (HMPC-ADMM
     sequential and scan, the split pair, semiband hard, soft with a
     constrained output, vector rho and scan); in fp32 at the JAX
     long-horizon record's sizes, HMPC-ADMM-split and MPCT-ADMM-semiband
     at N=480, B=1024, and HMPC-ADMM at N=120, B=4096, each on the dense
     engine, the sequential band solve and the scan, timed, profiled and
     measured as in 19 (aot_memory_analysis beside the allocator's peak
     at N=480); each family's scan run to convergence at N=120 on 1024
     lanes against an fp64 run of the card's dense engine (every lane
     converged, k within the CPU's move, LONG_MOVE); and
     make_solver(backend="auto") with a fresh cache directory on
     laxMPC-ADMM at N=30 (its probe launches K1), HMPC-ADMM-split at N=30
     (K7) and at N=480 (K7's width cap refuses fused at build), each
     choice and probe time logged, a second make_solver served from the
     cache building only the winner, which converges on every lane;
 21. drives the scale-out entry points (spcies_tpu_torch.parallel, every
     shard through its replica's BatchedSolver.__call__): (a) in a fresh
     child process without torchrun's variables initialize() returns False
     and host_chip_mesh() is (1, 1), through which shard_map_solver of the
     headline at B=32768 gives the plain call's bits with one K1 launch,
     which torch.profiler counts (its first session: in this process,
     after phases 16-20's sessions, it has missed the launch); (b) sharded_solver over 4 and 16 logical shards of that
     batch on the one card: each shard the bits of a separate call, k,
     e_flag and u those of the whole batch (exact-k), sharded and whole
     batch timed in turns with CUDA events; (c) a solver built on the CPU
     and replicated to the card gives the card-built solver's bits; (d) a
     child process under torchrun's variables (world of one): initialize()
     takes NCCL, global_fleet_metrics equals fleet_metrics; (e) two child
     processes on the card over gloo, 16384 headline lanes each of their
     own amplitudes: identical global metrics, each process's lanes the
     bits of a local solve, a dense fp64 warm start across the two exits at
     k <= 2; in (d) and (e) no torch.distributed collective is called
     inside a solve and two all_reduce in the metrics; (f) HMPC-SADMM-split
     (K7) at B=8192 on two logical shards: every lane converged, each
     shard's bits; (g) dryrun_multichip(1) and (2, devices=["cuda:0"] * 2);
 22. holds the embedded C beside the card (spcies_tpu_torch.codegen, no
     kernel of csrc/): Problem.generate_c writes and compiles with cc the
     C solvers of laxMPC-ADMM and MPCT-ADMM-cs (T = 10 Q, S = R) at the
     headline horizon (rho 10, tol 1e-4, k_max 1000, relax_alpha 1, which
     the C assumes) into a temporary directory; 1024 lanes of the
     headline's inputs run lane by lane through the C (one thread a core)
     and as one batch through the fp64 dense engine on the card: every
     lane converges in both, k and e_flag agree on >= 0.9985 of lanes,
     and u and z agree within 1e-8 on the lanes with equal k; the cc time,
     the C's median run_time_ms and the card's batch time (CUDA events)
     are logged;
 23. drives the port's surface: (a) the CLI, `python -m spcies_tpu_torch`
     version, help, help codegen and gen --demo for laxMPC and
     MPCT-ADMM-cs as processes, each exiting 0, the generated .c and .h
     equal byte for byte to what generate_embedded_solver writes in this
     process; (b) the six examples examples/torch_t0*.py as processes on
     the card, each exiting 0, their output logged; (c) entry(): finite u
     of shape (256, 2) and k == 10 on every lane, and the fp64 flagship on
     the card against the CPU (k equal, u and z within 1e-9); (d) the
     phase timer on CUDA events at the fused headline (K1, B=32768):
     times_ms's solve and run within 5 % or 0.05 ms of an outside
     CUDA-event bracket of the solve and of the call, no synchronize
     before PhaseTimer.finish, one at it, none in a timing=False request,
     whose result has the timed request's bits; (e) in a fresh process the
     first request's phases against five warm requests', and in another
     the first request's cProfile (top 15), logged.
K1, K2, K3, K4, K5 and K6 run on the product stage csrc/tile_product.cuh;
tools/ab_kernels.py holds their builds to the one-column-per-thread parents
in csrc/variants/, and tools/ab_parent.py each kernel to an earlier tree's
build (ptxas's registers and spills, bits, times in turns).
The line before the card line lists every kernel with its launches on the
main paths, its largest u error against its plain version, its time, its
plain version's time, its bound, and its wide widths' times and bounds
(phase 17) under "wide"; the bound is the larger of the bytes it must move
(inputs read once, outputs written once) over 3.35 TB/s and the fp32
FLOP of its products, counted from each lane's own k (K3's z2 product over
the nd distinct columns of C2m and C2t it computes), over 67 TFLOP/s.
It exits non-zero, with no result line, when there is no CUDA device or
any check fails. The last line is the JSON result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

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
KERNELS = ("fused_admm", "fused_fista", "fused_eadmm", "fused_ellip",
           "fused_soc", "fused_hmpc", "fused_split")
DEVICE = "cuda"
# main() also writes every line to $SPCIES_LOG_DIR/chip_smoke.log where that
# variable names a directory
LOG_FILE = None
# the bench's N=30 families (bench.py:262-288) at its family batch
# (bench.py:207): exact-k, check_every 8, k_max 4000
FB = 8192
FAMILY_K_MAX = 4000
FAMILIES = {
    "laxMPC-FISTA": ("laxMPC", "FISTA", dict(restart=True)),
    "equMPC-FISTA": ("equMPC", "FISTA", {}),
    "equMPC-ADMM": ("equMPC", "ADMM", dict(rho=6.0, relax_alpha=1.8)),
}
# the bench's N=30 MPCT families (bench.py:289-302), T = 10 Q and S = R
MPCT_FAMILIES = {
    "MPCT-EADMM": ("EADMM", "", dict(rho_base=2.0, rho_mult=20.0, tol=TOL,
                                     k_max=5000, tile_b=TILE_B)),
    "MPCT-ADMM-cs": ("ADMM", "cs", dict(rho=2.0, tol=TOL, k_max=4000,
                                        tile_b=TILE_B, check_every=8,
                                        exact_k=True)),
}
# the bench's N=30 ellipMPC families (bench.py:309-326): T diagonalised,
# P = I, c = xr, r = 0.5 (the soc solver's runtime radius on every lane)
R_ELLIP = 0.5
ELLIP_FAMILIES = {
    "ellipMPC-ADMM": ("", dict(rho=5.0, tol=TOL, k_max=4000, tile_b=TILE_B,
                               check_every=8, exact_k=True)),
    "ellipMPC-ADMM-soc": ("soc", dict(rho=5.0, sigma=4.0, tol_p=TOL,
                                      tol_d=TOL, k_max=5000, tile_b=8,
                                      check_every=8)),
}
# the bench's N=30 HMPC families (bench.py:327-375); HMPC-ADMM and
# ellipHMPC-ADMM run plain free-run, which takes tile_b 8 on the card
HMPC_FAMILIES = {
    "HMPC-ADMM": ("HMPC", "ADMM", "", dict(
        rho=5.0, sigma=20.0, tol_p=TOL, tol_d=TOL, k_max=5000, tile_b=8,
        check_every=8)),
    "HMPC-ADMM-split": ("HMPC", "ADMM", "split", dict(
        rho=5.0, sigma=5.0, tol_p=TOL, tol_d=TOL, k_max=4000,
        tile_b=TILE_B, check_every=8, exact_k=True)),
    "HMPC-SADMM-split": ("HMPC", "SADMM", "split", dict(
        rho=5.0, sigma=5.0, tol_p=TOL, tol_d=TOL, k_max=4000,
        tile_b=TILE_B, check_every=8, exact_k=True)),
    "ellipHMPC-ADMM": ("ellipHMPC", "ADMM", "", dict(
        rho=200.0, sigma=0.01, tol_p=TOL, tol_d=TOL, k_max=5000, tile_b=8,
        check_every=8)),
}
# the card's published peaks (H100 SXM, 700 W): fp32 outside the tensor
# cores, and device memory
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12   # dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)
    if LOG_FILE is not None:
        print(msg, file=LOG_FILE, flush=True)


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


def build_kernels():
    """Compile every kernel of csrc/, one nvcc each, all at once; then
    load them and print the compiler's resource report."""
    from spcies_tpu_torch.kernels import _build
    from spcies_tpu_torch.kernels.fused_admm import FUSED_ADMM_ARGTYPES
    from spcies_tpu_torch.kernels.fused_eadmm import FUSED_EADMM_ARGTYPES
    from spcies_tpu_torch.kernels.fused_ellip import FUSED_ELLIP_ARGTYPES
    from spcies_tpu_torch.kernels.fused_fista import FUSED_FISTA_ARGTYPES
    from spcies_tpu_torch.kernels.fused_hmpc import FUSED_HMPC_ARGTYPES
    from spcies_tpu_torch.kernels.fused_soc import FUSED_SOC_ARGTYPES
    from spcies_tpu_torch.kernels.fused_split import FUSED_SPLIT_ARGTYPES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, argtypes, (_lib, rec) in zip(
            KERNELS, (FUSED_ADMM_ARGTYPES, FUSED_FISTA_ARGTYPES,
                      FUSED_EADMM_ARGTYPES, FUSED_ELLIP_ARGTYPES,
                      FUSED_SOC_ARGTYPES, FUSED_HMPC_ARGTYPES,
                      FUSED_SPLIT_ARGTYPES),
            built):
        _build.load_kernel(name, f"{name}_launch", argtypes)
        log(f"kernel build: {name} (nvcc {rec['seconds']:.2f} s, "
            f"cached={rec['cached']})")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"kernel builds: {time.perf_counter() - t0:.2f} s")


def problem(sp, seed: int, B: int, horizon: int = N, plant=None):
    """The bench inputs (bench.py): the tester fixture at N=30 (or
    `horizon`), x0 scaled per lane by a uniform factor in [-2, 2] drawn
    from `seed`. A `plant` (sys, param, x0, xr, ur; `random_plant`) takes
    the fixture's place, its horizon its own and x0 scaled in [-1, 1]."""
    if plant is not None:
        sys_, param30, x, xr, ur = plant
        scale = 1.0
    else:
        sys_, param, st = sp.systems.tester_fixture()
        param30 = dict(param)
        param30["N"] = horizon
        x, xr, ur, scale = st["x"], st["xr"], st["ur"], 2.0
    rng = np.random.default_rng(seed)
    x0 = np.asarray(x)[None, :] * rng.uniform(-scale, scale, (B, 1))
    xr = np.tile(xr, (B, 1))
    ur = np.tile(ur, (B, 1))
    return sys_, param30, (x0, xr, ur)


def headline_options(sp, precision="float", **kw):
    o = sp.default_options("laxMPC", "ADMM", **{**dict(
        rho=RHO, tol=TOL, k_max=K_MAX, relax_alpha=RELAX_ALPHA), **kw})
    o.precision = precision
    return o


def fused_solver(sp, device="cuda", horizon=N, backend="fused", plant=None,
                 **kw):
    sys_, param30, _ = problem(sp, 0, 1, horizon, plant)
    return sp.make_solver(sys_, param30, formulation="laxMPC",
                          method="ADMM", options=headline_options(sp, **kw),
                          backend=backend, device=device)


def kernel_args(solver, inputs, fixed_iters=0):
    """The kernel's exact arguments for one call of the fused solver."""
    from spcies_tpu_torch.api import broadcast_inputs
    x = broadcast_inputs(torch.float32, solver.device, *inputs)
    z1p, v0p, lam0p, _order, _b = solver.raw_fn.prepare(*x)
    kw = dict(solver.raw_fn.kernel_kw, fixed_iters=fixed_iters)
    return (z1p, v0p, lam0p, *solver.raw_fn.operator), kw


def agreement(out_k, out_p, B, m, fixed, u_at=1, k_at=3, u_off=0):
    """k agreement and max |u_kernel - u_plain| over lanes with equal k;
    u is entries u_off..u_off+m of output u_at, k and e_flag are outputs
    k_at and k_at + 1."""
    k_k, k_p = out_k[k_at][:B], out_p[k_at][:B]
    same = k_k == k_p
    u = slice(u_off, u_off + m)
    du = (out_k[u_at][:B, u] - out_p[u_at][:B, u]).abs().amax(dim=1)
    return dict(
        k_agree=float(same.float().mean()),
        conv_kernel=float((out_k[k_at + 1][:B] == 1).float().mean()),
        conv_plain=float((out_p[k_at + 1][:B] == 1).float().mean()),
        u_err=float(du[same].max()) if bool(same.any()) else float("inf"),
        k_mean=float(k_k.float().mean()), fixed=fixed)


def check_agreement(name, a, phase=1):
    log(f"phase {phase} {name}: " + json.dumps(a))
    if not a["fixed"]:
        assert a["conv_kernel"] == 1.0 and a["conv_plain"] == 1.0, name
    assert a["k_agree"] >= K_AGREE, (name, a["k_agree"])
    assert a["u_err"] <= U_TOL, (name, a["u_err"])


@contextmanager
def without_refill():
    """kernels/stage.py plans every launch without refill while the
    context lasts (a check of bits: each block keeps its L lanes)."""
    from spcies_tpu_torch.kernels import stage
    plan = stage.plan
    stage.plan = lambda *a, refill, **kw: plan(*a, refill=False, **kw)
    try:
        yield
    finally:
        stage.plan = plan


def check_lanes_bitwise(solve, args, kk, B, name, phase=1, refill=False):
    """Run a kernel whose wrapper takes `lanes=` (K1, K5-K7) at every
    number of lanes a block whose build takes this shape (with `refill`,
    each also planned without refill: K7, which refills in every mode), and
    hold the builds to the first one, 8 lanes a block as planned, bit for
    bit: every output (iterates, k, e_flag, residuals) equal on every
    lane."""
    outs = {}
    for L, plain_blocks in [(L, off) for off in (False, True)[:1 + refill]
                            for L in (8, 16, 32)]:
        try:
            with without_refill() if plain_blocks else nullcontext():
                out = solve(*args, **kk, lanes=L)
        except ValueError as e:     # no build of L lanes takes the shape
            if "no build" not in str(e):
                raise
            continue
        plan = solve.last_plan
        assert plan["lanes"] == L
        outs[f"{L}" + (f" refill={plan['refill']}" if refill else "")] = out
    torch.cuda.synchronize()
    first = next(iter(outs.values()))
    assert len(outs) > 1 and next(iter(outs)).startswith("8"), list(outs)
    for key, out in outs.items():
        same = all(bool(torch.equal(a[:B], b[:B]))
                   for a, b in zip(out, first))
        assert same, (name, key)
    log(f"phase {phase} {name}: builds {list(outs)} bit-identical")


def check_builds(solve, args, kk, B, name, phase, out_p, m, fixed, u_at,
                 **where):
    """Run a kernel whose wrapper takes `lanes=` (K2, K3, K4) at every
    number of lanes a block whose build takes this shape: hold each build to
    the plain version's outputs `out_p` (check_agreement; `where` holds
    agreement's k_at and u_off) and to the 8-lane build bit for bit
    (check_lanes_bitwise). Returns the largest u error."""
    u_err = 0.0
    for L in (8, 16, 32):
        try:
            out = solve(*args, **kk, lanes=L)
        except ValueError as e:     # no build of L lanes takes the shape
            if "no build" not in str(e):
                raise
            continue
        torch.cuda.synchronize()
        a = agreement(out, out_p, B, m, fixed, u_at=u_at, **where)
        check_agreement(f"{name} lanes={L}", a, phase)
        u_err = max(u_err, a["u_err"])
    check_lanes_bitwise(solve, args, kk, B, name, phase)
    return u_err


def iterations(k, solve, lanes=8):
    """The mean k of a launch's 8-lane groups (each its slowest lane's),
    and the mean and largest count of its blocks' iterations: the kernel's
    own count where it keeps one (K1 and K7 in every mode, with their
    lane-iterations and the lanes' k's share of them, `lane_use`; K4-K6
    with refill), else each block's slowest lane's k, an estimate that
    misses exact-k's windows past a lane's exit and their replay (K2, K3,
    K4-K6 without refill, which count nothing). `solve` is the wrapper of
    the last launch; one without `last_plan` runs `lanes` lanes a
    block."""
    plan = getattr(solve, "last_plan", None) or dict(lanes=lanes,
                                                       refill=False)
    refill = plan.get("refill", False)
    counted = refill or "block_lane_iterations" in plan
    groups = k.reshape(-1, 8).amax(dim=1).float()
    blocks = (plan["block_iterations"].float() if counted
              else k.reshape(-1, plan["lanes"]).amax(dim=1).float())
    out = dict(lanes=plan["lanes"], refill=refill,
               block_iterations_counted=counted,
               group_k_mean=float(groups.mean()),
               block_iterations_mean=float(blocks.mean()),
               block_iterations_max=float(blocks.max()))
    if "block_lane_iterations" in plan:
        ran = float(plan["block_lane_iterations"].double().sum())
        out.update(lane_iterations=ran,
                   lane_use=float(k.double().sum()) / ran if ran else None)
    return out


def plan_of(solve) -> dict:
    """The last launch's plan of `solve`, without its count tensors."""
    return {key: v for key, v in solve.last_plan.items()
            if not torch.is_tensor(v)}


def phase_kernel_vs_plain(sp):
    """Kernel and plain version on the same CUDA tensors. Returns the
    headline comparison and the headline plain outputs."""
    from spcies_tpu_torch.kernels import fused_admm as k1
    exact = dict(tile_b=TILE_B, check_every=CHECK_EVERY, exact_k=True)
    modes = [
        ("headline exact-k B=32768", BATCH, 0, exact),
        ("checked B=4096", SMALL_BATCH, 0, dict(tile_b=TILE_B)),
        ("free-run B=4096", SMALL_BATCH, 0,
         dict(tile_b=8, check_every=CHECK_EVERY)),
        ("fixed_iters=50 B=4096", SMALL_BATCH, 50, dict(tile_b=TILE_B)),
        ("relax_alpha=1 exact-k B=4096", SMALL_BATCH, 0,
         dict(exact, relax_alpha=1.0)),
        ("MPCT-ADMM-cs exact-k B=8192", FB, 0, None),
        ("bf16 exact-k B=4096", SMALL_BATCH, 0,
         dict(exact, bf16_delta=True)),
        ("bf16 exact-k B=32768", BATCH, 0, dict(exact, bf16_delta=True)),
    ]
    head = None
    for name, B, fixed, kw in modes:
        solver = (mpct_solver(sp, "MPCT-ADMM-cs") if kw is None
                  else fused_solver(sp, **kw))
        _, _, inputs = problem(sp, 0, B)
        args, kk = kernel_args(solver, inputs, fixed)
        out_k = k1.fused_admm_solve(*args, **kk)
        torch.cuda.synchronize()
        out_p = k1.fused_admm_reference(*args, **kk)
        torch.cuda.synchronize()
        # MPCT-ADMM-cs keeps u elsewhere in v: hold all of v together
        m = solver.nz if kw is None else solver.m
        a = agreement(out_k, out_p, B, m, bool(fixed))
        check_agreement(name, a)
        if not kk["bf16"]:
            check_lanes_bitwise(k1.fused_admm_solve, args, kk, B, name)
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
                         options=headline_options(sp, precision="double"),
                         device="cpu")
    r64 = ref(*small)
    r32 = solver(*small)
    err = float((r32.u.cpu().double() - r64.u).abs().max())
    log(f"phase 2 fused fp32 (cuda) vs dense fp64 (cpu), B=64: "
        f"max|du|={err}")
    assert bool((r64.e_flag == 1).all()) and bool((r32.e_flag == 1).all())
    assert err <= U_TOL_FP64, err
    return launches, solver


def cuda_ms(fn, reps=1, warm=True):
    if warm:
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


def in_turns(kernel, plain, dense=None, reps=5):
    """A kernel, its plain version and, if given, a dense engine in turns
    (plain, kernel, kernel, plain, dense, dense), each a CUDA-event mean,
    the kernel's over `reps` calls. Each kernel measurement follows a
    warm-up call; the plain version and the dense engine, host-bound
    loops of small launches, are warmed once, before their first
    measurement. Returns the times and the dense engine's warm-up result
    (None without one)."""
    t = {"plain": [cuda_ms(plain)], "kernel": []}
    for _ in range(2):
        t["kernel"].append(cuda_ms(kernel, reps=reps))
    t["plain"].append(cuda_ms(plain, warm=False))
    res = None
    if dense is not None:
        res = dense()
        t["dense"] = [cuda_ms(dense, warm=False) for _ in range(2)]
    return t, res


def roofline(tensors, flops):
    """(bound ms, what bounds it): the least time the card could take for
    a call that reads each input once, writes each output once and does
    `flops` fp32 operations."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return ((t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations"))


def iter_flops(k, per_iter):
    """FLOP of a batch's products: each lane's own k times the FLOP of one
    iteration's products."""
    return float(k.double().sum()) * per_iter


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
    t, res = in_turns(kernel, plain, dense_fn)
    log(f"phase 3 dense fp32 engine: k_mean={float(res.k.float().mean())} "
        f"converged={float((res.e_flag == 1).float().mean())}")
    log("phase 3 times (ms per B=32768 solve, CUDA events): "
        + json.dumps(t))
    out = kernel()
    nz = fused.nz
    k = out[3][:BATCH].long()
    it = iterations(k, fused_admm_solve)
    bound = roofline(args + out, iter_flops(k, 2.0 * nz * nz))
    log(f"phase 3 kernel: k_mean={float(k.float().mean())} "
        f"{json.dumps(it)} plan={plan_of(fused_admm_solve)}")
    log(f"phase 3 bound: {bound}")
    # the bf16 mode at the same shape; its operations are bf16 products, so
    # its bound takes the tensor cores' bf16 peak
    bf = fused_solver(sp, tile_b=TILE_B, check_every=CHECK_EVERY,
                      exact_k=True, bf16_delta=True)
    bargs, bkk = kernel_args(bf, inputs)
    t_bf = {"kernel": [], "plain": []}
    for key, fn in (("plain", fused_admm_reference),
                    ("kernel", fused_admm_solve),
                    ("kernel", fused_admm_solve),
                    ("plain", fused_admm_reference)):
        t_bf[key].append(cuda_ms(lambda: fn(*bargs, **bkk),
                                 reps=5 if key == "kernel" else 1))
    bout = fused_admm_solve(*bargs, **bkk)
    nbytes = sum(x.numel() * x.element_size() for x in bargs + bout)
    bf_flops = iter_flops(bout[3][:BATCH], 2.0 * nz * nz)
    bf_bound = max(nbytes / PEAK_BYTES, bf_flops / PEAK_BF16) * 1e3
    log(f"phase 3 bf16 mode times (ms per B={BATCH} solve, CUDA events): "
        f"{json.dumps(t_bf)} k_mean={float(bout[3].float().mean())} "
        f"plan={plan_of(fused_admm_solve)} bound (bf16 products at 989 "
        f"TFLOP/s)={bf_bound} ms")
    return dict({key: min(v) for key, v in t.items()}, bound=bound,
                bf16=dict(kernel=min(t_bf["kernel"]),
                          plain=min(t_bf["plain"]), bound=bf_bound))


def family_solver(sp, name, backend="fused", device=None,
                  precision="float", horizon=N, plant=None, **kw):
    """A solver of one of the bench's N=30 families: the tester fixture
    with T diagonalised for laxMPC-FISTA (bench.py:270-271) and dropped
    for equMPC (bench.py:277-278)."""
    formulation, method, extra = FAMILIES[name]
    sys_, param30, _ = problem(sp, 0, 1, horizon, plant)
    p = dict(param30)
    if formulation == "laxMPC":
        p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    else:
        p.pop("T", None)
    o = sp.default_options(formulation, method, **{
        **dict(tol=TOL, k_max=FAMILY_K_MAX, tile_b=TILE_B, check_every=8,
               exact_k=True), **extra, **kw})
    o.precision = precision
    return sp.make_solver(sys_, p, formulation=formulation, method=method,
                          options=o, backend=backend,
                          device=device or DEVICE)


def fista_kernel_args(solver, inputs, fixed_iters=0):
    """The FISTA kernel's exact arguments for one call of a fused
    solver."""
    from spcies_tpu_torch.api import broadcast_inputs
    x = broadcast_inputs(torch.float32, solver.device, *inputs)
    *kin, _b = solver.raw_fn.prepare(*x)
    kw = dict(solver.raw_fn.kernel_kw, fixed_iters=fixed_iters)
    return (*kin, *solver.raw_fn.operator), kw


def fista_modes():
    """Phase 4's runs: (label, family, B, fixed_iters, solver options)."""
    lax, equ = "laxMPC-FISTA", "equMPC-FISTA"
    return [
        (f"{lax} exact-k B={FB}", lax, FB, 0, {}),
        (f"{equ} exact-k B={FB}", equ, FB, 0, {}),
        (f"{lax} checked B={SMALL_BATCH}", lax, SMALL_BATCH, 0,
         dict(check_every=1, exact_k=False)),
        (f"{lax} free-run B={SMALL_BATCH}", lax, SMALL_BATCH, 0,
         dict(tile_b=8, exact_k=False)),
        (f"{lax} fixed_iters=50 B={SMALL_BATCH}", lax, SMALL_BATCH, 50, {}),
        (f"{lax} exact-k B={SMALL_BATCH}", lax, SMALL_BATCH, 0, {}),
        (f"{lax} exact-k no restart B={SMALL_BATCH}", lax, SMALL_BATCH, 0,
         dict(restart=False)),
    ]


def phase_fista_kernel_vs_plain(sp):
    """The FISTA kernel and its plain version on the same CUDA tensors, at
    every number of lanes a block its builds take. Returns the largest u
    error over the modes."""
    from spcies_tpu_torch.kernels.fused_fista import (fused_fista_reference,
                                                      fused_fista_solve)
    u_err = 0.0
    for label, name, B, fixed, kw in fista_modes():
        solver = family_solver(sp, name, **kw)
        _, _, inputs = problem(sp, 0, B)
        args, kk = fista_kernel_args(solver, inputs, fixed)
        out_k = fused_fista_solve(*args, **kk)
        torch.cuda.synchronize()
        out_p = fused_fista_reference(*args, **kk)
        torch.cuda.synchronize()
        a = agreement(out_k, out_p, B, solver.m, bool(fixed), u_at=0)
        check_agreement(label, a, phase=4)
        u_err = max(u_err, a["u_err"], check_builds(
            fused_fista_solve, args, kk, B, label, 4, out_p, solver.m,
            bool(fixed), 0))
    return u_err


def phase_family_paths(sp):
    """The slice's three paths, each through make_solver(...,
    backend='fused'): a request and a warm start from it, each launching
    its kernel once; then a small batch against the fp64 dense engine on
    the CPU. Returns the launches of each kernel."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.kernels.fused_fista import fused_fista_solve
    counters = {"fused_admm": fused_admm_solve,
                "fused_fista": fused_fista_solve}
    launches = dict.fromkeys(counters, 0)
    for name in FAMILIES:
        kernel = "fused_admm" if name.endswith("ADMM") else "fused_fista"
        solver = family_solver(sp, name)
        _, _, inputs = problem(sp, 0, FB)
        for c in counters.values():
            c.launches = 0
        cold = solver(*inputs)
        torch.cuda.synchronize()
        after_cold = counters[kernel].launches
        init = ((cold.sol["lam"],) if kernel == "fused_fista"
                else (cold.sol["z"], cold.sol["v"], cold.sol["lam"]))
        warm = solver(*inputs, init=init)
        torch.cuda.synchronize()
        counts = {key: c.launches for key, c in counters.items()}
        for tag, res in (("seed 0", cold), ("seed 0 warm", warm)):
            log(f"phase 5 {name} request {tag}: "
                f"k_mean={float(res.k.float().mean())} "
                f"k_max={int(res.k.max())} "
                f"converged={float((res.e_flag == 1).float().mean())} "
                f"times_ms={res.sol['times_ms']}")
            assert tuple(res.u.shape) == (FB, solver.m), res.u.shape
            assert res.u.device.type == DEVICE
            assert bool(torch.isfinite(res.u).all()), name
            assert bool((res.e_flag == 1).all()), (name, tag)
        assert after_cold == 1 and counts[kernel] == 2, (name, counts)
        assert sum(counts.values()) == 2, (name, counts)
        assert float(warm.k.float().mean()) < float(cold.k.float().mean())
        launches[kernel] += counts[kernel]

        _, _, small = problem(sp, 5, 64)
        r64 = family_solver(sp, name, backend="dense", device="cpu",
                            precision="double")(*small)
        r32 = solver(*small)
        err = float((r32.u.cpu().double() - r64.u).abs().max())
        log(f"phase 5 {name} fused fp32 ({DEVICE}) vs dense fp64 (cpu), "
            f"B=64: max|du|={err}")
        assert bool((r64.e_flag == 1).all()) and bool((r32.e_flag == 1).all())
        assert err <= U_TOL_FP64, (name, err)
    return launches


def phase_family_times(sp):
    """The FISTA kernel, its plain version and the fp32 dense FISTA engine
    for laxMPC-FISTA at B=8192 and 32768, and the equMPC-ADMM fused solve
    at 8192, in turns, each a CUDA-event mean. Returns the minima."""
    from spcies_tpu_torch.kernels.fused_fista import (fused_fista_reference,
                                                      fused_fista_solve)
    out = {}
    for B in (FB, BATCH):
        fused = family_solver(sp, "laxMPC-FISTA")
        dense = family_solver(sp, "laxMPC-FISTA", backend="dense")
        dense.options.timing = False
        _, _, inputs = problem(sp, 0, B)
        args, kk = fista_kernel_args(fused, inputs)
        x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
             for a in inputs]
        kernel = lambda: fused_fista_solve(*args, **kk)  # noqa: E731
        plain = lambda: fused_fista_reference(*args, **kk)  # noqa: E731
        dense_fn = lambda: dense(*x)  # noqa: E731
        t, res = in_turns(kernel, plain, dense_fn)
        log(f"phase 6 laxMPC-FISTA dense fp32 engine B={B}: "
            f"k_mean={float(res.k.float().mean())} "
            f"converged={float((res.e_flag == 1).float().mean())}")
        log(f"phase 6 laxMPC-FISTA times (ms per B={B} solve, CUDA "
            f"events): " + json.dumps(t))
        res = kernel()
        nz, nlam = fused.nz, fused.raw_fn.nlam
        k = res[3][:B].long()
        bound = roofline(args + res, iter_flops(
            k, 2.0 * (2 * nz * nlam + nlam * nlam)))
        log(f"phase 6 laxMPC-FISTA kernel B={B}: k_mean="
            f"{float(k.float().mean())} k_max={int(k.max())} "
            f"{json.dumps(iterations(k, fused_fista_solve))} bound={bound}")
        out[B] = dict({key: min(v) for key, v in t.items()}, bound=bound)
    eq = family_solver(sp, "equMPC-ADMM")
    eq.options.timing = False
    _, _, inputs = problem(sp, 0, FB)
    x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
         for a in inputs]
    t_eq = [cuda_ms(lambda: eq(*x), reps=3) for _ in range(2)]
    log(f"phase 6 equMPC-ADMM fused solve (ms per B={FB} solve, CUDA "
        f"events): {json.dumps(t_eq)}")
    out["equMPC-ADMM"] = min(t_eq)
    return out


def mpct_solver(sp, name, backend="fused", device=None, precision="float",
                horizon=N, plant=None, **kw):
    """A solver of one of the bench's N=30 MPCT families (or at
    `horizon`)."""
    method, submethod, base = MPCT_FAMILIES[name]
    sys_, param30, _ = problem(sp, 0, 1, horizon, plant)
    p = dict(param30)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    o = sp.default_options("MPCT", method, submethod, **{**base, **kw})
    o.precision = precision
    return sp.make_solver(sys_, p, formulation="MPCT", method=method,
                          submethod=submethod, options=o, backend=backend,
                          device=device or DEVICE)


def eadmm_kernel_args(solver, inputs):
    """The EADMM kernel's exact arguments for one call of a fused
    solver."""
    from spcies_tpu_torch.api import broadcast_inputs
    x = broadcast_inputs(torch.float32, solver.device, *inputs)
    *kin, _b = solver.raw_fn.prepare(*x)
    return (*kin, *solver.raw_fn.operator), dict(solver.raw_fn.kernel_kw)


def eadmm_modes():
    """Phase 7's runs: (label, B, capped, solver options)."""
    return [
        (f"checked B={FB}", FB, False, {}),
        (f"free-run B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(check_every=8, tile_b=8)),
        (f"exact-k B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(check_every=8, exact_k=True)),
        (f"exact-k capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, True,
         dict(check_every=8, exact_k=True, tol=1e-13, k_max=19)),
    ]


def phase_eadmm_kernel_vs_plain(sp):
    """The EADMM kernel and its plain version on the same CUDA tensors, at
    the dispatch's build and at each number of lanes a block its builds
    take (8 and 16), every build held to the plain version and to the
    8-lane build bit for bit. Returns the largest u error over the
    modes."""
    from spcies_tpu_torch.kernels.fused_eadmm import (fused_eadmm_reference,
                                                      fused_eadmm_solve)
    name = "MPCT-EADMM"
    u_err = 0.0
    for label, B, capped, kw in eadmm_modes():
        solver = mpct_solver(sp, name, **kw)
        _, _, inputs = problem(sp, 0, B)
        args, kk = eadmm_kernel_args(solver, inputs)
        out_k = fused_eadmm_solve(*args, **kk)
        torch.cuda.synchronize()
        out_p = fused_eadmm_reference(*args, **kk)
        torch.cuda.synchronize()
        where = dict(k_at=5, u_off=solver.n)
        a = agreement(out_k, out_p, B, solver.m, capped, u_at=0, **where)
        check_agreement(f"{name} {label}", a, phase=7)
        if capped:
            assert bool((out_k[5][:B] == 19).all()), "capped k"
        u_err = max(u_err, a["u_err"], check_builds(
            fused_eadmm_solve, args, kk, B, f"{name} {label}", 7, out_p,
            solver.m, capped, 0, **where))
    return u_err


def phase_mpct_paths(sp):
    """The two MPCT paths, each through make_solver(..., backend='fused'):
    a request and a warm start from it, each launching its kernel once;
    then a small batch against the fp64 dense engine on the CPU. Returns
    the launches of each kernel."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.kernels.fused_eadmm import fused_eadmm_solve
    from spcies_tpu_torch.kernels.fused_fista import fused_fista_solve
    counters = {"fused_admm": fused_admm_solve,
                "fused_fista": fused_fista_solve,
                "fused_eadmm": fused_eadmm_solve}
    launches = dict.fromkeys(counters, 0)
    for name in MPCT_FAMILIES:
        eadmm = name == "MPCT-EADMM"
        kernel = "fused_eadmm" if eadmm else "fused_admm"
        solver = mpct_solver(sp, name)
        _, _, inputs = problem(sp, 0, FB)
        for c in counters.values():
            c.launches = 0
        cold = solver(*inputs)
        torch.cuda.synchronize()
        after_cold = counters[kernel].launches
        keys = ("z1", "z2", "z3", "lam") if eadmm else ("z", "v", "lam")
        warm = solver(*inputs, init=tuple(cold.sol[key] for key in keys))
        torch.cuda.synchronize()
        counts = {key: c.launches for key, c in counters.items()}
        for tag, res in (("seed 0", cold), ("seed 0 warm", warm)):
            log(f"phase 8 {name} request {tag}: "
                f"k_mean={float(res.k.float().mean())} "
                f"k_max={int(res.k.max())} "
                f"converged={float((res.e_flag == 1).float().mean())} "
                f"times_ms={res.sol['times_ms']}")
            assert tuple(res.u.shape) == (FB, solver.m), res.u.shape
            assert res.u.device.type == DEVICE
            assert bool(torch.isfinite(res.u).all()), name
            assert bool((res.e_flag == 1).all()), (name, tag)
        assert after_cold == 1 and counts[kernel] == 2, (name, counts)
        assert sum(counts.values()) == 2, (name, counts)
        assert float(warm.k.float().mean()) < float(cold.k.float().mean())
        launches[kernel] += counts[kernel]

        _, _, small = problem(sp, 5, 64)
        r64 = mpct_solver(sp, name, backend="dense", device="cpu",
                          precision="double")(*small)
        r32 = solver(*small)
        err = float((r32.u.cpu().double() - r64.u).abs().max())
        log(f"phase 8 {name} fused fp32 ({DEVICE}) vs dense fp64 (cpu), "
            f"B=64: max|du|={err}")
        assert bool((r64.e_flag == 1).all()) and bool((r32.e_flag == 1).all())
        assert err <= U_TOL_FP64, (name, err)
    return launches


def phase_mpct_times(sp):
    """The EADMM kernel, its plain version and the fp32 dense EADMM engine
    at B=8192 and 32768, and the MPCT-ADMM-cs fused solve and its fp32
    dense engine at 8192, in turns, each a CUDA-event mean. Returns the
    minima."""
    from spcies_tpu_torch.kernels.fused_eadmm import (fused_eadmm_reference,
                                                      fused_eadmm_solve)
    out = {}
    for B in (FB, BATCH):
        fused = mpct_solver(sp, "MPCT-EADMM")
        dense = mpct_solver(sp, "MPCT-EADMM", backend="dense")
        dense.options.timing = False
        _, _, inputs = problem(sp, 0, B)
        args, kk = eadmm_kernel_args(fused, inputs)
        x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
             for a in inputs]
        classes = fused.raw_fn.classes
        kernel = lambda: fused_eadmm_solve(  # noqa: E731
            *args, **kk, classes=classes)
        plain = lambda: fused_eadmm_reference(*args, **kk)  # noqa: E731
        dense_fn = lambda: dense(*x)  # noqa: E731
        t, res = in_turns(kernel, plain, dense_fn)
        log(f"phase 9 MPCT-EADMM dense fp32 engine B={B}: "
            f"k_mean={float(res.k.float().mean())} "
            f"converged={float((res.e_flag == 1).float().mean())}")
        log(f"phase 9 MPCT-EADMM times (ms per B={B} solve, CUDA "
            f"events): " + json.dumps(t))
        res = kernel()
        torch.cuda.synchronize()
        nz1, nm = fused.raw_fn.nz1, fused.raw_fn.nm
        nd = fused_eadmm_solve.last_plan["nd"]
        # the products' FLOP an iteration and lane: as the parent counts
        # them (C2m and M3p nz1 x nz1, C2t's nm tail rows), and recounted
        # with C2m and C2t over their nd distinct columns, as the kernel
        # does them
        full = roofline(args + res, iter_flops(
            res[5][:B], 2.0 * (2 * nz1 * nz1 + nm * nz1)))
        bound = roofline(args[:6] + classes + args[8:] + res, iter_flops(
            res[5][:B], 2.0 * (nz1 * nd + nz1 * nz1 + nm * nd)))
        log(f"phase 9 MPCT-EADMM B={B}: k_mean="
            f"{float(res[5][:B].float().mean())} "
            f"{json.dumps(iterations(res[5][:B], fused_eadmm_solve))} "
            f"nd={nd} bound={bound} bound_all_columns={full}")
        out[B] = dict({key: min(v) for key, v in t.items()}, bound=bound,
                      bound_all_columns=full)
    _, _, inputs = problem(sp, 0, FB)
    x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
         for a in inputs]
    t = {}
    for backend in ("fused", "dense", "fused", "dense"):
        s = mpct_solver(sp, "MPCT-ADMM-cs", backend=backend)
        s.options.timing = False
        t.setdefault(backend, []).append(cuda_ms(lambda: s(*x)))
    log(f"phase 9 MPCT-ADMM-cs times (ms per B={FB} solve, CUDA events): "
        + json.dumps(t))
    out["MPCT-ADMM-cs"] = {key: min(v) for key, v in t.items()}
    return out


def ellip_solver(sp, name, backend="fused", device=None, precision="float",
                 spd_seed=None, horizon=N, plant=None, **kw):
    """A solver of one of the bench's N=30 ellipMPC families; `device`
    None leaves it to make_solver's default, the card. spd_seed draws a
    random SPD P and a centre c != xr from that seed."""
    submethod, base = ELLIP_FAMILIES[name]
    sys_, param30, (_, xr, _) = problem(sp, 0, 1, horizon, plant)
    n = xr.shape[1]
    p = dict(param30)
    p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    p["P"] = np.eye(n)
    p["c"] = xr[0].copy()
    p.setdefault("r", R_ELLIP)
    if spd_seed is not None:
        rng = np.random.default_rng(spd_seed)
        L = rng.normal(0.0, 0.5, (n, n))
        p["P"] = L @ L.T + 0.5 * np.eye(n)
        p["c"] = xr[0] + rng.normal(0.0, 0.2, n)
    o = sp.default_options("ellipMPC", "ADMM", submethod, **{**base, **kw})
    o.precision = precision
    where = {} if device is None else dict(device=device)
    return sp.make_solver(sys_, p, formulation="ellipMPC", method="ADMM",
                          submethod=submethod, options=o, backend=backend,
                          **where)


def ellip_inputs(sp, name, seed, B, radius=None, plant=None):
    """The bench inputs of `problem`, with the soc solver's runtime radius
    (R_ELLIP on every lane, or the given [B, 1] radii) as the 4th."""
    _, param, inputs = problem(sp, seed, B, plant=plant)
    if ELLIP_FAMILIES[name][0] == "soc":
        r = param.get("r", R_ELLIP)
        inputs = inputs + ((np.full((B, 1), r) if radius is None
                            else radius),)
    return inputs


def ellip_kernel_args(solver, inputs, fixed_iters=0):
    """The K4 or K5 kernel's exact arguments for one call of a fused
    solver."""
    from spcies_tpu_torch.api import broadcast_inputs
    x = broadcast_inputs(torch.float32, solver.device, *inputs)
    *kin, _b = solver.raw_fn.prepare(*x)
    kw = dict(solver.raw_fn.kernel_kw)
    if fixed_iters:
        kw["fixed_iters"] = fixed_iters
    return (*kin, *solver.raw_fn.operator), kw


def ellip_modes():
    """Phase 10's runs: (family, label, B, fixed_iters, capped, solver
    options, input options)."""
    adm, soc = "ellipMPC-ADMM", "ellipMPC-ADMM-soc"
    radii = np.random.default_rng(7).uniform(0.1, 1.0, (SMALL_BATCH, 1))
    capped = dict(tol=1e-13, k_max=19)
    capped_soc = dict(tol_p=1e-13, tol_d=1e-13, k_max=19, tile_b=TILE_B,
                      exact_k=True)
    modes = [
        (adm, f"exact-k B={FB}", FB, 0, False, {}, {}),
        (adm, f"checked B={SMALL_BATCH}", SMALL_BATCH, 0, False,
         dict(check_every=1, exact_k=False), {}),
        (adm, f"free-run B={SMALL_BATCH}", SMALL_BATCH, 0, False,
         dict(tile_b=8, exact_k=False), {}),
        (adm, f"fixed_iters=50 B={SMALL_BATCH}", SMALL_BATCH, 50, True, {},
         {}),
        (adm, f"exact-k capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, 0, True, capped, {}),
        (adm, f"exact-k random SPD P, c != xr B={SMALL_BATCH}", SMALL_BATCH,
         0, False, dict(spd_seed=11), {}),
        (soc, f"free-run B={FB}", FB, 0, False, {}, {}),
        (soc, f"checked B={SMALL_BATCH}", SMALL_BATCH, 0, False,
         dict(check_every=1, tile_b=TILE_B), {}),
        (soc, f"exact-k B={SMALL_BATCH}", SMALL_BATCH, 0, False,
         dict(tile_b=TILE_B, exact_k=True), {}),
        (soc, f"exact-k capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, 0, True, capped_soc, {}),
        (soc, f"free-run capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, 0, True, dict(tol_p=1e-13, tol_d=1e-13, k_max=19),
         {}),
        (soc, f"free-run per-lane radius in [0.1, 1] B={SMALL_BATCH}",
         SMALL_BATCH, 0, False, {}, dict(radius=radii)),
    ]
    return modes


def phase_ellip_kernel_vs_plain(sp):
    """K4 and K5 against their plain versions on the same CUDA tensors, K4
    at every number of lanes a block its builds take, and both kernels'
    builds against each other. Returns the largest u error of each kernel
    over its modes."""
    from spcies_tpu_torch.kernels import fused_ellip as k4
    from spcies_tpu_torch.kernels import fused_soc as k5
    adm = "ellipMPC-ADMM"
    u_err = {"fused_ellip": 0.0, "fused_soc": 0.0}
    for name, label, B, fixed, cut, kw, extra in ellip_modes():
        solver = ellip_solver(sp, name, device=DEVICE, **kw)
        inputs = ellip_inputs(sp, name, 0, B, **extra)
        args, kk = ellip_kernel_args(solver, inputs, fixed)
        if name == adm:
            key, kern, plain, u_at = ("fused_ellip", k4.fused_ellip_solve,
                                      k4.fused_ellip_reference, 1)
        else:
            key, kern, plain, u_at = ("fused_soc", k5.fused_soc_solve,
                                      k5.fused_soc_reference, 0)
        out_k = kern(*args, **kk)
        torch.cuda.synchronize()
        out_p = plain(*args, **kk)
        torch.cuda.synchronize()
        a = agreement(out_k, out_p, B, solver.m, cut, u_at=u_at)
        check_agreement(f"{name} {label}", a, phase=10)
        if "capped" in label:
            assert bool((out_k[3][:B] == 19).all()), "capped k"
        if key == "fused_soc":
            check_lanes_bitwise(kern, args, kk, B, f"{name} {label}", 10)
        else:
            a["u_err"] = max(a["u_err"], check_builds(
                kern, args, kk, B, f"{name} {label}", 10, out_p, solver.m,
                cut, u_at))
        u_err[key] = max(u_err[key], a["u_err"])
    return u_err


def phase_ellip_paths(sp):
    """The two ellipMPC paths, each through make_solver(...,
    backend='fused') with the device left to its default: a request and a
    warm start from it, each launching its kernel once and no other; then
    a small batch against the fp64 dense engine on the CPU. Returns the
    launches of each kernel."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.kernels.fused_eadmm import fused_eadmm_solve
    from spcies_tpu_torch.kernels.fused_ellip import fused_ellip_solve
    from spcies_tpu_torch.kernels.fused_fista import fused_fista_solve
    from spcies_tpu_torch.kernels.fused_soc import fused_soc_solve
    counters = {"fused_admm": fused_admm_solve,
                "fused_fista": fused_fista_solve,
                "fused_eadmm": fused_eadmm_solve,
                "fused_ellip": fused_ellip_solve,
                "fused_soc": fused_soc_solve}
    launches = dict.fromkeys(counters, 0)
    for name, (submethod, _) in ELLIP_FAMILIES.items():
        kernel = "fused_soc" if submethod == "soc" else "fused_ellip"
        solver = ellip_solver(sp, name)
        assert solver.device.type == DEVICE, solver.device
        inputs = ellip_inputs(sp, name, 0, FB)
        for c in counters.values():
            c.launches = 0
        cold = solver(*inputs)
        torch.cuda.synchronize()
        after_cold = counters[kernel].launches
        keys = ("z", "s", "lam", "mu") if submethod else ("z", "v", "lam")
        warm = solver(*inputs, init=tuple(cold.sol[key] for key in keys))
        torch.cuda.synchronize()
        counts = {key: c.launches for key, c in counters.items()}
        for tag, res in (("seed 0", cold), ("seed 0 warm", warm)):
            log(f"phase 11 {name} request {tag}: "
                f"k_mean={float(res.k.float().mean())} "
                f"k_max={int(res.k.max())} "
                f"converged={float((res.e_flag == 1).float().mean())} "
                f"times_ms={res.sol['times_ms']}")
            assert tuple(res.u.shape) == (FB, solver.m), res.u.shape
            assert res.u.device.type == DEVICE
            assert bool(torch.isfinite(res.u).all()), name
            assert bool((res.e_flag == 1).all()), (name, tag)
        assert after_cold == 1 and counts[kernel] == 2, (name, counts)
        assert sum(counts.values()) == 2, (name, counts)
        assert float(warm.k.float().mean()) < float(cold.k.float().mean())
        launches[kernel] += counts[kernel]

        small = ellip_inputs(sp, name, 5, 64)
        r64 = ellip_solver(sp, name, backend="dense", device="cpu",
                           precision="double")(*small)
        r32 = solver(*small)
        err = float((r32.u.cpu().double() - r64.u).abs().max())
        log(f"phase 11 {name} fused fp32 ({DEVICE}) vs dense fp64 (cpu), "
            f"B=64: max|du|={err}")
        assert bool((r64.e_flag == 1).all()) and bool((r32.e_flag == 1).all())
        assert err <= U_TOL_FP64, (name, err)
    return launches


def phase_ellip_times(sp):
    """K4 and K5, their plain versions and the fp32 dense engines at
    B=8192 and 32768, in turns, each a CUDA-event mean. Returns the minima
    and each kernel's bound at B=8192."""
    from spcies_tpu_torch.kernels import fused_ellip as k4
    from spcies_tpu_torch.kernels import fused_soc as k5
    out = {}
    for name, (submethod, _) in ELLIP_FAMILIES.items():
        kern, plain = ((k5.fused_soc_solve, k5.fused_soc_reference)
                       if submethod else
                       (k4.fused_ellip_solve, k4.fused_ellip_reference))
        for B in (FB, BATCH):
            fused = ellip_solver(sp, name, device=DEVICE)
            dense = ellip_solver(sp, name, backend="dense", device=DEVICE)
            dense.options.timing = False
            inputs = ellip_inputs(sp, name, 0, B)
            args, kk = ellip_kernel_args(fused, inputs)
            x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in inputs]
            kernel = lambda: kern(*args, **kk)  # noqa: E731
            plain_fn = lambda: plain(*args, **kk)  # noqa: E731
            dense_fn = lambda: dense(*x)  # noqa: E731
            t, res = in_turns(kernel, plain_fn, dense_fn)
            log(f"phase 12 {name} dense fp32 engine B={B}: "
                f"k_mean={float(res.k.float().mean())} "
                f"converged={float((res.e_flag == 1).float().mean())}")
            res = kernel()
            k = res[3][:B].long()
            # the products' real rows and columns: nz for K4, dim + n + 1
            # for K5
            w = (fused.raw_fn.dim + fused.raw_fn.n_s if submethod
                 else fused.nz)
            bound = roofline(args + res, iter_flops(k, 2.0 * w * w))
            log(f"phase 12 {name} kernel B={B}: k_mean="
                f"{float(k.float().mean())} k_max={int(k.max())} "
                f"{json.dumps(iterations(k, kern))} bound={bound}")
            log(f"phase 12 {name} times (ms per B={B} solve, CUDA events): "
                + json.dumps(t))
            it = iterations(k, kern)
            out[(name, B)] = dict({key: min(v) for key, v in t.items()},
                                  bound=bound, lanes=it["lanes"],
                                  refill=it["refill"])
    return out


def hmpc_solver(sp, name, backend="fused", device=None, precision="float",
                horizon=N, plant=None, **kw):
    """A solver of one of the bench's N=30 HMPC families; `device` None
    leaves it to make_solver's default, the card. A plant's param may set
    its own w, Te, Th, Se and Sh."""
    formulation, method, submethod, base = HMPC_FAMILIES[name]
    sys_, param30, (_, _, ur) = problem(sp, 0, 1, horizon, plant)
    p = dict(param30)
    p.pop("T", None)
    p.setdefault("w", 3 * 1.627 * 0.2)
    p.setdefault("Te", 10 * p["N"] * np.asarray(p["Q"]))
    p.setdefault("Th", p["Te"])
    p.setdefault("Se", np.asarray(p["R"]).copy())
    p.setdefault("Sh", 0.5 * p["Se"])
    if formulation == "ellipHMPC":
        n_x = np.asarray(sys_["A"]).shape[0]
        sys_ = dict(sys_, E=np.eye(3, n_x), F=np.zeros((3, ur.shape[1])),
                    LBy=-0.1 * np.ones(3), UBy=0.1 * np.ones(3))
        p["Te"] = p["N"] * np.asarray(p["Q"])
        p["Th"] = p["Te"]
    o = sp.default_options(formulation, method, submethod, **{**base, **kw})
    o.precision = precision
    where = {} if device is None else dict(device=device)
    return sp.make_solver(sys_, p, formulation=formulation, method=method,
                          submethod=submethod, options=o, backend=backend,
                          **where)


def hmpc_inputs(sp, name, seed, B, plant=None):
    """The bench inputs of `problem`; for ellipHMPC the seven decomposed
    references of bench.py:355-370: per-lane sine amplitudes in [0.125,
    0.25] (cosine half as much) on the three positions, whose outputs then
    exceed the +-0.1 bounds, and a constant input sine."""
    _, _, (x0, xr, ur) = problem(sp, seed, B, plant=plant)
    if HMPC_FAMILIES[name][0] != "ellipHMPC":
        return x0, xr, ur
    rng = np.random.default_rng(seed)
    rng.uniform(-2.0, 2.0, (B, 1))         # the draw that made x0
    amp = rng.uniform(0.5, 1.0, (B, 1)) * 0.25
    xrs = np.zeros_like(xr)
    xrs[:, :3] = amp
    xrc = np.zeros_like(xr)
    xrc[:, :3] = 0.5 * amp
    return (x0, xr, xrs, xrc, ur, 0.1 * np.ones_like(ur),
            np.zeros_like(ur))


def hmpc_kernel_args(solver, inputs):
    """The K6 or K7 kernel's exact arguments for one call of a fused
    solver."""
    from spcies_tpu_torch.api import broadcast_inputs
    x = broadcast_inputs(torch.float32, solver.device, *inputs)
    *kin, _b = solver.raw_fn.prepare(*x)
    return (*kin, *solver.raw_fn.operator), dict(solver.raw_fn.kernel_kw)


def hmpc_kernel(name):
    """(key, kernel wrapper, plain version) of the kernel that serves an
    HMPC family; both kernels return u's iterate first."""
    from spcies_tpu_torch.kernels import fused_hmpc as k6
    from spcies_tpu_torch.kernels import fused_split as k7
    if HMPC_FAMILIES[name][2] == "split":
        return "fused_split", k7.fused_split_solve, k7.fused_split_reference
    return "fused_hmpc", k6.fused_hmpc_solve, k6.fused_hmpc_reference


def hmpc_modes():
    """Phase 13's runs: (family, label, B, capped, solver options)."""
    adm, ell = "HMPC-ADMM", "ellipHMPC-ADMM"
    spl, sad = "HMPC-ADMM-split", "HMPC-SADMM-split"
    ek = dict(tile_b=TILE_B, check_every=8, exact_k=True)
    checked = dict(tile_b=TILE_B, check_every=1, exact_k=False)
    capped = dict(ek, tol_p=1e-13, tol_d=1e-13, k_max=19)
    modes = [
        (adm, f"free-run B={FB}", FB, False, {}),
        (ell, f"free-run B={FB}", FB, False, {}),
        (spl, f"exact-k B={FB}", FB, False, {}),
        (sad, f"exact-k B={FB}", FB, False, {}),
        (adm, f"checked B={SMALL_BATCH}", SMALL_BATCH, False, checked),
        (adm, f"exact-k B={SMALL_BATCH}", SMALL_BATCH, False, ek),
        (adm, f"exact-k capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, True, capped),
        (adm, f"use_soc free-run B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(use_soc=True)),
        (adm, f"free-run capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, True, dict(tol_p=1e-13, tol_d=1e-13, k_max=19)),
        (ell, f"exact-k B={SMALL_BATCH}", SMALL_BATCH, False, ek),
        (spl, f"checked B={SMALL_BATCH}", SMALL_BATCH, False, checked),
        (sad, f"checked B={SMALL_BATCH}", SMALL_BATCH, False, checked),
        (spl, f"free-run B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(tile_b=8, exact_k=False)),
        (sad, f"free-run B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(tile_b=8, exact_k=False)),
        (spl, f"exact-k capped (tol 1e-13, k_max 19) B={SMALL_BATCH}",
         SMALL_BATCH, True, capped),
        (spl, f"use_soc exact-k B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(use_soc=True)),
        (sad, f"use_soc exact-k B={SMALL_BATCH}", SMALL_BATCH, False,
         dict(use_soc=True)),
    ]
    return modes


def phase_hmpc_kernel_vs_plain(sp):
    """K6 and K7 against their plain versions on the same CUDA tensors, and
    each kernel's builds against each other (K7's also without refill).
    Returns the largest u error of each kernel over its modes."""
    u_err = {"fused_hmpc": 0.0, "fused_split": 0.0}
    for name, label, B, cut, kw in hmpc_modes():
        solver = hmpc_solver(sp, name, device=DEVICE, **kw)
        args, kk = hmpc_kernel_args(solver, hmpc_inputs(sp, name, 0, B))
        key, kern, plain = hmpc_kernel(name)
        out_k = kern(*args, **kk)
        torch.cuda.synchronize()
        out_p = plain(*args, **kk)
        torch.cuda.synchronize()
        a = agreement(out_k, out_p, B, solver.m, cut, u_at=0)
        check_agreement(f"{name} {label}", a, phase=13)
        if cut:
            assert bool((out_k[3][:B] == 19).all()), "capped k"
        check_lanes_bitwise(kern, args, kk, B, f"{name} {label}", 13,
                            refill=key == "fused_split")
        u_err[key] = max(u_err[key], a["u_err"])
    return u_err


def phase_hmpc_paths(sp):
    """The four HMPC paths, each through make_solver(..., backend='fused')
    with the device left to its default: a request and a warm start from
    it, each launching its kernel once and no other; then a small batch
    against the fp64 dense engine on the CPU. Returns the launches of each
    kernel."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.kernels.fused_eadmm import fused_eadmm_solve
    from spcies_tpu_torch.kernels.fused_ellip import fused_ellip_solve
    from spcies_tpu_torch.kernels.fused_fista import fused_fista_solve
    from spcies_tpu_torch.kernels.fused_hmpc import fused_hmpc_solve
    from spcies_tpu_torch.kernels.fused_soc import fused_soc_solve
    from spcies_tpu_torch.kernels.fused_split import fused_split_solve
    counters = {"fused_admm": fused_admm_solve,
                "fused_fista": fused_fista_solve,
                "fused_eadmm": fused_eadmm_solve,
                "fused_ellip": fused_ellip_solve,
                "fused_soc": fused_soc_solve,
                "fused_hmpc": fused_hmpc_solve,
                "fused_split": fused_split_solve}
    launches = dict.fromkeys(counters, 0)
    for name in HMPC_FAMILIES:
        kernel = hmpc_kernel(name)[0]
        split = kernel == "fused_split"
        solver = hmpc_solver(sp, name)
        assert solver.device.type == DEVICE, solver.device
        inputs = hmpc_inputs(sp, name, 0, FB)
        for c in counters.values():
            c.launches = 0
        cold = solver(*inputs)
        torch.cuda.synchronize()
        after_cold = counters[kernel].launches
        keys = ("z", "s", "lam", "mu") if split else ("z", "s", "lam")
        warm = solver(*inputs, init=tuple(cold.sol[key] for key in keys))
        torch.cuda.synchronize()
        counts = {key: c.launches for key, c in counters.items()}
        for tag, res in (("seed 0", cold), ("seed 0 warm", warm)):
            log(f"phase 14 {name} request {tag}: "
                f"k_mean={float(res.k.float().mean())} "
                f"k_max={int(res.k.max())} "
                f"converged={float((res.e_flag == 1).float().mean())} "
                f"times_ms={res.sol['times_ms']}")
            assert tuple(res.u.shape) == (FB, solver.m), res.u.shape
            assert res.u.device.type == DEVICE
            assert bool(torch.isfinite(res.u).all()), name
            assert bool((res.e_flag == 1).all()), (name, tag)
        assert after_cold == 1 and counts[kernel] == 2, (name, counts)
        assert sum(counts.values()) == 2, (name, counts)
        assert float(warm.k.float().mean()) < float(cold.k.float().mean())
        launches[kernel] += counts[kernel]

        # a lane in plain free-run keeps iterating past its exit until its
        # block of 8 is done, so its u is not the fp64 engine's exit point
        # (at ellipHMPC's rho 200 and tol 1e-4 the two lie 2.8e-3 apart in
        # a CPU rehearsal, each as far from the solution): those families
        # are held to it through the checked mode of the same kernel
        small = hmpc_inputs(sp, name, 5, 64)
        r64 = hmpc_solver(sp, name, backend="dense", device="cpu",
                          precision="double")(*small)
        kw = solver.raw_fn.kernel_kw
        free_run = kw["check_every"] > 1 and not kw["exact_k"]
        r32 = (hmpc_solver(sp, name, check_every=1) if free_run
               else solver)(*small)
        err = float((r32.u.cpu().double() - r64.u).abs().max())
        log(f"phase 14 {name} fused fp32 ({DEVICE}"
            f"{', checked' if free_run else ''}) vs dense fp64 (cpu), B=64: "
            f"max|du|={err}")
        assert bool((r64.e_flag == 1).all()) and bool((r32.e_flag == 1).all())
        assert err <= U_TOL_FP64, (name, err)
    return launches


def hmpc_flops(solver, key):
    """FLOP of one iteration's products at the real widths: K7's dq @ M1'
    over dim + n_s; K6's w @ (C M1') over n_s x dim (dense) and z @ C' over
    C's nonzeros alone (a box row of C is one -1, a cone row touches a few
    harmonic entries)."""
    ing = solver.ingredients
    dim, n_s = ing["dim"], ing["n_s"]
    if key == "fused_split":
        return 2.0 * (dim + n_s) ** 2
    return 2.0 * n_s * dim + 2.0 * float(np.count_nonzero(ing["C"]))


def phase_hmpc_times(sp):
    """K6 and K7, their plain versions and the fp32 dense engines, in turns,
    each a CUDA-event mean: at B=8192 and 32768 for HMPC-ADMM,
    HMPC-ADMM-split and ellipHMPC-ADMM, at B=8192 for HMPC-SADMM-split.
    Returns the minima and each kernel's bound."""
    out = {}
    for name in HMPC_FAMILIES:
        key, kern, plain = hmpc_kernel(name)
        sizes = (FB,) if name == "HMPC-SADMM-split" else (FB, BATCH)
        for B in sizes:
            fused = hmpc_solver(sp, name, device=DEVICE)
            dense = hmpc_solver(sp, name, backend="dense", device=DEVICE)
            dense.options.timing = False
            inputs = hmpc_inputs(sp, name, 0, B)
            args, kk = hmpc_kernel_args(fused, inputs)
            x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in inputs]
            kernel = lambda: kern(*args, **kk)  # noqa: E731
            plain_fn = lambda: plain(*args, **kk)  # noqa: E731
            dense_fn = lambda: dense(*x)  # noqa: E731
            t, res = in_turns(kernel, plain_fn, dense_fn)
            log(f"phase 15 {name} dense fp32 engine B={B}: "
                f"k_mean={float(res.k.float().mean())} "
                f"converged={float((res.e_flag == 1).float().mean())}")
            res = kernel()
            k = res[3][:B].long()
            bound = roofline(args + res, iter_flops(k, hmpc_flops(fused, key)))
            log(f"phase 15 {name} kernel B={B}: k_mean="
                f"{float(k.float().mean())} k_max={int(k.max())} "
                f"{json.dumps(iterations(k, kern))} bound={bound}")
            log(f"phase 15 {name} times (ms per B={B} solve, CUDA events): "
                + json.dumps(t))
            it = iterations(k, kern)
            out[(name, B)] = dict({key: min(v) for key, v in t.items()},
                                  bound=bound, lanes=it["lanes"],
                                  refill=it["refill"])
    return out

# phase 16: the closed-loop rollout at the bench's closed-loop settings
# (bench.py:388-445): the headline laxMPC-ADMM solver, 4096 loops, 50 steps
CL_BATCH, CL_STEPS, CL_RUNS = 4096, 50, 3
SHIFT_BAR = 0.7     # shift's iterations after step 0 against cold's
                    # (tests/test_rollout.py:109)
CL_XS_TOL = 1e-3    # fused fp32 against dense fp32 trajectories


def device_ms(run):
    """(device ms, K1's ms) of one call of run() under torch.profiler, or
    (None, None) where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    events = prof.key_averages()
    total = sum(dev_us(e) for e in events)
    if not total:
        return None, None
    k1 = sum(dev_us(e) for e in events if "fused_admm" in e.key)
    return total / 1e3, k1 / 1e3


def phase_rollout(sp):
    """The closed-loop rollout on the card: the fused solver (one K1
    launch a step, its episodes replayed as CUDA graphs) cold, carried and
    shifted, and the dense engine (the eager loop) shifted,
    each a warm-up, CL_RUNS timed runs and one run under torch.profiler
    (the device's busy time against the median wall: its idle share).
    Returns the K1 launches of the timed runs and the rows."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.runtime import closed_loop_rollout
    sys_, _, inputs = problem(sp, 0, CL_BATCH)
    A, B = np.asarray(sys_["A"]), np.asarray(sys_["B"])
    x = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
         for a in inputs]
    fused = fused_solver(sp, tile_b=TILE_B, check_every=CHECK_EVERY,
                         exact_k=True)
    dense = fused_solver(sp, backend="dense")
    rows = [("fused cold", fused, False), ("fused carry", fused, True),
            ("fused shift", fused, "shift"), ("dense shift", dense, "shift")]
    out, launches = {}, 0
    for label, solver, ws in rows:
        def run():
            return closed_loop_rollout(solver, A, B, *x, n_steps=CL_STEPS,
                                       warm_start=ws)
        t_row = time.perf_counter()
        run()
        torch.cuda.synchronize()
        fused_admm_solve.launches = 0
        times = []
        for _ in range(CL_RUNS):
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        n = fused_admm_solve.launches
        want = CL_RUNS * CL_STEPS if solver is fused else 0
        assert n == want, (label, n, want)
        launches += n
        ks, es = res["ks"], res["e_flags"]
        dt = sorted(times)[len(times) // 2]
        t_prof = time.perf_counter()
        dev, k1_ms = device_ms(run)
        now = time.perf_counter()
        row = dict(
            solves_per_s=CL_BATCH * CL_STEPS / dt,
            solves_per_s_min=CL_BATCH * CL_STEPS / max(times),
            solves_per_s_max=CL_BATCH * CL_STEPS / min(times),
            k_mean=float(ks.float().mean()),
            k_mean_after_step0=float(ks[1:].float().mean()),
            k_after_step0=int(ks[1:].long().sum()),
            converged=float((es == 1).float().mean()),
            steps_all_converged=int((es == 1).all(dim=1).sum()),
            k1_launches=n, runs=CL_RUNS, wall_ms=dt * 1e3,
            device_ms=dev, k1_ms=k1_ms,
            idle_share=None if dev is None else 1.0 - dev / (dt * 1e3),
            graphed=bool(getattr(solver.raw_fn, "episode_graphs", None)),
            row_s=now - t_row, profiled_s=now - t_prof)
        log(f"phase 16 rollout {label} (B={CL_BATCH}, {CL_STEPS} steps): "
            + json.dumps(row))
        # the fused solve replays its episodes as CUDA graphs; the dense
        # engine reads "all done" on the host and keeps the loop
        assert row["graphed"] == (solver is fused), label
        assert tuple(res["xs"].shape) == (CL_STEPS + 1, CL_BATCH, A.shape[0])
        assert bool(torch.isfinite(res["xs"]).all()), label
        # a lane that did not converge ran to k_max (the fp32 floor of
        # some cold and carried states at k_max 1000)
        assert bool((ks[es != 1] == K_MAX).all()), label
        if ws == "shift":
            assert bool((es == 1).all()), label
        out[label] = (row, res)
    k_shift = out["fused shift"][0]["k_after_step0"]
    k_cold = out["fused cold"][0]["k_after_step0"]
    assert k_shift < SHIFT_BAR * k_cold, (k_shift, k_cold)
    dx = float((out["fused shift"][1]["xs"]
                - out["dense shift"][1]["xs"]).abs().max())
    log(f"phase 16 fused shift vs dense shift: max|dxs|={dx}; shift/cold "
        f"iterations after step 0 = {k_shift / k_cold}")
    assert dx <= CL_XS_TOL, dx
    return launches, {label: row for label, (row, _) in out.items()}


# phase 17: K1 past 512 columns
WIDE_CASES = (("MPCT-ADMM-cs N=33", 33), ("MPCT-ADMM-cs N=64", 64))
# the first horizon past each kernel's cap of 1024 columns, which
# make_solver(..., device="cuda") refuses at build time
REFUSED = {
    "fused_admm": (130, lambda sp, h: fused_solver(sp, horizon=h)),
    "fused_fista": (129, lambda sp, h: family_solver(sp, "laxMPC-FISTA",
                                                     horizon=h)),
    "fused_eadmm": (128, lambda sp, h: mpct_solver(sp, "MPCT-EADMM",
                                                   horizon=h)),
    "fused_ellip": (129, lambda sp, h: ellip_solver(sp, "ellipMPC-ADMM",
                                                    horizon=h)),
    "fused_soc": (124, lambda sp, h: ellip_solver(sp, "ellipMPC-ADMM-soc",
                                                  horizon=h)),
    "fused_hmpc": (125, lambda sp, h: hmpc_solver(sp, "HMPC-ADMM",
                                                  horizon=h)),
    "fused_split": (122, lambda sp, h: hmpc_solver(sp, "HMPC-ADMM-split",
                                                   horizon=h)),
}


def timed(kernel, plain):
    """A kernel and its plain version in turns (plain, kernel, kernel,
    plain), each a CUDA-event mean; the least of each."""
    t, _ = in_turns(kernel, plain, reps=3)
    return {key: min(v) for key, v in t.items()}


def phase_wide(sp):
    """K1's wide build against its plain version on CUDA tensors at
    MPCT-ADMM-cs N=33 (544 columns) and N=64 (1024), B=8192, exact-k, its
    8- and 16-lane builds bit for bit where both take the shape; the wide
    build against the narrow one at laxMPC-ADMM N=64 (512 columns), bit
    for bit; times and bounds; then make_solver(..., backend="fused",
    device="cuda") refusing a width past each kernel's cap at build time.
    Returns the times by padded width."""
    from spcies_tpu_torch.kernels import fused_admm as k1
    out = {}
    for label, horizon in WIDE_CASES:
        solver = mpct_solver(sp, "MPCT-ADMM-cs", horizon=horizon)
        _, _, inputs = problem(sp, 0, FB, horizon)
        args, kk = kernel_args(solver, inputs)
        nzp = args[0].shape[1]
        outs = {}
        for L in (16, 8):
            try:
                outs[L] = k1.fused_admm_solve(*args, **kk, lanes=L)
            except ValueError as e:     # no build of L lanes takes it
                if "no build" not in str(e):
                    raise
                continue
            assert k1.fused_admm_solve.last_plan["wide"], label
        torch.cuda.synchronize()
        out_k = k1.fused_admm_solve(*args, **kk)
        plan = plan_of(k1.fused_admm_solve)
        it = iterations(out_k[3][:FB], k1.fused_admm_solve)
        out_p = k1.fused_admm_reference(*args, **kk)
        torch.cuda.synchronize()
        a = agreement(out_k, out_p, FB, solver.nz, False)
        check_agreement(f"{label} ({nzp} columns)", a, phase=17)
        for L, o in outs.items():
            assert all(bool(torch.equal(x, y)) for x, y in zip(o, out_k)), (
                label, L)
        log(f"phase 17 {label}: builds {sorted(outs)} bit-identical "
            f"plan={plan}")
        t = timed(lambda: k1.fused_admm_solve(*args, **kk),
                  lambda: k1.fused_admm_reference(*args, **kk))
        k = out_k[3][:FB]
        bound = roofline(args + out_k,
                         iter_flops(k, 2.0 * solver.nz * solver.nz))
        row = dict(t, bound=bound, share=bound[0] / t["kernel"],
                   k_mean=float(k.float().mean()), **it,
                   slab=plan["slab"], u_err=a["u_err"])
        log(f"phase 17 {label} times (ms, B={FB}, CUDA events): "
            + json.dumps(row))
        out[nzp] = row

    # 512 columns: the wide build gives the narrow build's bits
    solver = fused_solver(sp, horizon=64, tile_b=TILE_B,
                          check_every=CHECK_EVERY, exact_k=True)
    _, _, inputs = problem(sp, 0, FB, 64)
    args, kk = kernel_args(solver, inputs)
    assert args[0].shape[1] == 512
    narrow = k1.fused_admm_solve(*args, **kk, wide=False)
    assert not k1.fused_admm_solve.last_plan["wide"]
    for L in (16, 8):
        wide = k1.fused_admm_solve(*args, **kk, wide=True, lanes=L)
        assert k1.fused_admm_solve.last_plan["wide"]
        torch.cuda.synchronize()
        assert all(bool(torch.equal(x, y)) for x, y in zip(wide, narrow)), L
    out_p = k1.fused_admm_reference(*args, **kk)
    a = agreement(narrow, out_p, FB, solver.m, False)
    log(f"phase 17 laxMPC-ADMM N=64 (512 columns): wide builds (16, 8 "
        f"lanes) bit-identical to the narrow build; vs plain "
        f"{json.dumps(a)}")
    assert a["k_agree"] >= K_AGREE and a["u_err"] <= U_TOL, a
    t = {"narrow": [], "wide": []}
    for key in ("narrow", "wide", "wide", "narrow"):
        t[key].append(cuda_ms(lambda: k1.fused_admm_solve(
            *args, **kk, wide=key == "wide"), reps=3))
    log(f"phase 17 laxMPC-ADMM N=64 times (ms, B={FB}): narrow / wide "
        + json.dumps(t))
    out[512] = {key: min(v) for key, v in t.items()}

    # build-time refusal past each kernel's cap
    for name, (horizon, build) in REFUSED.items():
        try:
            build(sp, horizon)
        except ValueError as e:
            msg = str(e)
            assert 'backend="dense"' in msg and "csrc/" + name in msg, msg
            log(f"phase 17 {name} at N={horizon}: make_solver refuses: "
                f"{msg}")
        else:
            raise AssertionError(f"{name} built past its cap at N={horizon}")
    return out


# phase 17, K2-K7: one family a kernel at the bench's settings (phases
# 4-15), at the first horizon of the oscillating masses whose padded width
# passes 512 and at the widest whose widths stay at or under 1024, both on
# the kernel's wide build; the first horizon past 1024 is REFUSED's
WIDE_FAMILY = {
    "fused_fista": "laxMPC-FISTA",
    "fused_eadmm": "MPCT-EADMM",
    "fused_ellip": "ellipMPC-ADMM",
    "fused_soc": "ellipMPC-ADMM-soc",
    "fused_hmpc": "HMPC-ADMM",
    "fused_split": "HMPC-ADMM-split",
}
WIDE_HORIZONS = {
    "fused_fista": (65, 128),
    "fused_eadmm": (64, 127),
    "fused_ellip": (65, 128),
    "fused_soc": (60, 123),
    "fused_hmpc": (61, 124),
    "fused_split": (58, 121),
}
# the wide builds with refill (K4-K7; K2's and K3's keep a block of L
# lanes, as their narrow builds do), and the runs past 512 columns of a
# second family or plant of a kernel, logged beside its rows, as (family,
# horizon, random_plant's seed, states and inputs or None): K6's
# ellipHMPC-ADMM at its first horizon past 512 columns (544 x 224), K7's
# SADMM half-step, and K3 at 1024 columns with more classes of columns than
# C2d's copy fits beside the 16-lane build's ring (nd 21: read by __ldg at
# 16 lanes, copied at 8) and beside the 8-lane build's (nd 29: by __ldg at
# both)
REFILL_WIDE = ("fused_ellip", "fused_soc", "fused_hmpc", "fused_split")
WIDE_EXTRA = {"fused_eadmm": (("MPCT-EADMM", 49, (410, 14, 6)),
                              ("MPCT-EADMM", 35, (411, 20, 8))),
              "fused_hmpc": (("ellipHMPC-ADMM", 62, None),),
              "fused_split": (("HMPC-SADMM-split", 58, None),)}


def wide_runs(name):
    """Phase 17's runs past 512 columns of a kernel: (family, horizon,
    keyword arguments of fam_solver and fam_args, label), WIDE_HORIZONS'
    of its WIDE_FAMILY, then its WIDE_EXTRA (a random plant at the
    horizon)."""
    out = []
    for fam, horizon, spec in [(WIDE_FAMILY[name], h, None)
                               for h in WIDE_HORIZONS[name]] + list(
                                   WIDE_EXTRA.get(name, ())):
        if spec is None:
            out.append((fam, horizon, {}, f"{fam} N={horizon}"))
            continue
        seed, n, m = spec
        sys_, param, x0, xr, ur = random_plant(seed, n, m)
        plant = (sys_, dict(param, N=horizon), x0, xr, ur)
        out.append((fam, horizon, dict(plant=plant),
                    f"{fam} random plant n={n} m={m} (seed {seed}) "
                    f"N={horizon}"))
    return out


def fam_kernel(fam):
    """(key, wrapper, plain version, agreement's u_at, k_at, u_off from
    the solver) of the kernel that serves a family."""
    from spcies_tpu_torch.kernels import fused_admm as k1
    from spcies_tpu_torch.kernels import fused_eadmm as k3
    from spcies_tpu_torch.kernels import fused_ellip as k4
    from spcies_tpu_torch.kernels import fused_fista as k2
    from spcies_tpu_torch.kernels import fused_soc as k5
    if fam == "laxMPC-ADMM":
        return ("fused_admm", k1.fused_admm_solve, k1.fused_admm_reference,
                1, 3, lambda s: 0)
    if fam in FAMILIES:
        return ("fused_fista", k2.fused_fista_solve,
                k2.fused_fista_reference, 0, 3, lambda s: 0)
    if fam in MPCT_FAMILIES:
        return ("fused_eadmm", k3.fused_eadmm_solve,
                k3.fused_eadmm_reference, 0, 5, lambda s: s.n)
    if fam == "ellipMPC-ADMM":
        return ("fused_ellip", k4.fused_ellip_solve,
                k4.fused_ellip_reference, 1, 3, lambda s: 0)
    if fam in ELLIP_FAMILIES:
        return ("fused_soc", k5.fused_soc_solve, k5.fused_soc_reference, 0,
                3, lambda s: 0)
    key, kern, plain = hmpc_kernel(fam)
    return key, kern, plain, 0, 3, lambda s: 0


def fam_solver(sp, fam, **kw):
    """A fused solver of a family on the card (laxMPC-ADMM at the headline
    settings)."""
    if fam == "laxMPC-ADMM":
        return fused_solver(sp, **{**dict(tile_b=TILE_B,
                                          check_every=CHECK_EVERY,
                                          exact_k=True), **kw})
    if fam in FAMILIES:
        return family_solver(sp, fam, **kw)
    if fam in MPCT_FAMILIES:
        return mpct_solver(sp, fam, **kw)
    if fam in ELLIP_FAMILIES:
        return ellip_solver(sp, fam, device=DEVICE, **kw)
    return hmpc_solver(sp, fam, device=DEVICE, **kw)


def fam_args(sp, fam, solver, B, fixed=0, plant=None, **extra):
    """The kernel's exact arguments for one call of a family's fused solver
    on B lanes of the bench's inputs (seed 0)."""
    if fam == "laxMPC-ADMM":
        return kernel_args(solver, problem(sp, 0, B, plant=plant)[2], fixed)
    if fam in FAMILIES:
        return fista_kernel_args(solver, problem(sp, 0, B, plant=plant)[2],
                                 fixed)
    if fam in MPCT_FAMILIES:
        return eadmm_kernel_args(solver, problem(sp, 0, B, plant=plant)[2])
    if fam in ELLIP_FAMILIES:
        return ellip_kernel_args(
            solver, ellip_inputs(sp, fam, 0, B, plant=plant, **extra), fixed)
    return hmpc_kernel_args(solver, hmpc_inputs(sp, fam, 0, B, plant=plant))


def fam_flops(fam, solver):
    """FLOP of one iteration's products for a lane, at the real widths, as
    phases 3, 6, 9, 12 and 15 count them (K3's z2 product over the nd
    distinct columns of C2m and C2t)."""
    if fam == "laxMPC-ADMM":
        return 2.0 * solver.nz * solver.nz
    if fam in FAMILIES:
        nz, nlam = solver.nz, solver.raw_fn.nlam
        return 2.0 * (2 * nz * nlam + nlam * nlam)
    if fam in MPCT_FAMILIES:
        nz1, nm = solver.raw_fn.nz1, solver.raw_fn.nm
        nd = solver.raw_fn.classes[0].shape[1]
        return 2.0 * (nz1 * nd + nz1 * nz1 + nm * nd)
    if fam == "ellipMPC-ADMM":
        return 2.0 * solver.nz * solver.nz
    if fam in ELLIP_FAMILIES:
        w = solver.raw_fn.dim + solver.raw_fn.n_s
        return 2.0 * w * w
    return hmpc_flops(solver, hmpc_kernel(fam)[0])


def kernel_modes(name):
    """The runs of a kernel's own phase (4, 7, 10 or 13): (label, family,
    B, fixed_iters, capped, solver options, input options)."""
    if name == "fused_fista":
        return [(label, fam, B, fixed, bool(fixed), kw, {})
                for label, fam, B, fixed, kw in fista_modes()]
    if name == "fused_eadmm":
        return [(f"MPCT-EADMM {label}", "MPCT-EADMM", B, 0, capped, kw, {})
                for label, B, capped, kw in eadmm_modes()]
    if name in ("fused_ellip", "fused_soc"):
        return [(f"{fam} {label}", fam, B, fixed, cut, kw, extra)
                for fam, label, B, fixed, cut, kw, extra in ellip_modes()
                if fam_kernel(fam)[0] == name]
    return [(f"{fam} {label}", fam, B, 0, cut, kw, {})
            for fam, label, B, cut, kw in hmpc_modes()
            if hmpc_kernel(fam)[0] == name]


def kernel_extra(name, solver):
    """What a timed launch passes the kernel beside the plain version's
    arguments: K3's classes of columns, found once by the solver."""
    return {"classes": solver.raw_fn.classes} if name == "fused_eadmm" else {}


def event_ms(fn):
    """One call's CUDA-event time and its result."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def phase_wide_kernels(sp):
    """K2-K7's wide builds on CUDA tensors: each forced at its family's
    N=30 width gives the narrow build's bits in every mode of the kernel's
    own phase at each lanes-a-block build (K4-K7 with refill and without);
    at the first horizon past 512 columns and the widest up to 1024,
    B=8192 (and WIDE_EXTRA's), every lane converges, k agrees with the
    plain version on >= 0.9985 of lanes and u within U_TOL, timed in turns
    (kernel, plain once, kernel) with the bound, its share and the plan,
    and every other lanes-a-block build gives the planned one's bits.
    Returns, by kernel, the rows by padded width (WIDE_FAMILY's family)
    and the largest u error."""
    from spcies_tpu_torch.kernels.stage import WIDE_BUILDS
    out = {}
    for name, fam in WIDE_FAMILY.items():
        _, kern, plain, u_at, k_at, u_off = fam_kernel(fam)
        builds = [(L, refill) for L in sorted(WIDE_BUILDS)
                  for refill in ((True, False) if name in REFILL_WIDE
                                 else (False,))]
        for label, mfam, B, fixed, _cut, kw, extra in kernel_modes(name):
            solver = fam_solver(sp, mfam, **kw)
            args, kk = fam_args(sp, mfam, solver, B, fixed, **extra)
            narrow = kern(*args, **kk, wide=False)
            plans = []
            for L, refill in builds:
                with without_refill() if name in REFILL_WIDE and \
                        not refill else nullcontext():
                    wide = kern(*args, **kk, wide=True, lanes=L)
                plan = {k: v for k, v in kern.last_plan.items()
                        if not torch.is_tensor(v)}
                assert plan["wide"], label
                # K4's fixed_iters keeps static blocks
                assert (plan["lanes"], plan["refill"]) == (
                    L, refill and not fixed), (label, plan)
                torch.cuda.synchronize()
                same = all(bool(torch.equal(a[:B], b[:B]))
                           for a, b in zip(wide, narrow))
                assert same, (name, label, L, refill)
                plans.append(plan)
            log(f"phase 17 {name} {label}: wide build bit-identical to "
                f"the narrow build (plans {plans})")
        rows, u_err = {}, 0.0
        for rfam, horizon, pk, what in wide_runs(name):
            solver = fam_solver(sp, rfam, horizon=horizon, **pk)
            args, kk = fam_args(sp, rfam, solver, FB, **pk)
            kx = kernel_extra(name, solver)
            t0, out_k = event_ms(lambda: kern(*args, **kk, **kx))
            plan = dict(kern.last_plan)
            assert plan.get("wide"), (name, horizon, plan)
            t_plain, out_p = event_ms(lambda: plain(*args, **kk))
            t1, _ = event_ms(lambda: kern(*args, **kk, **kx))
            t2, _ = event_ms(lambda: kern(*args, **kk, **kx))
            a = agreement(out_k, out_p, FB, solver.m, False, u_at=u_at,
                          k_at=k_at, u_off=u_off(solver))
            width = max(max(t.shape) for t in solver.raw_fn.operator
                        if t.dim() == 2)
            check_agreement(f"{name} {what} ({width} columns)", a,
                            phase=17)
            k = out_k[k_at][:FB]
            kernel_ms = min(t1, t2)
            bound = roofline(args + out_k, iter_flops(k, fam_flops(rfam,
                                                                   solver)))
            row = dict(kernel=kernel_ms, first_call=t0, plain=t_plain,
                       bound=bound, share=bound[0] / kernel_ms,
                       k_mean=float(k.float().mean()),
                       block_k_mean=float(k.reshape(-1, 8).amax(dim=1)
                                          .float().mean()),
                       lanes=plan["lanes"], threads=plan["threads"],
                       smem=plan["smem"], horizon=horizon,
                       u_err=a["u_err"])
            if name == "fused_eadmm":
                row.update(nd=plan["nd"], c2d_staged=plan["c2d_staged"])
                # a random plant's run is there for the chains' __ldg path
                assert not pk or not plan["c2d_staged"], (what, plan)
            row.update(iterations(k, kern), slab=plan["slab"],
                       blocks=plan["blocks"],
                       global_leaves=plan["global_leaves"])
            # every other lanes-a-block build gives the planned one's bits
            # (at 1024 columns 16 lanes keep more of their state in global
            # scratch than 8, and K3's may read C2d where 8 copy it)
            for L in sorted(set(WIDE_BUILDS) - {plan["lanes"]}):
                other = kern(*args, **kk, **kx, lanes=L)
                torch.cuda.synchronize()
                assert all(bool(torch.equal(x, y))
                           for x, y in zip(other, out_k)), (what, L)
                row[f"bits_equal_lanes_{L}"] = True
                if name == "fused_eadmm":
                    row[f"c2d_staged_lanes_{L}"] = kern.last_plan[
                        "c2d_staged"]
            log(f"phase 17 {name} {what} ({width} columns) times (ms, "
                f"B={FB}, CUDA events): " + json.dumps(row))
            if rfam == fam and not pk:
                rows[width] = row
            u_err = max(u_err, a["u_err"])
        out[name] = (rows, u_err)
    return out


# phase 18: every kernel off the N=30 fixture, one family a kernel: the
# three random plants of tests/test_fuzz_differential.py (`random_plant`)
# and the oscillating masses at N=10 and 31, B=1024, checked and exact-k
OFF_FAMILY = {"fused_admm": "laxMPC-ADMM", **WIDE_FAMILY}
OFF_B = 1024
FUZZ_DIMS = ((3, 1, 0), (5, 2, 1), (8, 3, 2))
OFF_HORIZONS = (10, 31)
OFF_K_MAX = 20000
# the terminal radius of the ellipMPC families on the random plants: a
# plant's steady state may lie outside its state box (seed 402's does), and
# then no terminal state lies within R_ELLIP of it: the QP is infeasible and
# the fp64 dense engine does not converge either
FUZZ_RADIUS = 2.0


def random_plant(seed, n, m, hmpc=False):
    """tests/test_fuzz_differential.py `_random_system` (a random stable
    plant, n states, m inputs, N in 6-13, x0 and a consistent steady
    state), as (sys, param, x0, xr, ur), param with T = 2 Q and the
    ellipMPC families' terminal radius FUZZ_RADIUS; with `hmpc`,
    w, Te, Th, Se and Sh as its test_fuzz_hmpc_banded_structure sets them
    (drawn from seed 500 + seed)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A *= 0.9 / max(np.abs(np.linalg.eigvals(A)))
    B = rng.standard_normal((n, m))
    sys_ = dict(A=A, B=B, LBx=-2.0 * np.ones(n), UBx=2.0 * np.ones(n),
                LBu=-1.5 * np.ones(m), UBu=1.5 * np.ones(m))
    Qd = rng.uniform(0.5, 5.0, n)
    Rd = rng.uniform(0.1, 1.0, m)
    param = dict(Q=np.diag(Qd), R=np.diag(Rd), N=int(rng.integers(6, 14)))
    x0 = rng.uniform(-0.5, 0.5, n)
    ur = rng.uniform(-0.2, 0.2, m)
    xr = np.linalg.solve(np.eye(n) - A, B @ ur)
    param["T"] = 2.0 * param["Q"]
    param["r"] = FUZZ_RADIUS
    if hmpc:
        r2 = np.random.default_rng(500 + seed)
        param["w"] = float(r2.uniform(0.3, 1.5))
        param["Te"] = 5.0 * param["N"] * param["Q"]
        param["Th"] = param["Te"]
        param["Se"] = param["R"].copy()
        param["Sh"] = 0.5 * param["Se"]
    return sys_, param, x0, xr, ur


def off_fixture_shapes():
    """Phase 18's shapes: (label, horizon, plant or None)."""
    out = [(f"random plant n={n} m={m} (seed {400 + s})", None,
            (400 + s, n, m)) for n, m, s in FUZZ_DIMS]
    return out + [(f"oscillating masses N={h}", h, None)
                  for h in OFF_HORIZONS]


def phase_off_fixture(sp):
    """Every kernel against its plain version on CUDA tensors away from the
    N=30 fixture: each on one family it serves, on the three random plants
    and at N=10 and 31, B=1024, checked and exact-k: every lane converges,
    k agrees on >= 0.9985 of lanes, u within U_TOL, and the builds of each
    lanes a block that take the shape give the same bits. Logs each
    launch plan."""
    for name, fam in OFF_FAMILY.items():
        key, kern, plain, u_at, k_at, u_off = fam_kernel(fam)
        ce = CHECK_EVERY if fam == "laxMPC-ADMM" else 8
        modes = (("checked", dict(check_every=1, exact_k=False)),
                 ("exact-k", dict(check_every=ce, exact_k=True)))
        for label, horizon, seeds in off_fixture_shapes():
            plant = (None if seeds is None else
                     random_plant(*seeds, hmpc=fam in HMPC_FAMILIES))
            where = (dict(horizon=horizon) if plant is None
                     else dict(plant=plant))
            for mode, kw in modes:
                solver = fam_solver(sp, fam, tile_b=TILE_B, k_max=OFF_K_MAX,
                                    **kw, **where)
                args, kk = fam_args(sp, fam, solver, OFF_B, plant=plant)
                out_k = kern(*args, **kk)
                plan = {k: v for k, v in kern.last_plan.items()
                        if not torch.is_tensor(v)} if getattr(
                            kern, "last_plan", None) else {}
                torch.cuda.synchronize()
                out_p = plain(*args, **kk)
                torch.cuda.synchronize()
                a = agreement(out_k, out_p, OFF_B, solver.m, False,
                              u_at=u_at, k_at=k_at, u_off=u_off(solver))
                what = f"{name} {fam} {label} {mode}"
                check_agreement(what, a, phase=18)
                log(f"phase 18 {what}: plan {json.dumps(plan)}")
                check_lanes_bitwise(kern, args, kk, OFF_B, what, 18)


# phase 19: the banded backends and the time-varying mode (ROADMAP queue 1
# item 8) through make_solver on the card, on the oscillating masses
BAND_TOL = 1e-4
BAND_K_MAX = 5000
BAND_FIXED = 100      # the JAX long-horizon record times fixed_iters=100
# the timing depth of phases 19 and 20, which are host-bound and took
# half of the script's time limit, kept small to keep the script inside it
# (the lanes their checks compare are not for cutting): under
# torch.profiler a sequential row's iteration costs tens of times its timed
# wall (PERF.md section 5)
BAND_RUNS = 1         # timed runs a row (wall_ms: their upper median)
BAND_PROFILE = (1, 3)     # fixed_iters of the two profiled runs a row:
                          # their difference is 2 iterations' launches and
                          # device time
BAND_MEMORY_ITERS = 4     # fixed_iters of the N=480 rows' memory analysis
BAND_REF_B = 256      # lanes of a full-size row's fp64 CPU reference
BAND_U_TOL = 1e-8     # fp64 card against fp64 CPU, lanes with equal k
                      # (fp32 against fp64: U_TOL)
BAND_CHECK_B = 256    # the fp64 correctness rows, at N=30
BAND_CONV_B = 1024    # lanes of a full-size row's run to convergence: cut
                      # from 4096 and 2048 to keep the phase's time down
                      # (the timed runs keep the row's B)
LANE_SPREAD = 0.03    # per-lane model factors in [0.97, 1.03]


def _band_param(fam, param, st):
    p = dict(param)
    if fam.startswith("equMPC"):
        p.pop("T")
    elif fam == "MPCT-ADMM-cs":
        p["T"] = 10.0 * np.asarray(p["Q"])
        p["S"] = np.asarray(p["R"]).copy()
    elif fam != "laxMPC-ADMM":      # FISTA and ellipMPC need a diagonal T
        p["T"] = np.diag(np.sum(p["T"], axis=1))
    if fam == "ellipMPC-ADMM":
        p.update(P=np.eye(len(st["xr"])), c=st["xr"], r=R_ELLIP)
    return p


# family -> (formulation, method, submethod, options): laxMPC-ADMM and
# MPCT-ADMM-cs at the JAX long-horizon record's settings
# (tools/bench_longn.py:36-58: rho 15 and 2), ellipMPC-ADMM at the bench's
# N=30 family's (rho 5, P = I, c = xr, r = 0.5)
BAND_FAMILIES = {
    "laxMPC-ADMM": ("laxMPC", "ADMM", "", dict(rho=15.0)),
    "laxMPC-FISTA": ("laxMPC", "FISTA", "", {}),
    "equMPC-ADMM": ("equMPC", "ADMM", "", dict(rho=15.0)),
    "equMPC-FISTA": ("equMPC", "FISTA", "", {}),
    "ellipMPC-ADMM": ("ellipMPC", "ADMM", "", dict(rho=5.0)),
    "MPCT-ADMM-cs": ("MPCT", "ADMM", "cs", dict(rho=2.0)),
}
SCAN = dict(band_parallel_scan=True)
DENSE_W = dict(tv_dense_w=True)
# the correctness rows, fp64 at N=30: (family, time-varying, options)
BAND_CHECKS = tuple((fam, False, {}) for fam in BAND_FAMILIES) + (
    ("laxMPC-ADMM", True, {}), ("laxMPC-ADMM", True, SCAN),
    ("laxMPC-ADMM", True, DENSE_W), ("laxMPC-FISTA", True, {}),
    ("equMPC-ADMM", True, {}), ("equMPC-FISTA", True, {}),
    ("MPCT-ADMM-cs", True, {}))
# the full-size rows, fp32, at the JAX long-horizon record's sizes
# (BENCH_LONGN_r05.json): (family, N, B, backend, time-varying, options)
BAND_ROWS = (
    ("laxMPC-ADMM", 120, 4096, "dense", False, {}),
    ("laxMPC-ADMM", 120, 4096, "banded", False, {}),
    ("laxMPC-ADMM", 120, 4096, "banded", False, SCAN),
    ("laxMPC-ADMM", 480, 1024, "dense", False, {}),
    ("laxMPC-ADMM", 480, 1024, "banded", False, {}),
    ("laxMPC-ADMM", 480, 1024, "banded", False, SCAN),
    ("MPCT-ADMM-cs", 120, 4096, "dense", False, {}),
    ("MPCT-ADMM-cs", 120, 4096, "banded", False, {}),
    ("laxMPC-ADMM", 120, 4096, "dense", True, {}),
    ("laxMPC-ADMM", 120, 4096, "dense", True, SCAN),
    ("laxMPC-ADMM", 120, 4096, "dense", True, DENSE_W),
    ("laxMPC-ADMM", 240, 2048, "dense", True, {}),
    ("laxMPC-ADMM", 240, 2048, "dense", True, SCAN),
    ("laxMPC-ADMM", 240, 2048, "dense", True, DENSE_W),
    ("MPCT-ADMM-cs", 120, 4096, "dense", True, {}),
)


def band_problem(sp, fam, horizon):
    sys_, param, st = sp.systems.tester_fixture()
    return sys_, _band_param(fam, dict(param, N=horizon), st), st


def band_ingredients(sp, fam, horizon, backend):
    """The offline ingredients of a time-invariant row, computed once for
    the card's solvers and the CPU reference (N=480's dense maps take
    seconds of numpy; laxMPC's banded and dense backends read one dict)."""
    from spcies_tpu_torch.formulations import laxmpc, mpct
    form, meth, sub, kw = BAND_FAMILIES[fam]
    sys_, p, _ = band_problem(sp, fam, horizon)
    o = sp.default_options(form, meth, sub, **kw)
    if fam == "MPCT-ADMM-cs":
        make = (mpct.mpct_cs_banded_ingredients if backend == "banded"
                else mpct.mpct_admm_cs_ingredients)
    else:
        make = laxmpc.laxmpc_admm_ingredients
    return make(sys_, p, o)


def band_solver(sp, fam, horizon, *, backend, tv, precision, device,
                ingredients=None, **extra):
    form, meth, sub, kw = BAND_FAMILIES[fam]
    sys_, p, _ = band_problem(sp, fam, horizon)
    o = sp.default_options(form, meth, sub, **{**dict(
        tol=BAND_TOL, k_max=BAND_K_MAX), **kw, **extra})
    o.precision = precision
    o.time_varying = tv
    return sp.make_solver(sys_, p, formulation=form, method=meth,
                          submethod=sub, options=o, backend=backend,
                          device=device, ingredients=ingredients)


def band_inputs(sp, fam, horizon, B, seed, tv):
    """x0 scaled per lane in [-2, 2] as problem() draws it; for the
    time-varying rows each lane's own model: A, B, and the Q and R
    diagonals each scaled by a factor in [0.97, 1.03] drawn per lane
    (tests/test_time_varying.py's scale_A, one value a lane), and the
    nominal single-stage bounds."""
    sys_, p, st = band_problem(sp, fam, horizon)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    x = (x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1)))
    if not tv:
        return x
    f = rng.uniform(1 - LANE_SPREAD, 1 + LANE_SPREAD, (B, 4))
    stage = lambda lo, hi: np.tile(np.concatenate([sys_[lo], sys_[hi]]),
                                   (B, 1))
    return x + (f[:, 0, None, None] * np.asarray(sys_["A"]),
                f[:, 1, None, None] * np.asarray(sys_["B"]),
                f[:, 2, None] * np.diag(np.asarray(p["Q"])),
                f[:, 3, None] * np.diag(np.asarray(p["R"])),
                stage("LBx", "LBu"), stage("UBx", "UBu"))


def band_label(fam, horizon, B, backend, tv, extra):
    how = ("scan" if extra.get("band_parallel_scan") else
           "dense W" if extra.get("tv_dense_w") else
           "sequential" if backend == "banded" or tv else backend)
    return f"{fam}{' time-varying' if tv else ''} {how} N={horizon} B={B}"


def hold_lanes(what, got, ref, phase=19):
    """Per-lane k of two runs: the lanes that move are named. Returns (k
    agreement, largest u error on the lanes with equal k, moved lanes,
    their moves, both runs' every lane converged)."""
    kg, kr = got.k.cpu().numpy(), ref.k.cpu().numpy()
    moved = np.flatnonzero(kg != kr)
    if moved.size:
        log(f"phase {phase} {what}: lanes {moved.tolist()} move by "
            f"{(kg[moved] - kr[moved]).tolist()} iterations")
    same = kg == kr
    u_err = float(np.abs(got.u.cpu().double().numpy()
                         - ref.u.cpu().numpy())[same].max())
    converged = bool((got.e_flag == 1).all()) and bool(
        (ref.e_flag == 1).all())
    return float(same.mean()), u_err, moved, kg[moved] - kr[moved], converged


def profile_run(run):
    """(device activities, device ms) of one call of run() under
    torch.profiler: kernels, copies and fills on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3


def wall_ms(run, reps):
    """The upper median of reps calls' host walls, each CUDA-synchronised
    (of two, the slower), all of them, and the last call's result."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times, res


def time_and_profile(fixed, B, out):
    """Into `out`: BAND_RUNS timed runs of fixed(BAND_FIXED) (wall_ms's
    upper median, solves/s and the peak of allocated memory), and two
    profiled runs, fixed(i) for i in BAND_PROFILE, whose difference gives
    an iteration's launches and device time (the idle share: against the
    timed runs' wall an iteration); and the seconds each part took.
    Returns the last timed run's result."""
    t0 = time.perf_counter()
    ms, times, res = wall_ms(lambda: fixed(BAND_FIXED), BAND_RUNS)
    out.update(ms=ms, ms_all=times, solves_per_s=B / ms * 1e3,
               fixed_iters=BAND_FIXED,
               peak_mb=torch.cuda.max_memory_allocated() / 2**20)
    t1 = time.perf_counter()
    (n1, dev1), (n2, dev2) = (profile_run(lambda: fixed(i))
                              for i in BAND_PROFILE)
    span = BAND_PROFILE[1] - BAND_PROFILE[0]
    dev_it = (dev2 - dev1) / span
    out.update(launches_per_iter=(n2 - n1) / span,
               launches_profiled=(n1, n2), device_ms_per_iter=dev_it,
               idle_share=1.0 - dev_it / (ms / BAND_FIXED),
               timed_s=t1 - t0, profiled_s=time.perf_counter() - t1)
    return res


# The fp64 CPU runs that phases 19 and 20 hold the card to: host work of
# small batched operations, one thread each, about half of the two phases'
# time when run in turn with the card's. main() starts them in CPU_WORKERS
# processes of their own before phase 18, so that they run beside phases
# 18-20's card work; a phase run alone computes its runs here instead.
CPU_WORKERS = 4
_CPU_POOL: list = []          # the pool, while it runs
_CPU_RUNS: dict = {}          # job -> its future


def _items(extra):
    return tuple(sorted(extra.items()))


def cpu_jobs():
    """Every fp64 CPU run of phases 19 and 20, in the order they read
    them: phase 19's correctness rows, its full-size rows' references (one
    a family, horizon and mode, drawn at the row's B), phase 20's
    correctness rows."""
    refs = {}
    for fam, horizon, B, _backend, tv, _extra in BAND_ROWS:
        refs.setdefault((fam, horizon, tv), B)
    return ([("band check", fam, tv, _items(extra))
             for fam, tv, extra in BAND_CHECKS]
            + [("band ref", fam, horizon, B, tv)
               for (fam, horizon, tv), B in refs.items()]
            + [("long check", fam, _items(extra))
               for fam, extra in LONG_CHECKS])


def cpu_reference(job):
    """One fp64 run on the CPU: (u, k, e_flag) as numpy arrays and its
    seconds. "band check": a phase-19 correctness row's solver and inputs;
    "band ref": the sequential banded (or time-varying) solver on the
    first BAND_REF_B lanes of a full-size row's inputs, the same iteration
    as every backend of the row; "long check": a phase-20 correctness
    row's."""
    import spcies_tpu_torch as sp
    t0 = time.perf_counter()
    kind, fam, *rest = job
    if kind == "band check":
        tv, extra = rest[0], dict(rest[1])
        x = band_inputs(sp, fam, N, BAND_CHECK_B, 190, tv)
        res = band_solver(sp, fam, N, backend="dense" if tv else "banded",
                          tv=tv, precision="double", device="cpu",
                          **extra)(*x)
    elif kind == "band ref":
        horizon, B, tv = rest
        x = band_inputs(sp, fam, horizon, B, 19, tv)
        ing = None if tv else band_ingredients(sp, fam, horizon, "banded")
        res = band_solver(sp, fam, horizon, backend="banded", tv=tv,
                          precision="double", device="cpu",
                          ingredients=ing)(*(a[:BAND_REF_B] for a in x))
    else:
        x = long_inputs(sp, fam, N, BAND_CHECK_B, 200)
        res = long_solver(sp, fam, N, "banded", "double", "cpu",
                          **dict(rest[0]))(*x)
    return (res.u.numpy(), res.k.numpy(), res.e_flag.numpy(),
            time.perf_counter() - t0)


def _cpu_worker():
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")


def start_cpu_runs():
    """Start every cpu_jobs() run in CPU_WORKERS fresh processes (spawned:
    this process holds a CUDA context), one torch thread each."""
    import multiprocessing
    pool = ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker)
    _CPU_POOL.append(pool)
    for job in cpu_jobs():
        _CPU_RUNS[job] = pool.submit(cpu_reference, job)


def stop_cpu_runs():
    """Drop the runs not started and wait for the pool's processes."""
    while _CPU_POOL:
        _CPU_POOL.pop().shutdown(wait=True, cancel_futures=True)
    _CPU_RUNS.clear()


class CpuRun:
    """An fp64 CPU run's u, k and e_flag as CPU tensors."""

    def __init__(self, u, k, e_flag):
        self.u, self.k, self.e_flag = (torch.from_numpy(a)
                                       for a in (u, k, e_flag))


def cpu_run(job):
    """(CpuRun, its seconds of CPU, seconds this phase waited for it): from
    the pool where main() started it, else run here."""
    t0 = time.perf_counter()
    fut = _CPU_RUNS.get(job)
    u, k, e_flag, seconds = (fut.result() if fut is not None
                             else cpu_reference(job))
    return CpuRun(u, k, e_flag), seconds, time.perf_counter() - t0


def band_row(sp, row, refs):
    """One full-size fp32 row: a run to convergence held against the
    fp64 CPU run of its first BAND_REF_B lanes, BAND_RUNS timed runs at
    fixed_iters=BAND_FIXED, the peak of allocated memory, and two
    profiled runs, whose difference gives an iteration's launches and
    device time (the idle share: against the timed runs' wall an
    iteration)."""
    fam, horizon, B, backend, tv, extra = row
    what = band_label(*row)
    key = (fam, horizon, tv)
    t_row = time.perf_counter()

    def ingredients(backend):
        if tv:
            return None
        ing_key = (key, backend if fam == "MPCT-ADMM-cs" else "")
        if ing_key not in refs:
            t0 = time.perf_counter()
            refs[ing_key] = band_ingredients(sp, fam, horizon, backend)
            log(f"phase 19 {fam} N={horizon} {backend} ingredients: "
                f"{time.perf_counter() - t0:.1f} s")
        return refs[ing_key]

    x = band_inputs(sp, fam, horizon, B, 19, tv)
    if key not in refs:
        # the fp64 CPU reference: the sequential banded or time-varying
        # solver, the same iteration as every backend of the row
        refs[key], seconds, waited = cpu_run(("band ref", fam, horizon, B,
                                              tv))
        ref_what = band_label(fam, horizon, BAND_REF_B, "banded", tv, {})
        log(f"phase 19 {ref_what} fp64 CPU reference: {seconds:.1f} s "
            f"(waited {waited:.1f} s)")
    ing = ingredients(backend)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = dict(row=what)
    try:
        s = band_solver(sp, fam, horizon, backend=backend, tv=tv,
                        precision="float", device=DEVICE, ingredients=ing,
                        **extra)
        xd = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
              for a in x]
        t0 = time.perf_counter()
        res = s(*(a[:BAND_CONV_B] for a in xd))
        torch.cuda.synchronize()
        out["converge_ms"] = (time.perf_counter() - t0) * 1e3
        out["converge_B"] = res.k.shape[0]
        out["converged"] = float((res.e_flag == 1).float().mean())
        out["k_mean"] = float(res.k.float().mean())
        out["k_max"] = int(res.k.max())
        agree, u_err, moved, moves, _ = hold_lanes(
            what, type(res)(res.u[:BAND_REF_B], res.k[:BAND_REF_B],
                            res.e_flag[:BAND_REF_B], {}), refs[key])
        out.update(k_agree=agree, u_err_vs_fp64=u_err,
                   moved=dict(zip(moved.tolist(), moves.tolist())))
        time_and_profile(lambda iters: s(*xd, fixed_iters=iters), B, out)
        out["row_s"] = time.perf_counter() - t_row
        log("phase 19 " + json.dumps(out))
        # fp32 against fp64: the same code moves a few per cent of lanes by
        # one iteration at tol 1e-4 (fp32 against fp64, and fp32 dense
        # against fp32 banded, on the CPU alike), so the bar is one
        # iteration on every lane, not K_AGREE
        assert out["converged"] == 1.0, (what, out["converged"])
        assert not moved.size or np.abs(moves).max() <= 1, (what, moves)
        assert u_err <= U_TOL, (what, u_err)
    except torch.cuda.OutOfMemoryError as exc:
        # the one failure this phase records rather than raises: the
        # per-lane dense W's memory is the measurement
        if not extra.get("tv_dense_w"):
            raise
        out.update(out_of_memory=str(exc).splitlines()[0],
                   peak_mb=torch.cuda.max_memory_allocated() / 2**20)
        log("phase 19 " + json.dumps(out))
    finally:
        s = res = None
        torch.cuda.empty_cache()
    return out


def phase_banded(sp):
    """Phase 19: the banded backends and the time-varying mode on the
    card. The correctness rows (fp64, N=30, B=BAND_CHECK_B) against the same
    solver on the CPU, then the full-size fp32 rows (BAND_ROWS)."""
    t0 = time.perf_counter()
    for fam, tv, extra in BAND_CHECKS:
        backend = "dense" if tv else "banded"
        what = band_label(fam, N, BAND_CHECK_B, backend, tv, extra)
        x = band_inputs(sp, fam, N, BAND_CHECK_B, 190, tv)
        got = band_solver(sp, fam, N, backend=backend, tv=tv,
                          precision="double", device=DEVICE, **extra)(*x)
        ref, seconds, waited = cpu_run(("band check", fam, tv,
                                        _items(extra)))
        agree, u_err, moved, moves, converged = hold_lanes(what, got, ref)
        log(f"phase 19 {what} fp64 card vs CPU: every lane converged "
            f"{converged}, k equal on {agree}, k_mean "
            f"{float(got.k.double().mean())}, max|du| {u_err} (CPU run "
            f"{seconds:.1f} s, waited {waited:.1f} s; "
            f"{time.perf_counter() - t0:.1f} s into the phase)")
        assert converged, what
        assert not moved.size or np.abs(moves).max() <= 1, (what, moves)
        assert u_err <= BAND_U_TOL, (what, u_err)
    refs, rows = {}, []
    for row in BAND_ROWS:
        rows.append(band_row(sp, row, refs))
    log(f"phase 19 wall: {time.perf_counter() - t0:.1f} s")
    return rows


# phase 20: the banded backends of HMPC-ADMM, the HMPC split pair and
# MPCT-ADMM-semiband, backend="auto" and the measured memory analysis, on
# the oscillating masses. family -> (formulation, method, submethod,
# options): MPCT-ADMM-semiband and HMPC-ADMM-split at the JAX long-horizon
# record's settings (tools/bench_longn.py:44-49: rho 0.5; rho 2, sigma
# 20), HMPC-ADMM and HMPC-SADMM-split at the split's
LONG_FAMILIES = {
    "HMPC-ADMM": ("HMPC", "ADMM", "", dict(rho=2.0, sigma=20.0)),
    "HMPC-ADMM-split": ("HMPC", "ADMM", "split", dict(rho=2.0, sigma=20.0)),
    "HMPC-SADMM-split": ("HMPC", "SADMM", "split",
                         dict(rho=2.0, sigma=20.0)),
    "MPCT-ADMM-semiband": ("MPCT", "ADMM", "semiband", dict(rho=0.5)),
}
SOFT_OUTPUT = dict(soft_constraints=True, constrained_output=True, beta=2.0)
VECTOR_RHO = dict(rho="vector")     # a per-entry rho drawn from seed 3
# the correctness rows, fp64 at N=30, B=BAND_CHECK_B, the card against the
# CPU: (family, options)
LONG_CHECKS = (
    ("HMPC-ADMM", {}), ("HMPC-ADMM", SCAN), ("HMPC-ADMM-split", {}),
    ("HMPC-SADMM-split", {}), ("MPCT-ADMM-semiband", {}),
    ("MPCT-ADMM-semiband", SOFT_OUTPUT), ("MPCT-ADMM-semiband", VECTOR_RHO),
    ("MPCT-ADMM-semiband", SCAN))
# the full-size fp32 rows, (family, N, B): the JAX long-horizon record's
# (BENCH_LONGN_r05.json rows 11-14) and HMPC-ADMM at N=120; each on the
# dense engine, the sequential band solve and the scan
LONG_ROWS = (("HMPC-ADMM-split", 480, 1024),
             ("MPCT-ADMM-semiband", 480, 1024), ("HMPC-ADMM", 120, 4096))
LONG_BACKENDS = (("dense", {}), ("banded", {}), ("banded", SCAN))
# the run to convergence of each family on the scan, against an fp64 run
# of the card's dense engine
LONG_CONV_N = 120
LONG_CONV = ("HMPC-ADMM", "HMPC-ADMM-split", "MPCT-ADMM-semiband")
# the largest move of a lane's k, fp32 on the scan against the fp64 dense
# engine, that the CPU shows on long_converge's lanes
# (tools/banded_fp32_cpu.py --long 1024, PERF.md §6): HMPC-ADMM's
# residual creeps along tol 1e-4 and fp32 moves its k by up to 21
# iterations on the dense engine and 22 on the scan; the others move by
# one at most
LONG_MOVE = {"HMPC-ADMM": 22}
# the auto probes: (family, N); at N=480 K7's width cap refuses fused
AUTO_PROBES = (("laxMPC-ADMM", N), ("HMPC-ADMM-split", N),
               ("HMPC-ADMM-split", 480))
AUTO_B = 1024       # the probe's batch, and the chosen solver's lanes
AUTO_FUSED = dict(tile_b=TILE_B, check_every=8, exact_k=True)


def long_problem(sp, fam, horizon, output=False):
    """The fixture at `horizon` with the family's parameters: HMPC's
    tests/test_hmpc.py:14-25 (w = 3 * 1.627 * 0.2, Te = Th = 10 N Q,
    Se = R, Sh = R / 2), MPCT's T = 10 Q and S = R; `output` adds the
    three mass positions as constrained outputs within +-0.25."""
    sys_, param, st = sp.systems.tester_fixture()
    p = dict(param, N=horizon)
    if LONG_FAMILIES[fam][0] == "HMPC":
        p.pop("T", None)
        p.update(w=3 * 1.627 * 0.2, Te=10 * horizon * np.asarray(p["Q"]),
                 Se=np.asarray(p["R"]).copy())
        p.update(Th=p["Te"], Sh=0.5 * p["Se"])
    else:
        p.update(T=10.0 * np.asarray(p["Q"]), S=np.asarray(p["R"]).copy())
    if output:
        n_x, m_u = np.asarray(sys_["B"]).shape
        sys_ = dict(sys_, C=np.eye(3, n_x), D=np.zeros((3, m_u)),
                    LBy=-0.25 * np.ones(3), UBy=0.25 * np.ones(3))
    return sys_, p, st


def long_solver(sp, fam, horizon, backend, precision, device, **extra):
    form, meth, sub, kw = LONG_FAMILIES[fam]
    sys_, p, _ = long_problem(sp, fam, horizon,
                              extra.get("constrained_output", False))
    if extra.get("rho") == "vector":
        nv = (horizon + 1) * sum(np.asarray(sys_["B"]).shape)
        extra = dict(extra, rho=0.3 + 0.4 * np.random.default_rng(3)
                     .random(nv))
    o = sp.default_options(form, meth, sub, **{**dict(
        tol_p=BAND_TOL, tol_d=BAND_TOL, k_max=BAND_K_MAX), **kw, **extra})
    o.precision = precision
    return sp.make_solver(sys_, p, formulation=form, method=meth,
                          submethod=sub, options=o, backend=backend,
                          device=device)


def long_inputs(sp, fam, horizon, B, seed):
    """x0 scaled per lane in [-1.5, 1.5], as the JAX long-horizon record
    draws it (tools/bench_longn.py:147)."""
    _, _, st = long_problem(sp, fam, horizon)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def long_label(fam, horizon, B, backend, extra):
    what = band_label(fam, horizon, B, backend, False, extra)
    return what + ("".join(f" {key}" for key in ("soft_constraints",
                                                  "constrained_output")
                           if extra.get(key))
                   + (" vector rho" if extra.get("rho") else ""))


def long_row(sp, fam, horizon, B, backend, extra):
    """One full-size fp32 row: the build, a warm-up run of one iteration,
    BAND_RUNS timed runs at fixed_iters=BAND_FIXED (the last one's u
    finite), two profiled runs (time_and_profile), and at N=480 the
    measured memory analysis beside the allocator's peak."""
    what = long_label(fam, horizon, B, backend, extra)
    x = long_inputs(sp, fam, horizon, B, 20)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = dict(row=what)
    t_row = time.perf_counter()
    try:
        t0 = time.perf_counter()
        s = long_solver(sp, fam, horizon, backend, "float", DEVICE, **extra)
        out["build_s"] = time.perf_counter() - t0
        xd = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
              for a in x]

        def fixed(iters):
            return s(*xd, fixed_iters=iters)

        fixed(1)
        res = time_and_profile(fixed, B, out)
        assert bool(torch.isfinite(res.u).all()), what
        res = None
        if horizon == 480:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            mem = s.aot_memory_analysis(*x, fixed_iters=BAND_MEMORY_ITERS)
            out.update(memory=mem, max_memory_allocated_mb=(
                torch.cuda.max_memory_allocated() / 2**20),
                memory_s=time.perf_counter() - t0)
            assert mem["peak_bytes"] > 0, (what, mem)
        out["row_s"] = time.perf_counter() - t_row
        log("phase 20 " + json.dumps(out))
    finally:
        s = None
        torch.cuda.empty_cache()
    return out


def long_converge(sp, fam):
    """A family's scan solver, fp32, run to convergence on BAND_CONV_B
    lanes at LONG_CONV_N, against an fp64 run of the card's dense engine
    on the same lanes: every lane converged, k within LONG_MOVE (one
    iteration unless named) and u within U_TOL where k is equal, the bar
    the CPU sets (tools/banded_fp32_cpu.py)."""
    what = long_label(fam, LONG_CONV_N, BAND_CONV_B, "banded", SCAN)
    x = long_inputs(sp, fam, LONG_CONV_N, BAND_CONV_B, 21)
    t0 = time.perf_counter()
    ref = long_solver(sp, fam, LONG_CONV_N, "dense", "double", DEVICE)(*x)
    ref_s = time.perf_counter() - t0
    s = long_solver(sp, fam, LONG_CONV_N, "banded", "float", DEVICE, **SCAN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = s(*x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    agree, u_err, moved, moves, converged = hold_lanes(what, res, ref, 20)
    out = dict(row=what, converge_ms=ms, k_mean=float(res.k.float().mean()),
               k_max=int(res.k.max()),
               k_mean_fp64_dense=float(ref.k.double().mean()),
               converged=converged, k_agree=agree, u_err_vs_fp64=u_err,
               moved=dict(zip(moved.tolist(), moves.tolist())),
               fp64_dense_s=ref_s)
    log("phase 20 " + json.dumps(out))
    assert converged, what
    assert not moved.size or np.abs(moves).max() <= LONG_MOVE.get(fam, 1), (
        what, moves)
    assert u_err <= U_TOL, (what, u_err)
    return out


def auto_solver(sp, fam, horizon):
    """make_solver(backend="auto") in fp32 on the card: laxMPC-ADMM at the
    headline's settings, the HMPC split at LONG_FAMILIES'; both with the
    fused kernels' exact-k tuning; the probe at AUTO_B lanes."""
    probe = dict(auto_probe_batch=AUTO_B)
    if fam == "laxMPC-ADMM":
        sys_, p, _ = problem(sp, 0, 1, horizon)
        return sp.make_solver(sys_, p, formulation="laxMPC", method="ADMM",
                              options=headline_options(
                                  sp, **dict(AUTO_FUSED,
                                             check_every=CHECK_EVERY),
                                  **probe),
                              backend="auto")
    return long_solver(sp, fam, horizon, "auto", "float", DEVICE,
                       **AUTO_FUSED, **probe)


def phase_auto(sp):
    """make_solver(backend="auto") on the card with a fresh cache
    directory: each AUTO_PROBES entry probes its candidates (the fused
    one launches K1 or K7; at N=480 K7's width cap refuses it at build)
    and logs its choice and probe times; a second make_solver hits the
    cache and builds only the winner, which converges on every lane of
    AUTO_B. Returns the K1 and K7 launches of this path."""
    import tempfile
    from spcies_tpu_torch.formulations import base
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.kernels.fused_split import fused_split_solve
    old_dir = os.environ.get("SPCIES_AUTO_CACHE_DIR")
    launches = dict(fused_admm=0, fused_split=0)
    with tempfile.TemporaryDirectory() as cache:
        os.environ["SPCIES_AUTO_CACHE_DIR"] = cache
        try:
            for fam, horizon in AUTO_PROBES:
                form, meth, sub = (("laxMPC", "ADMM", "")
                                   if fam == "laxMPC-ADMM"
                                   else LONG_FAMILIES[fam][:3])
                real = base.BUILDERS[(form, meth, sub)]
                builds = []

                def counting(*args, backend="dense", **kw):
                    builds.append(backend)
                    return real(*args, backend=backend, **kw)

                base.BUILDERS[(form, meth, sub)] = counting
                try:
                    fused_admm_solve.launches = 0
                    fused_split_solve.launches = 0
                    t0 = time.perf_counter()
                    s1 = auto_solver(sp, fam, horizon)
                    first_s = time.perf_counter() - t0
                    probed = list(builds)
                    t0 = time.perf_counter()
                    s2 = auto_solver(sp, fam, horizon)
                    second_s = time.perf_counter() - t0
                    cached_builds = builds[len(probed):]
                    if fam == "laxMPC-ADMM":
                        x = problem(sp, 20, AUTO_B, horizon)[2]
                    else:
                        x = long_inputs(sp, fam, horizon, AUTO_B, 20)
                    res = s2(*x)
                    k1 = fused_admm_solve.launches
                    k7 = fused_split_solve.launches
                finally:
                    base.BUILDERS[(form, meth, sub)] = real
                launches["fused_admm"] += k1
                launches["fused_split"] += k7
                out = dict(probe=f"{fam} N={horizon}",
                           choice=s1.backend_choice,
                           probe_s=s1.backend_probe_s, built=probed,
                           first_make_solver_s=first_s,
                           cached=s2.backend_probe_cached,
                           cached_choice=s2.backend_choice,
                           cached_built=cached_builds,
                           second_make_solver_s=second_s,
                           k1_launches=k1, k7_launches=k7,
                           converged=float((res.e_flag == 1).float()
                                           .mean()),
                           k_mean=float(res.k.float().mean()))
                log("phase 20 auto " + json.dumps(out))
                assert s2.backend_probe_cached, out
                assert cached_builds == [s1.backend_choice], out
                assert s2.backend_choice == s1.backend_choice, out
                assert out["converged"] == 1.0, out
                # the fused candidate: probed (and its kernel launched)
                # at N=30, refused at build by K7's width cap at N=480
                if horizon == N:
                    assert "fused" in s1.backend_probe_s, out
                    assert (k1 if fam == "laxMPC-ADMM" else k7) > 0, out
                else:
                    assert "fused" not in s1.backend_probe_s, out
        finally:
            if old_dir is None:
                os.environ.pop("SPCIES_AUTO_CACHE_DIR", None)
            else:
                os.environ["SPCIES_AUTO_CACHE_DIR"] = old_dir
    return launches


def phase_long(sp):
    """Phase 20: the banded backends of HMPC-ADMM, the HMPC split pair and
    MPCT-ADMM-semiband on the card: the correctness rows (LONG_CHECKS,
    fp64, N=30, B=BAND_CHECK_B) against the same solver on the CPU, the
    full-size fp32 rows (LONG_ROWS x LONG_BACKENDS), the runs to
    convergence (LONG_CONV), and backend="auto" (phase_auto). Returns the
    auto path's kernel launches."""
    t0 = time.perf_counter()
    for fam, extra in LONG_CHECKS:
        what = long_label(fam, N, BAND_CHECK_B, "banded", extra)
        x = long_inputs(sp, fam, N, BAND_CHECK_B, 200)
        got = long_solver(sp, fam, N, "banded", "double", DEVICE,
                          **extra)(*x)
        ref, seconds, waited = cpu_run(("long check", fam, _items(extra)))
        agree, u_err, moved, moves, converged = hold_lanes(what, got, ref,
                                                           20)
        log(f"phase 20 {what} fp64 card vs CPU: every lane converged "
            f"{converged}, k equal on {agree}, k_mean "
            f"{float(got.k.double().mean())}, max|du| {u_err} (CPU run "
            f"{seconds:.1f} s, waited {waited:.1f} s; "
            f"{time.perf_counter() - t0:.1f} s into the phase)")
        assert converged, what
        assert not moved.size or np.abs(moves).max() <= 1, (what, moves)
        assert u_err <= BAND_U_TOL, (what, u_err)
    for fam, horizon, B in LONG_ROWS:
        for backend, extra in LONG_BACKENDS:
            long_row(sp, fam, horizon, B, backend, extra)
    log(f"phase 20 rows: {time.perf_counter() - t0:.1f} s into the phase")
    for fam in LONG_CONV:
        long_converge(sp, fam)
    launches = phase_auto(sp)
    log(f"phase 20 wall: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 21: scale-out (spcies_tpu_torch.parallel) on the card
# ---------------------------------------------------------------------------

# torchrun's variables, which no phase but 21's children may find set
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK")
SCALE_SHARDS = (4, 16)   # logical shards of the headline batch on one card
CHILD_TIMEOUT = 300      # seconds for a child process (phases 21 and 23)
DENSE_WARM_B = 256       # lanes a process of the fp64 warm start across two
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
               "all_gather_into_tensor", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "barrier", "gather",
               "scatter", "send", "recv", "isend", "irecv")


def scale_out_solver(sp, device=None):
    """The headline fused solver (exact-k, check_every 16) with timing off,
    so that no phase mark synchronises the card inside a sharded solve."""
    solver = fused_solver(sp, device=device or DEVICE, tile_b=TILE_B,
                          check_every=CHECK_EVERY, exact_k=True)
    solver.options.timing = False
    return solver


def count_collectives():
    """Wrap every collective of torch.distributed, in its namespace and in
    distributed_c10d, with a counter for the rest of the process; returns
    the dict of calls by name."""
    import torch.distributed as dist
    calls = {}
    c10d = dist.distributed_c10d
    for name in COLLECTIVES:
        orig = getattr(c10d, name, None)
        if orig is None:
            continue

        def counted(*args, _name=name, _orig=orig, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args, **kw)
        setattr(dist, name, counted)
        setattr(c10d, name, counted)
    return calls


def same_bits(a, b, what):
    """Two SolveResults equal bit for bit: u, k, e_flag and every batched
    tensor of sol."""
    for key in ("u", "k", "e_flag"):
        assert torch.equal(getattr(a, key), getattr(b, key)), (what, key)
    for key, val in b.sol.items():
        if torch.is_tensor(val) and val.ndim:
            assert torch.equal(a.sol[key], val), (what, key)


def per_shard_bits(res, solver, inputs, n_shards, what):
    """res equals a separate call of the solver on each shard's lanes, bit
    for bit."""
    per = res.k.shape[0] // n_shards
    for j in range(n_shards):
        sl = slice(j * per, (j + 1) * per)
        part = solver(*(a[sl] for a in inputs))
        sub = type(res)(u=res.u[sl], k=res.k[sl], e_flag=res.e_flag[sl],
                        sol={k: v[sl] for k, v in res.sol.items()
                             if torch.is_tensor(v) and v.ndim})
        same_bits(sub, part, f"{what} shard {j}")


def profiled_launches(run, kernel):
    """(run()'s result, the launches of `kernel` torch.profiler saw, and
    every device activity it saw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    return out, sum(1 for name in device if kernel in name), len(device)


def run_processes(cmds, cwd=None, extras=None):
    """Run this interpreter with each argument list of `cmds`, all at once,
    from `cwd` (the repository's root by default) with the repository on
    the path and each run's environment additions of `extras`; each must
    exit 0 within CHILD_TIMEOUT. Returns [(stdout, seconds to its end)]; a
    process still running at an error is killed."""
    root = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items()
           if k not in LAUNCHER_VARS + ("SPCIES_LOG_DIR",)}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=cwd or root,
                              env={**env, **extra}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, extra in zip(cmds, extras or [{}] * len(cmds))]
    outs = []
    try:
        for cmd, p in zip(cmds, procs):
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)[:200]} exited "
                                   f"{p.returncode}:\n{out[-3000:]}\n"
                                   f"{err[-3000:]}")
            outs.append((out, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_children(runs):
    """Run python -c `code` once for each (code, argv, environment
    additions) of `runs`, all at once, from the repository's root
    (run_processes); each must print a line 'RESULT <json>'. Returns the
    parsed results."""
    outs = run_processes([["-c", code, *argv] for code, argv, _ in runs],
                         extras=[extra for _, _, extra in runs])
    results = []
    for out, _seconds in outs:
        line = [s for s in out.splitlines() if s.startswith("RESULT ")]
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def free_ports(n):
    """n distinct free ports of localhost."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [str(s.getsockname()[1]) for s in socks]
    finally:
        for s in socks:
            s.close()


# (a) one process without torchrun's variables, started fresh, so that
# torch.profiler's first session counts the launches
CHILD_SINGLE = r"""
import json, os
import torch
import torch.distributed as dist
import chip_smoke as c
import spcies_tpu_torch as sp
from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
torch.set_float32_matmul_precision("highest")
present = [k for k in c.LAUNCHER_VARS if os.environ.get(k)]
assert not present, present
assert sp.parallel.initialize() is False and not dist.is_initialized()
mesh = sp.parallel.host_chip_mesh()
assert mesh.devices.shape == (1, torch.cuda.device_count()), mesh
solver = c.scale_out_solver(sp)
_, _, inputs = c.problem(sp, 0, c.BATCH)
x = [torch.as_tensor(a, dtype=torch.float32, device=c.DEVICE)
     for a in inputs]
solve = sp.parallel.shard_map_solver(solver, mesh)
fused_admm_solve.launches = 0
res, seen, _ = c.profiled_launches(lambda: solve(*x), "fused_admm_kernel")
launches = fused_admm_solve.launches
c.per_shard_bits(res, solver, x, mesh.size, "phase 21 (a)")
print("RESULT " + json.dumps(dict(launches=launches, seen=seen,
                                  mesh=list(mesh.devices.shape))),
      flush=True)
"""

# (d) a world of one process under torchrun's variables: NCCL
CHILD_NCCL = r"""
import json
import torch
import torch.distributed as dist
import chip_smoke as c
import spcies_tpu_torch as sp
from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
torch.set_float32_matmul_precision("highest")
assert sp.parallel.initialize() is False
assert dist.is_initialized() and dist.get_backend() == "nccl"
mesh = sp.parallel.host_chip_mesh()
assert mesh.devices.shape == (1, 1), mesh
assert mesh.local_entries[0][1] == torch.device("cuda", 0), mesh
solver = c.scale_out_solver(sp)
_, _, inputs = c.problem(sp, 4, c.FB)
solve = sp.parallel.shard_map_solver(solver, mesh)
calls = c.count_collectives()
fused_admm_solve.launches = 0
res = solve(*inputs)
torch.cuda.synchronize()
launches = fused_admm_solve.launches
assert calls == {}, calls
g = sp.parallel.global_fleet_metrics(res, mesh)
assert calls == {"all_reduce": 2}, calls
f = sp.parallel.fleet_metrics(res)
assert g == dict(f, n_hosts=1, n_devices=1), (g, f)
assert g["n_converged"] == g["n_lanes"] == c.FB, g
print("RESULT " + json.dumps(dict(metrics=g, launches=launches,
                                  backend=dist.get_backend())), flush=True)
dist.destroy_process_group()
"""

# (e) two processes on one card over gloo, each with its own lanes
CHILD_GLOO = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as c
import spcies_tpu_torch as sp
from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
pid, port = int(sys.argv[1]), sys.argv[2]
torch.set_float32_matmul_precision("highest")
assert sp.parallel.initialize(coordinator_address=f"localhost:{port}",
                              num_processes=2, process_id=pid,
                              local_device_ids=[0], backend="gloo")
assert dist.get_backend() == "gloo"
mesh = sp.parallel.host_chip_mesh()
assert mesh.devices.shape == (2, 1), mesh
B = c.BATCH // 2
_, _, st = sp.systems.tester_fixture()
rng = np.random.default_rng(200 + pid)
x0_l = np.asarray(st["x"])[None, :] * rng.uniform(
    -2 - 0.4 * pid, 2 + 0.4 * pid, (B, 1))
xr_l, ur_l = np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))
solver = c.scale_out_solver(sp)
solve = sp.parallel.shard_map_solver(solver, mesh)
tagged = [sp.parallel.from_process_local(mesh, a) for a in (x0_l, xr_l, ur_l)]
calls = c.count_collectives()
fused_admm_solve.launches = 0
res = solve(*tagged)
torch.cuda.synchronize()
launches = fused_admm_solve.launches
assert calls == {}, calls
m = sp.parallel.global_fleet_metrics(res, mesh)
assert calls == {"all_reduce": 2}, calls
assert m["n_converged"] == m["n_lanes"] == 2 * B, m
assert m["n_hosts"] == 2 and m["n_devices"] == 2, m
# this process's lanes against a local solve of them
c.same_bits(res, solver(x0_l, xr_l, ur_l), f"process {pid} lanes")
# a dense fp64 warm start across the two processes exits at once
dense = c.fused_solver(sp, device=c.DEVICE, backend="dense",
                       precision="double")
solve_d = sp.parallel.shard_map_solver(dense, mesh)
xd = [sp.parallel.from_process_local(mesh, a[:c.DENSE_WARM_B])
      for a in (x0_l, xr_l, ur_l)]
cold = solve_d(*xd)
calls.clear()
warm = solve_d(*xd, init=(cold.sol["z"], cold.sol["v"], cold.sol["lam"]))
assert calls == {}, calls
m_cold = sp.parallel.global_fleet_metrics(cold, mesh)
m_warm = sp.parallel.global_fleet_metrics(warm, mesh)
assert m_cold["n_converged"] == m_cold["n_lanes"], m_cold
assert m_warm["n_converged"] == m_warm["n_lanes"], m_warm
assert m_warm["k_max"] <= 2, m_warm
print("RESULT " + json.dumps(dict(metrics=m, cold=m_cold, warm=m_warm,
                                  launches=launches)), flush=True)
dist.destroy_process_group()
"""


def phase_scale_out(sp):
    """Phase 21: the scale-out entry points (spcies_tpu_torch.parallel) on
    the card, every shard through its replica's BatchedSolver.__call__.
    Returns K1's and K7's launches on these paths."""
    from spcies_tpu_torch.api import _replica
    from spcies_tpu_torch.entry import dryrun_multichip
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    from spcies_tpu_torch.kernels.fused_split import fused_split_solve
    t0 = time.perf_counter()
    launches = {"fused_admm": 0, "fused_split": 0}

    # the child processes of (a), (d) and (e), all at once, and before
    # this process's own runs, so that (b)'s times do not share the card
    # with them
    nccl_port, gloo_port = free_ports(2)
    a, d, *gloo = run_children(
        [(CHILD_SINGLE, (), {}),
         (CHILD_NCCL, (), dict(MASTER_ADDR="localhost",
                               MASTER_PORT=nccl_port, WORLD_SIZE="1",
                               RANK="0", LOCAL_RANK="0"))]
        + [(CHILD_GLOO, (str(pid), gloo_port), {}) for pid in range(2)])

    # (a) no launcher environment: one process, no group; the headline
    # through shard_map_solver over host_chip_mesh() is the plain call
    size = a["mesh"][0] * a["mesh"][1]
    assert a["launches"] == a["seen"] == size, a
    launches["fused_admm"] += a["launches"]
    log(f"phase 21 (a) a fresh process: initialize() False, "
        f"shard_map_solver over host_chip_mesh() {tuple(a['mesh'])}, "
        f"B={BATCH}: the plain call's bits, K1 launches {a['launches']} "
        f"(torch.profiler saw {a['seen']})")
    solver = scale_out_solver(sp)
    _, _, inputs = problem(sp, 0, BATCH)
    x = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
         for a in inputs]
    whole, seen, events = profiled_launches(lambda: solver(*x),
                                            "fused_admm_kernel")
    assert bool((whole.e_flag == 1).all())
    # an observation, not a check: after phases 16-20's sessions in this
    # process the profiler has missed K1's launch (a full run saw 0 of 1)
    log(f"phase 21 (a) this process's torch.profiler, after the earlier "
        f"phases' sessions: saw {seen} K1 launch of 1, {events} device "
        f"activities")

    # (b) logical shards of the headline batch on one card: each shard's
    # bits, and the whole batch's k, e_flag and u (exact-k); times in turns
    for shards in SCALE_SHARDS:
        solve_s = sp.parallel.sharded_solver(
            solver, sp.parallel.batch_mesh([DEVICE + ":0"] * shards))
        fused_admm_solve.launches = 0
        res_s = solve_s(*x)
        torch.cuda.synchronize()
        n = fused_admm_solve.launches
        launches["fused_admm"] += n
        plan = dict(fused_admm_solve.last_plan)
        assert n == shards, n
        per_shard_bits(res_s, solver, x, shards, f"phase 21 (b) {shards}")
        for key in ("k", "e_flag", "u"):
            assert torch.equal(getattr(res_s, key), getattr(whole, key)), (
                shards, key)
        t = {"whole": [], "sharded": []}
        for key in ("whole", "sharded", "sharded", "whole"):
            t[key].append(cuda_ms(lambda: (solver if key == "whole"
                                           else solve_s)(*x), reps=3))
        log(f"phase 21 (b) {shards} logical shards of {BATCH // shards} "
            f"on one card (lanes a block {plan['lanes']}, blocks "
            f"{plan['blocks']} a launch; the whole batch "
            f"{fused_admm_solve.last_plan['lanes']} and "
            f"{fused_admm_solve.last_plan['blocks']}): K1 launches {n}, "
            f"each shard's bits, k, e_flag and u of the whole batch; ms "
            f"per batch (CUDA events, means of 3): {json.dumps(t)}")

    # (c) a solver built on the CPU, replicated to the card
    rep = _replica(scale_out_solver(sp, device="cpu"), DEVICE + ":0")
    assert rep.device == torch.device("cuda", 0), rep.device
    _, _, small = problem(sp, 3, FB)
    fused_admm_solve.launches = 0
    r_rep = rep(*small)
    torch.cuda.synchronize()
    n = fused_admm_solve.launches
    launches["fused_admm"] += n
    assert n == 1, n
    same_bits(r_rep, solver(*small), "phase 21 (c)")
    log(f"phase 21 (c) a solver built on the CPU and replicated to cuda:0 "
        f"gives the card-built solver's bits, B={FB}")

    # (d) a world of one process under torchrun's variables: NCCL
    launches["fused_admm"] += d["launches"]
    assert d["backend"] == "nccl" and d["launches"] == 1, d
    log(f"phase 21 (d) torchrun world of one, backend {d['backend']}: "
        f"global_fleet_metrics == fleet_metrics {d['metrics']}, K1 "
        f"launches {d['launches']}, no collective inside the solve, two "
        f"all_reduce in the metrics")

    # (e) two processes on one card over gloo
    outs = gloo
    assert outs[0]["metrics"] == outs[1]["metrics"], outs
    assert outs[0]["warm"] == outs[1]["warm"], outs
    for out in outs:
        launches["fused_admm"] += out["launches"]
        assert out["launches"] == 1, out
    log(f"phase 21 (e) two processes on cuda:0 over gloo, {BATCH // 2} "
        f"lanes each: identical global metrics {outs[0]['metrics']}, "
        f"each process's lanes the bits of a local solve, K1 launches "
        f"{[o['launches'] for o in outs]}; dense fp64 warm start across "
        f"them ({DENSE_WARM_B} lanes each): cold {outs[0]['cold']}, warm "
        f"{outs[0]['warm']}")

    # (f) the sharded baseline config, HMPC-SADMM-split on K7
    name = "HMPC-SADMM-split"
    s7 = hmpc_solver(sp, name, device=DEVICE)
    s7.options.timing = False
    x7 = [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
          for a in hmpc_inputs(sp, name, 0, FB)]
    fused_split_solve.launches = 0
    r7 = sp.parallel.sharded_solver(
        s7, sp.parallel.batch_mesh([DEVICE + ":0"] * 2))(*x7)
    torch.cuda.synchronize()
    n = fused_split_solve.launches
    launches["fused_split"] += n
    assert n == 2, n
    m7 = sp.parallel.fleet_metrics(r7)
    assert m7["n_converged"] == m7["n_lanes"] == FB, m7
    per_shard_bits(r7, s7, x7, 2, "phase 21 (f)")
    log(f"phase 21 (f) {name} B={FB} on two logical shards: {m7}, K7 "
        f"launches {n}, each shard's bits")

    # (g) dryrun_multichip on the card
    fused_admm_solve.launches = 0
    dry = [dryrun_multichip(1), dryrun_multichip(2, devices=[DEVICE + ":0"]
                                                 * 2)]
    torch.cuda.synchronize()
    n = fused_admm_solve.launches
    launches["fused_admm"] += n
    assert n == 3, n
    log(f"phase 21 (g) dryrun_multichip(1) and (2, cuda:0 twice): "
        f"{json.dumps(dry)}, K1 launches {n}")
    log(f"phase 21 launches {launches}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# phase 22: the generated C beside the card's fp64 dense engine, at the
# headline horizon with no relaxation (the generated C has none)
C_BATCH = 1024
C_SEED = 22
C_FAMILIES = {
    "laxMPC-ADMM": ("laxMPC", "ADMM", "", dict(
        rho=RHO, tol=TOL, k_max=K_MAX, relax_alpha=1.0)),
    "MPCT-ADMM-cs": ("MPCT", "ADMM", "cs", dict(
        rho=RHO, tol=TOL, k_max=K_MAX, relax_alpha=1.0)),
}
U_TOL_C = 1e-8      # generated C vs the fp64 dense engine, equal-k lanes


def phase_embedded_c(sp, device=None, B=C_BATCH):
    """Phase 22: for laxMPC-ADMM (codegen/emit_c.py) and MPCT-ADMM-cs
    (codegen/emit_c_ext.py), Problem.generate_c writes and compiles (cc)
    the embedded C solver into a temporary directory; B headline lanes
    from C_SEED are solved lane by lane through CompiledCSolver (one
    thread a core, a lane a call) and as one batch by the fp64 dense
    engine on `device` (the card by default):
    every lane converges in both, k and e_flag agree on >= K_AGREE of
    lanes, and u and z within U_TOL_C on the lanes with equal k. Logs the cc
    time, the C's median run_time_ms a solve (its own clock, inside the
    call), the lanes' wall and the batch's CUDA-event time. Returns
    {family: numbers}."""
    import tempfile
    from spcies_tpu_torch.codegen import CompiledCSolver
    device = device or DEVICE
    threads = os.cpu_count() or 1
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="spcies_c_") as tmp:
        for fam, (f, m_, sm, kw) in C_FAMILIES.items():
            sys_, param30, inputs = problem(sp, C_SEED, B)
            if f == "MPCT":
                param30 = dict(param30, T=10.0 * np.asarray(param30["Q"]),
                               S=np.asarray(param30["R"]).copy())
            opt = sp.default_options(f, m_, sm, **kw)
            name = fam.replace("-", "_").lower()
            t0 = time.perf_counter()
            c_path = sp.Problem(sys=sys_, param=param30,
                                options=opt).generate_c(
                                    directory=tmp, save_name=name)
            cc_s = time.perf_counter() - t0
            assert c_path == os.path.join(tmp, f"{name}.c"), c_path
            dense = sp.make_solver(sys_, param30, formulation=f, method=m_,
                                   submethod=sm, options=opt,
                                   device=device)
            assert dense.dtype == torch.float64
            dense.options.timing = False
            c = CompiledCSolver(name, n=dense.n, m=dense.m, nz=dense.nz,
                                directory=tmp)
            # one lane a call, on every core at once: ctypes lets go of
            # the interpreter's lock inside the call, and the solver
            # allocates nothing and writes only its outputs
            t0 = time.perf_counter()
            with ThreadPoolExecutor(threads) as pool:
                lanes = list(pool.map(lambda i: c(*(a[i] for a in inputs)),
                                      range(B)))
            c_wall_s = time.perf_counter() - t0
            u_c = np.stack([r[0] for r in lanes])
            k_c = np.array([r[1] for r in lanes])
            e_c = np.array([r[2] for r in lanes])
            run_ms = np.array([r[3]["run_time_ms"] for r in lanes])
            z_c = np.stack([r[3]["z"] for r in lanes])
            res = dense(*inputs)
            if torch.device(device).type == "cuda":
                batch_ms = cuda_ms(lambda: dense(*inputs))
            else:
                t0 = time.perf_counter()
                dense(*inputs)
                batch_ms = (time.perf_counter() - t0) * 1e3
            k_d = res.k.cpu().numpy()
            e_d = res.e_flag.cpu().numpy()
            u_d = res.u.cpu().numpy()
            assert (e_c == 1).all(), (fam, "C lanes not converged",
                                      int((e_c != 1).sum()))
            assert (e_d == 1).all(), (fam, "dense lanes not converged",
                                      int((e_d != 1).sum()))
            same = (k_c == k_d) & (e_c == e_d)
            agree = float(same.mean())
            u_err = float(np.abs(u_c - u_d)[same].max())
            # u sits on its bound on most headline lanes: z, the whole
            # iterate, is held to the same bar
            z_err = float(np.abs(z_c - res.sol["z"].cpu().numpy())[
                same].max())
            moved = np.flatnonzero(~same)
            row = dict(lanes=B, cc_s=cc_s, c_run_ms_median=float(
                np.median(run_ms)), c_threads=threads, c_wall_s=c_wall_s,
                dense_batch_ms=batch_ms, k_agree=agree, u_err=u_err,
                z_err=z_err,
                k_mean=float(k_d.mean()), k_max=int(k_d.max()),
                moved=[(int(i), int(k_c[i]), int(k_d[i]))
                       for i in moved[:8]])
            log(f"phase 22 {fam}: {json.dumps(row)}")
            assert agree >= K_AGREE, (fam, agree)
            assert u_err <= U_TOL_C and z_err <= U_TOL_C, (fam, u_err,
                                                            z_err)
            out[fam] = row
    log(f"phase 22 wall {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 23: the port's surface (the CLI, the examples, entry()), the phase
# timer on CUDA events at the fused headline, and a fresh process's first
# request
EXAMPLES = ("torch_t00_basic_tutorial.py", "torch_t01_time_varying.py",
            "torch_t02_plain_c.py", "torch_t03_real_systems.py",
            "torch_t04_dev_solver_versions.py",
            "torch_t05_serving_rollout.py")
CLI_GEN = (("laxMPC", "", ""), ("MPCT", "ADMM", "cs"))
TIMER_REL, TIMER_ABS = 0.05, 0.05   # timer against a bracket: 5 % or ms
WARM_REQUESTS = 5                   # warm requests after the first one


class SyncCounter:
    """Counts, while active, every call of torch.cuda.synchronize and of
    the synchronize methods of torch.cuda.Event and torch.cuda.Stream, and
    the count at the entry of each PhaseTimer.finish."""

    def __init__(self):
        from spcies_tpu_torch.diagnostics.timing import PhaseTimer
        self.calls = 0
        self.at_finish = []
        self._patched = [(torch.cuda, "synchronize"),
                         (torch.cuda.Event, "synchronize"),
                         (torch.cuda.Stream, "synchronize"),
                         (PhaseTimer, "finish")]

    def __enter__(self):
        self._orig = [getattr(obj, name) for obj, name in self._patched]
        for (obj, name), orig in zip(self._patched, self._orig):
            def counted(*args, _orig=orig, _finish=name == "finish", **kw):
                if _finish:
                    self.at_finish.append(self.calls)
                else:
                    self.calls += 1
                return _orig(*args, **kw)
            setattr(obj, name, counted)
        return self

    def __exit__(self, *exc):
        for (obj, name), orig in zip(self._patched, self._orig):
            setattr(obj, name, orig)


def within(value, ref):
    return abs(value - ref) <= max(TIMER_REL * ref, TIMER_ABS)


# (e) a fresh process: the headline solver's first request against warm
# ones, timed by the phase timer; with an argument, the first request
# under cProfile (the top 15 by cumulative time)
CHILD_FIRST = r"""
import cProfile, gc, io, json, pstats, sys, time
import torch
import chip_smoke as c
import spcies_tpu_torch as sp
from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
gc_ms = []
def gc_clock(phase, info, _t=[0.0]):
    if phase == "start":
        _t[0] = time.perf_counter()
    else:
        gc_ms.append((time.perf_counter() - _t[0]) * 1e3)
gc.callbacks.append(gc_clock)
def segments():
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)
solver = c.fused_solver(sp, tile_b=c.TILE_B, check_every=c.CHECK_EVERY,
                        exact_k=True)
_, _, inputs = c.problem(sp, 0, c.BATCH)
fused_admm_solve.launches = 0
prof = cProfile.Profile() if len(sys.argv) > 1 else None
seg0, t0 = segments(), time.perf_counter()
if prof is not None:
    prof.enable()
first = solver(*inputs)
if prof is not None:
    prof.disable()
host_ms = (time.perf_counter() - t0) * 1e3
first_gc_ms, seg1 = sum(gc_ms), segments()
warm = [solver(*inputs).sol["times_ms"] for _ in range(c.WARM_REQUESTS)]
assert bool((first.e_flag == 1).all())
top = ""
if prof is not None:
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(15)
    top = s.getvalue()
print("RESULT " + json.dumps(dict(
    first=first.sol["times_ms"], warm=warm, top=top, first_host_ms=host_ms,
    first_gc_ms=first_gc_ms, first_segments=seg1 - seg0,
    warm_segments=segments() - seg1,
    launches=fused_admm_solve.launches)), flush=True)
"""


def surface_cli(sp):
    """Phase 23 (a): the CLI as processes; gen --demo's .c and .h against
    generate_embedded_solver in this process."""
    import tempfile
    from spcies_tpu_torch.__main__ import demo_problem
    from spcies_tpu_torch.codegen import generate_embedded_solver
    with tempfile.TemporaryDirectory(prefix="spcies_cli_") as tmp:
        cli = ["-m", "spcies_tpu_torch"]
        cmds = [cli + ["version"], cli + ["help"], cli + ["help", "codegen"]]
        cmds += [cli + ["gen", "--demo", "--formulation", f, "--method", m_,
                        "--submethod", s, "--directory", "cli"]
                 for f, m_, s in CLI_GEN]
        outs = run_processes(cmds, tmp)
        assert outs[0][0].strip() == sp.__version__, outs[0][0]
        assert "help topics" in outs[1][0], outs[1][0][:300]
        assert "generate_c_solver" in outs[2][0], outs[2][0][:300]
        names = []
        for f, m_, s in CLI_GEN:
            sys_, param = demo_problem(f)
            path = Path(generate_embedded_solver(
                sys_, param, formulation=f, method=m_, submethod=s,
                directory=os.path.join(tmp, "in_process")))
            for ext in (".c", ".h"):
                mine = path.with_suffix(ext)
                cli_file = Path(tmp, "cli", mine.name)
                assert cli_file.read_bytes() == mine.read_bytes(), mine.name
            names.append(path.name)
    log(f"phase 23 (a) python -m spcies_tpu_torch: version "
        f"{outs[0][0].strip()}, help, help codegen and gen --demo exit 0; "
        f"{names} and their headers equal generate_embedded_solver's "
        f"bytes; processes {[round(o[1], 2) for o in outs]} s")


def surface_examples():
    """Phase 23 (b): the six examples as processes on the card (each that
    builds a solver takes its default device); each exits 0, its output
    logged."""
    import tempfile
    root = Path(__file__).resolve().parent
    cmds = [[str(root / "examples" / name)] for name in EXAMPLES]
    with tempfile.TemporaryDirectory(prefix="spcies_examples_") as tmp:
        outs = run_processes(cmds, tmp)
    for name, (out, seconds) in zip(EXAMPLES, outs):
        log(f"phase 23 (b) {name}: exit 0 in {seconds:.2f} s")
        for line in out.strip().splitlines():
            log(f"    {line}")


def surface_entry():
    """Phase 23 (c): entry() on the card gives 10 iterations and finite u
    on every lane; the fp64 flagship there agrees with the CPU's (k equal,
    u and z within 1e-9)."""
    from spcies_tpu_torch.entry import _flagship, entry
    fn, args = entry()
    res = fn(*args)
    assert tuple(res.u.shape) == (256, 2), res.u.shape
    assert bool(torch.isfinite(res.u).all())
    assert bool((res.k == 10).all()), res.k
    ref = {}
    for dev in (DEVICE, "cpu"):
        s64, a64 = _flagship(256, "float64", device=dev)
        ref[dev] = s64.raw_fn(*a64, None, None)
    card, host = ref[DEVICE], ref["cpu"]
    assert torch.equal(card.k.cpu(), host.k), "fp64 flagship k"
    du = float((card.u.cpu() - host.u).abs().max())
    dz = float((card.sol["z"].cpu() - host.sol["z"]).abs().max())
    assert du <= 1e-9 and dz <= 1e-9, (du, dz)
    log(f"phase 23 (c) entry(): u {tuple(res.u.shape)} finite, k == 10 on "
        f"every lane; fp64 flagship on {DEVICE} against the CPU: k equal "
        f"(k_mean {float(host.k.double().mean()):.2f}), u within {du:.2e}, "
        f"z within {dz:.2e}")


def surface_timer(sp):
    """Phase 23 (d): the phase timer at the fused headline (K1). Returns
    K1's launches."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    solver = fused_solver(sp, tile_b=TILE_B, check_every=CHECK_EVERY,
                          exact_k=True)
    _, _, inputs = problem(sp, 0, BATCH)
    assert solver.options.timing
    solver(*inputs)                      # warm: the kernel is loaded
    orig = solver.raw_fn
    brackets = []

    def bracketed(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a)
        e1.record()
        brackets.append((e0, e1))
        return out

    rows = []
    fused_admm_solve.launches = 0
    # no garbage collection inside the measured calls: a collection between
    # the bracket's first event and the timer's (a few ms on this host, as
    # (e) measures) would be counted by the one and not by the other
    gc.collect()
    gc.disable()
    try:
        solver.raw_fn = bracketed
        for _ in range(3):
            torch.cuda.synchronize()
            with SyncCounter() as sc:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                timed = solver(*inputs)
                e1.record()
            torch.cuda.synchronize()
            assert sc.at_finish == [0] and sc.calls == 1, (sc.at_finish,
                                                          sc.calls)
            t = timed.sol["times_ms"]
            call_ms = e0.elapsed_time(e1)
            solve_ms = brackets[-1][0].elapsed_time(brackets[-1][1])
            rows.append(dict(times_ms=t, bracket_solve_ms=solve_ms,
                             bracket_call_ms=call_ms))
            assert within(t["solve"], solve_ms), rows[-1]
            assert within(t["run"], call_ms), rows[-1]
    finally:
        gc.enable()
        solver.raw_fn = orig
    solver.options.timing = False
    with SyncCounter() as sc:
        untimed = solver(*inputs)
    torch.cuda.synchronize()
    assert sc.calls == 0 and sc.at_finish == [], (sc.calls, sc.at_finish)
    assert "times_ms" not in untimed.sol
    same_bits(untimed, timed, "phase 23 (d) timing off")
    n = fused_admm_solve.launches
    assert n == 4, n
    log(f"phase 23 (d) the phase timer at the headline (B={BATCH}, K1): "
        f"solve and run within {TIMER_REL:.0%} or {TIMER_ABS} ms of the "
        f"outside CUDA-event brackets of the solve and the call; no "
        f"synchronize before finish(), one at it, none with timing off, "
        f"the same bits: {json.dumps(rows)}")
    return n


def surface_first_request():
    """Phase 23 (e): in a fresh process the headline's first request
    against warm ones; in another its cProfile. Returns K1's launches."""
    (timing,) = run_children([(CHILD_FIRST, (), {})])
    (profiled,) = run_children([(CHILD_FIRST, ("profile",), {})])
    for r in (timing, profiled):
        assert r["launches"] == 1 + WARM_REQUESTS, r
    warm_update = float(np.median([w["update"] for w in timing["warm"]]))
    log(f"phase 23 (e) a fresh process, the headline: first request "
        f"{json.dumps(timing['first'])} (host clock "
        f"{timing['first_host_ms']:.3f} ms, of it garbage collection "
        f"{timing['first_gc_ms']:.3f} ms; allocator segments it added "
        f"{timing['first_segments']}, warm requests "
        f"{timing['warm_segments']}); warm requests' update median "
        f"{warm_update:.4f} ms (first / warm "
        f"{timing['first']['update'] / warm_update:.2f}x); warm "
        f"{json.dumps(timing['warm'])}")
    log("phase 23 (e) cProfile of the first request (another fresh "
        "process):")
    for line in profiled["top"].strip().splitlines():
        log(f"    {line}")
    return timing["launches"] + profiled["launches"]


def phase_port_surface(sp):
    """Phase 23: the CLI, the examples and entry() on the card, the phase
    timer on CUDA events at the fused headline, and a fresh process's first
    request (surface_cli, surface_examples, surface_entry, surface_timer,
    surface_first_request). Returns K1's launches."""
    t0 = time.perf_counter()
    surface_cli(sp)
    surface_examples()
    surface_entry()
    launches = surface_timer(sp) + surface_first_request()
    log(f"phase 23 K1 launches {launches}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def kernel_entry(name, launches, err, times, wide=None):
    """One kernel's entry of the `kernels` line, with its wide widths'
    times and bounds (phase 17) under "wide"."""
    line = {"fused_admm": "fused_admm.py:74", "fused_fista":
            "fused_fista.py:61", "fused_eadmm": "fused_eadmm.py:50",
            "fused_ellip": "fused_ellip.py:54",
            "fused_soc": "fused_soc.py:42",
            "fused_hmpc": "fused_hmpc.py:57",
            "fused_split": "fused_split.py:58"}[name]
    bound_ms, bound_by = times["bound"]
    entry = {"name": name, "route": "cuda",
             "source": f"spcies_tpu_torch/csrc/{name}.cu",
             "replaces": f"spcies_tpu/kernels/{line}", "launches": launches,
             "max_abs_err": err, "ms": times["kernel"],
             "plain_ms": times["plain"], "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}
    for key in ("lanes", "refill"):     # the launch's build (K6, K7)
        if key in times:
            entry[key] = times[key]
    if "bf16" in times:
        entry.update(bf16_ms=times["bf16"]["kernel"],
                     bf16_plain_ms=times["bf16"]["plain"],
                     bf16_bound_ms=times["bf16"]["bound"])
    if wide:
        keep = ("lanes", "slab", "threads", "smem", "horizon", "nd",
                "refill", "blocks", "global_leaves", "c2d_staged")
        entry["wide"] = {
            str(nzp): dict(ms=row["kernel"], plain_ms=row["plain"],
                           bound_ms=row["bound"][0],
                           bound_by=row["bound"][1], share=row["share"],
                           **{k: row[k] for k in keep if k in row})
            for nzp, row in wide.items() if "bound" in row}
    return entry


def phase_clock(t_start):
    """A runner of phases that logs each one's wall time and the script's
    so far (all of them share the script's time limit)."""
    def step(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        log(f"phase {label}: {now - t0:.1f} s (script {now - t_start:.1f} "
            f"s)")
        return out
    return step


def main():
    require_cuda()
    import spcies_tpu_torch as sp
    global LOG_FILE
    if os.environ.get("SPCIES_LOG_DIR"):
        out = Path(os.environ["SPCIES_LOG_DIR"])
        out.mkdir(parents=True, exist_ok=True)
        LOG_FILE = open(out / "chip_smoke.log", "w")
    # full fp32 products everywhere, the plain versions included (this
    # also turns torch.backends.cuda.matmul.allow_tf32 off)
    torch.set_float32_matmul_precision("highest")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    t_start = time.perf_counter()
    step = phase_clock(t_start)
    step("builds", build_kernels)
    head, head_plain, m = step("1", phase_kernel_vs_plain, sp)
    launches, fused = step("2", phase_main_path, sp, head_plain, m)
    times = step("3", phase_times, sp, fused)
    fista_err = step("4", phase_fista_kernel_vs_plain, sp)
    fam_launches = step("5", phase_family_paths, sp)
    fam_times = step("6", phase_family_times, sp)
    eadmm_err = step("7", phase_eadmm_kernel_vs_plain, sp)
    mpct_launches = step("8", phase_mpct_paths, sp)
    mpct_times = step("9", phase_mpct_times, sp)
    ellip_err = step("10", phase_ellip_kernel_vs_plain, sp)
    ellip_launches = step("11", phase_ellip_paths, sp)
    ellip_times = step("12", phase_ellip_times, sp)
    hmpc_err = step("13", phase_hmpc_kernel_vs_plain, sp)
    hmpc_launches = step("14", phase_hmpc_paths, sp)
    hmpc_times = step("15", phase_hmpc_times, sp)
    roll_launches, _rows = step("16", phase_rollout, sp)
    wide = step("17 (K1)", phase_wide, sp)
    wk = step("17 (K2-K7)", phase_wide_kernels, sp)
    start_cpu_runs()
    try:
        step("18", phase_off_fixture, sp)
        step("19", phase_banded, sp)
        auto_launches = step("20", phase_long, sp)
    finally:
        stop_cpu_runs()
    scale_launches = step("21", phase_scale_out, sp)
    step("22", phase_embedded_c, sp)
    surface_launches = step("23", phase_port_surface, sp)
    log(json.dumps({"kernels": [
        kernel_entry("fused_admm", launches + fam_launches["fused_admm"]
                     + mpct_launches["fused_admm"] + roll_launches
                     + auto_launches["fused_admm"]
                     + scale_launches["fused_admm"] + surface_launches,
                     max(head["u_err"], *(r["u_err"] for r in wide.values()
                                          if "u_err" in r)),
                     times, wide),
        kernel_entry("fused_fista", fam_launches["fused_fista"],
                     max(fista_err, wk["fused_fista"][1]), fam_times[FB],
                     wk["fused_fista"][0]),
        kernel_entry("fused_eadmm", mpct_launches["fused_eadmm"],
                     max(eadmm_err, wk["fused_eadmm"][1]), mpct_times[FB],
                     wk["fused_eadmm"][0]),
        kernel_entry("fused_ellip", ellip_launches["fused_ellip"],
                     max(ellip_err["fused_ellip"], wk["fused_ellip"][1]),
                     ellip_times[("ellipMPC-ADMM", FB)],
                     wk["fused_ellip"][0]),
        kernel_entry("fused_soc", ellip_launches["fused_soc"],
                     max(ellip_err["fused_soc"], wk["fused_soc"][1]),
                     ellip_times[("ellipMPC-ADMM-soc", FB)],
                     wk["fused_soc"][0]),
        kernel_entry("fused_hmpc", hmpc_launches["fused_hmpc"],
                     max(hmpc_err["fused_hmpc"], wk["fused_hmpc"][1]),
                     hmpc_times[("HMPC-ADMM", FB)], wk["fused_hmpc"][0]),
        kernel_entry("fused_split", hmpc_launches["fused_split"]
                     + auto_launches["fused_split"]
                     + scale_launches["fused_split"],
                     max(hmpc_err["fused_split"], wk["fused_split"][1]),
                     hmpc_times[("HMPC-ADMM-split", FB)],
                     wk["fused_split"][0])]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
