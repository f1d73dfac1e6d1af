#!/usr/bin/env python3
"""A/B of build variants of the port's kernels on one CUDA card, in one
process.

K2-K7 (fused_fista, fused_eadmm, fused_ellip, fused_soc, fused_hmpc,
fused_split): the committed source on the product stage
csrc/tile_product.cuh at each lanes a block it is built for (8, 16 and 32;
K3 8 and 16), and builds of it with other macro defaults (K4-K6: refill
off, other slab rows and blocks an SM, a ring of three slabs, clock counts
of an iteration's halves; K7: refill off, which its plan decides at run
time, other slab rows and blocks an SM, clock counts; K7, K6 and K5: the
cones projected as the parents project them; K2: other slab rows, blocks an
SM, columns a thread, ring depth and clock counts of its products; K3:
clock counts of an iteration's four parts, per block iteration, and z2
chains that read C2d the other way: from shared memory at 8 lanes, by
__ldg at 16), each held to the parent
(csrc/variants/fused_*_parent.cu: one column a thread, 8 lanes a block)
bit for bit in every mode chip_smoke.py runs for the kernel, then timed
with the parent in turns at B=8192 and 32768 (K4 also at phase 10's
binding ball, B=8192; K7's HMPC-SADMM-split at B=8192) beside each
launch's group and block iterations. `--only a,b` keeps the builds whose
names hold a or b, here and for K1 (which then skips its bf16 and
sort_lanes timings).

K1 (fused_admm): the builds of the product stage csrc/tile_product.cuh
under K1's source csrc/fused_admm.cu: the lanes a block L in {8, 16, 32}
(64 does not fit shared memory: the bytes are printed), 2 or 4 columns a
thread at 16 lanes, and builds of the stage with another slab depth,
another ring depth, cp.async in place of TMA (cp.async.bulk), M read
unstaged from L2 by __ldg, strided in place of adjacent columns a thread,
and the iteration not inlined. The parent (one column a thread, 8 lanes a
block: csrc/variants/fused_admm_parent.cu with its state in registers) is
one more variant, so parent and change are timed in one call. Every fp32
variant must give the parent's k, e_flag and iterates bit for bit. The
bf16 mode is timed on the tensor cores (csrc/variants/fused_admm_tc.cu at
16 and 32 lanes a block), on the CUDA cores and in the parent, each held
against the plain version, and the laxMPC-ADMM solver is timed with
sort_lanes on and off.

The script builds every variant into the git-ignored
spcies_tpu_torch/_build/ab/, prints ptxas's registers and spills and the
mean block iterations beside k_mean, holds each variant against the parent
at the kernel's chip_smoke.py families, and times the variants in turns
(forward, then backward) at B=4096, 8192 and 32768 (K2 and K4-K7: 8192 and
32768) with CUDA events. Run from the repository root on a machine with a card, for all
kernels or the ones named:

    python3 tools/ab_kernels.py [fused_admm fused_split fused_hmpc ...]
                                [--only a,b]

With SPCIES_LOG_DIR set, every line also goes to ab_kernels.log in that
directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as c  # noqa: E402
import spcies_tpu_torch as sp  # noqa: E402
from spcies_tpu_torch.kernels import _build  # noqa: E402
from spcies_tpu_torch.kernels import fused_admm as k1  # noqa: E402
from spcies_tpu_torch.kernels import fused_eadmm as k3  # noqa: E402
from spcies_tpu_torch.kernels import fused_ellip as k4  # noqa: E402
from spcies_tpu_torch.kernels import fused_fista as k2  # noqa: E402
from spcies_tpu_torch.kernels import fused_hmpc as k6  # noqa: E402
from spcies_tpu_torch.kernels import fused_soc as k5  # noqa: E402
from spcies_tpu_torch.kernels import fused_split as k7  # noqa: E402
from spcies_tpu_torch.kernels import stage  # noqa: E402


# ---- K1: the builds of csrc/tile_product.cuh -----------------------------

CSRC = REPO / "spcies_tpu_torch" / "csrc"
# the sources no wrapper launches: the parents and K1's bf16 kernel on the
# tensor cores
VARIANTS = CSRC / "variants"
# variant name -> (the macro defaults of tile_product.cuh it changes, the
# (lanes a block, columns a thread) it is run at)
TILE_BUILDS = {
    "cp.async": ({"TP_STAGE": 1}, [(32, 4), (16, 4)]),
    "unstaged __ldg": ({"TP_STAGE": 0}, [(32, 4)]),
    "strided columns": ({"TP_ADJ": 0}, [(32, 4)]),
    "iteration not inlined": ({"TP_NOINLINE": 1}, [(32, 4)]),
    "slabs of 8 rows": ({"TP_SLAB_ROWS": 8, "TP_SLAB_ROWS_NARROW": 8},
                        [(32, 4), (16, 2)]),
    "slabs of 16 rows": ({"TP_SLAB_ROWS_NARROW": 16}, [(32, 4), (16, 4)]),
    "ring of 3, slabs of 16 rows": ({"TP_STAGES": 3,
                                     "TP_SLAB_ROWS_NARROW": 16}, [(32, 4)]),
    "unroll 8 rows": ({"TP_UNROLL": 8}, [(32, 4)]),
}
# the tiles of the committed header: (lanes a block, columns a thread)
TILES = [(8, 1), (16, 2), (16, 4), (32, 4)]
# the C signature of the parent K1 (csrc/variants/fused_admm_parent.cu)
PARENT_ADMM_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                        + [ctypes.c_float] * 4 + [ctypes.c_int]
                        + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
# and of K1's bf16 kernel on the tensor cores (fused_admm_tc.cu): 14 tensor
# pointers; B, nzp, lanes; rho, 1/rho, alpha, 1-alpha; relax; tol_p, tol_d;
# k_max, check_every, fixed_iters, exact_k; the stream
TC_ADMM_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                    + [ctypes.c_float] * 4 + [ctypes.c_int]
                    + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


def tile_dir(source: Path, macros: dict) -> Path:
    """The directory of `source` when `macros` is empty; else a directory
    holding a copy of it and of tile_product.cuh whose macro defaults (in
    either file) are `macros`."""
    if not macros:
        return source.parent
    tag = "_".join(f"{m}{v}" for m, v in sorted(macros.items()))
    d = _build.BUILD_DIR / "ab" / f"{source.stem}-{tag}"
    d.mkdir(parents=True, exist_ok=True)
    texts = {source.name: source.read_text(),
             "tile_product.cuh": (CSRC / "tile_product.cuh").read_text()}
    for macro, value in macros.items():
        found = 0
        for name, text in texts.items():
            texts[name], n = re.subn(rf"(#define {macro}) \w+",
                                     rf"\1 {value}", text)
            found += n
        if not found:
            raise RuntimeError(f"{macro} not defined")
    for name, text in texts.items():
        (d / name).write_text(text)
    return d


def log_ptxas(tag: str, record: dict):
    """The registers and spills of each kernel of a build, named by its
    template arguments."""
    kernel = ""
    for line in record["log"].splitlines():
        m = re.search(r"Compiling entry function '\w*?(fused_\w+?_kernel)"
                      r"I(\w*)E", line)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2) + "E"))
            kernel = f"{m.group(1)}<{args}>"
        elif "registers" in line or "spill" in line:
            c.log(f"{tag} ptxas: {kernel} {line.strip()}")


def outputs(like, B, snap_cols):
    """The output tensors of a launch: three iterates, k, done, r_p, r_d and
    the exact-k scratch (snap_cols columns a lane; 0 for none)."""
    dev = like.device
    its = [torch.empty_like(like) for _ in range(3)]
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    snap = torch.empty((B if snap_cols else 0, snap_cols),
                       dtype=torch.float32, device=dev)
    return its, k, done, rp, rd, snap


def results(its, k, done, rp, rd):
    return (*its, k, torch.where(done == 1, 1, -1).to(torch.int32), rp, rd)


def admm_scalars(kk):
    """The scalars K1's launchers share, rho to exact_k."""
    alpha = float(kk["relax_alpha"])
    return (float(kk["rho"]), float(1.0 / kk["rho"]), alpha, 1.0 - alpha,
            int(alpha != 1.0), float(kk["tol_p"]), float(kk["tol_d"]),
            int(kk["k_max"]), int(kk["check_every"]), int(kk["fixed_iters"]),
            int(bool(kk["exact_k"])))


def run_admm(v, args, kk):
    """K1 through its wrapper at v.lanes lanes a block, with the shared
    bytes of the build loaded (its slab and ring depth)."""
    fn = _build._LOADED["fused_admm"][0].fused_admm_smem
    fn.restype = ctypes.c_long
    saved = k1.shared_bytes
    k1.shared_bytes = lambda nzp, lanes, wide=False: fn(nzp, lanes,
                                                        int(wide))
    try:
        return k1.fused_admm_solve(*args, **kk, lanes=v.lanes)
    finally:
        k1.shared_bytes = saved


def run_admm_parent(v, args, kk):
    """The parent K1: 8 lanes a block, state in registers."""
    B, nzp = args[0].shape
    its, k, done, rp, rd, _ = outputs(args[0], B, 0)
    smem = 4 * (2 * nzp * 8 + 2 * (nzp // 32) * 8 * 2)
    err = v.fn(*(t.data_ptr() for t in (*args, *its, k, done, rp, rd)),
               B, nzp, B // 8, nzp, smem, *admm_scalars(kk),
               int(bool(kk["bf16"])), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return results(its, k, done, rp, rd)


def run_admm_tc(v, args, kk):
    """K1's bf16 mode on the tensor cores, on M^T rounded to bf16."""
    B, nzp = args[0].shape
    assert kk["bf16"] and B % v.lanes == 0
    exact = kk["check_every"] > 1 and kk["exact_k"] and not kk["fixed_iters"]
    its, k, done, rp, rd, snap = outputs(args[0], B, 3 * nzp if exact else 0)
    m_t = args[3].to(torch.bfloat16).t().contiguous()
    err = v.fn(*(t.data_ptr() for t in (*args[:3], m_t, *args[4:], *its, k,
                                        done, rp, rd, snap)),
               B, nzp, v.lanes, *admm_scalars(kk),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return results(its, k, done, rp, rd)


# ---- K2-K7 on the product stage ------------------------------------------

# the C signatures of the parents (csrc/variants/fused_hmpc_parent.cu and
# fused_soc_parent.cu): 16 tensor pointers; the ints of the launch; the
# floats; k_max, check_every, exact_k; the stream
PARENT_HMPC_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                        + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
PARENT_SOC_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
# and of the parents of K4 (fused_ellip_parent.cu: 16 tensor pointers; B,
# nzp, t0, n, blocks, threads, shared bytes; rho, 1/rho, r, tol_p, tol_d;
# k_max, check_every, fixed_iters, exact_k; the stream) and K2
# (fused_fista_parent.cu: 18 tensor pointers; B, nzp, nlamp, blocks,
# threads, shared bytes; tol; k_max, restart, check_every, fixed_iters,
# exact_k; the stream)
PARENT_ELLIP_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                         + [ctypes.c_float] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
PARENT_FISTA_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
                         + [ctypes.c_float] + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
# and of K3's parent (fused_eadmm_parent.cu: 28 tensor pointers; B, Z,
# blocks, threads, shared bytes; tol; k_max, check_every, exact_k; the
# stream)
PARENT_EADMM_ARGTYPES = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 5
                         + [ctypes.c_float] + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
# and of K7's parent (fused_split_parent.cu: 16 tensor pointers; B, P,
# dim_p, cone0, cone_g, symmetric, use_soc, blocks, threads, shared bytes;
# alpha, tol_p, tol_d; k_max, check_every, exact_k; the stream)
PARENT_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
                         + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])


def _hmpc_chip(name):
    return dict(module=k6, solve=k6.fused_hmpc_solve, prefix="HM",
                families=("HMPC-ADMM", "ellipHMPC-ADMM"),
                modes=[(m[0], m[1], m[2], m[4], {}) for m in c.hmpc_modes()
                       if c.hmpc_kernel(m[0])[0] == name],
                solver=c.hmpc_solver,
                inputs=lambda fam, B, extra: c.hmpc_inputs(sp, fam, 0, B),
                args=lambda solver, x: c.hmpc_kernel_args(solver, x))


def _split_chip():
    """K7's modes are chip_smoke.py's phase 13 for the split pair; it
    refills in every mode, and its plan (not a macro) decides whether, so
    its builds without refill are the committed source."""
    adm, sad = "HMPC-ADMM-split", "HMPC-SADMM-split"
    return dict(module=k7, solve=k7.fused_split_solve, prefix="SP",
                families=(adm, sad),
                modes=[(m[0], m[1], m[2], m[4], {}) for m in c.hmpc_modes()
                       if c.hmpc_kernel(m[0])[0] == "fused_split"],
                timings=[(adm, adm, {}, (c.FB, c.BATCH)),
                         (sad, sad, {}, (c.FB,))],
                solver=c.hmpc_solver,
                inputs=lambda fam, B, extra: c.hmpc_inputs(sp, fam, 0, B),
                args=lambda solver, x: c.hmpc_kernel_args(solver, x),
                common=False)


def _soc_chip(name):
    return dict(module=k5, solve=k5.fused_soc_solve, prefix="SOC",
                families=("ellipMPC-ADMM-soc",),
                modes=[(m[0], m[1], m[2], m[5], m[6]) for m in c.ellip_modes()
                       if m[0] == "ellipMPC-ADMM-soc"],
                solver=lambda sp_, fam, **kw: c.ellip_solver(
                    sp_, fam, device="cuda", **kw),
                inputs=lambda fam, B, extra: c.ellip_inputs(sp, fam, 0, B,
                                                            **extra),
                args=lambda solver, x: c.ellip_kernel_args(solver, x))


def _ellip_chip():
    """K4's modes carry fixed_iters in their input options."""
    adm = "ellipMPC-ADMM"
    return dict(module=k4, solve=k4.fused_ellip_solve, prefix="EL",
                families=(adm,),
                modes=[(m[0], m[1], m[2], m[5], dict(m[6], fixed=m[3]))
                       for m in c.ellip_modes() if m[0] == adm],
                timings=[(adm, adm, {}, (c.FB, c.BATCH)),
                         (adm, f"{adm} random SPD P, c != xr",
                          dict(spd_seed=11), (c.FB,))],
                solver=lambda sp_, fam, **kw: c.ellip_solver(
                    sp_, fam, device="cuda", **kw),
                inputs=lambda fam, B, extra: (
                    c.ellip_inputs(sp, fam, 0, B),
                    extra.get("fixed", 0)),
                args=lambda solver, x: c.ellip_kernel_args(solver, *x))


def _fista_chip():
    return dict(module=k2, solve=k2.fused_fista_solve, prefix="FI",
                families=("laxMPC-FISTA", "equMPC-FISTA"),
                modes=[(m[1], m[0], m[2], m[4], dict(fixed=m[3]))
                       for m in c.fista_modes()],
                solver=lambda sp_, fam, **kw: c.family_solver(
                    sp_, fam, device="cuda", **kw),
                inputs=lambda fam, B, extra: (c.problem(sp, 0, B)[2],
                                              extra.get("fixed", 0)),
                args=lambda solver, x: c.fista_kernel_args(solver, *x),
                common=False)


def _eadmm_chip():
    """K3's modes are chip_smoke.py's phase 7; its calls pass the classes
    of columns the solver found once, so that a timed launch finds none."""
    fam = "MPCT-EADMM"

    def args(solver, x):
        a, kk = c.eadmm_kernel_args(solver, x)
        return a, dict(kk, classes=solver.raw_fn.classes)
    return dict(module=k3, solve=k3.fused_eadmm_solve, prefix="EA",
                families=(fam,), k_at=5,
                modes=[(fam, label, B, kw, {})
                       for label, B, _capped, kw in c.eadmm_modes()],
                solver=lambda sp_, fam_, **kw: c.mpct_solver(
                    sp_, fam_, device="cuda", **kw),
                inputs=lambda fam_, B, extra: c.problem(sp, 0, B)[2],
                args=args, common=False)


STAGE = {"fused_split": _split_chip(),
         "fused_hmpc": _hmpc_chip("fused_hmpc"),
         "fused_soc": _soc_chip("fused_soc"),
         "fused_ellip": _ellip_chip(),
         "fused_fista": _fista_chip(),
         "fused_eadmm": _eadmm_chip()}


def run_stage(v, args, kk):
    """K2-K7 through its wrapper at v.lanes lanes a block, with the loaded
    build's shared bytes, slabs, blocks an SM and refill."""
    spec = STAGE[v.stem]
    mod = spec["module"]
    fn = getattr(_build._LOADED[v.stem][0], f"{v.stem}_smem")
    fn.restype = ctypes.c_long
    saved = mod.shared_bytes, mod.BUILDS, stage.plan
    mod.shared_bytes = lambda *a: fn(*a)
    mod.BUILDS = v.builds
    if not v.refill:
        stage.plan = lambda *a, refill, **kw: saved[2](*a, refill=False,
                                                        **kw)
    try:
        return spec["solve"](*args, **kk, lanes=v.lanes)
    finally:
        mod.shared_bytes, mod.BUILDS, stage.plan = saved


def run_hmpc_parent(v, args, kk):
    """The parent K6: 8 lanes a block, one column a thread."""
    B, dim_p = args[0].shape
    ns_p = args[1].shape[1]
    k6.launch_plan(B, dim_p, ns_p, kk["cone0"], kk["cone_g"],
                   tile_b=kk["tile_b"], check_every=kk["check_every"],
                   exact_k=kk["exact_k"])
    exact = kk["check_every"] > 1 and kk["exact_k"]
    its = [torch.empty_like(args[0]), torch.empty_like(args[1]),
           torch.empty_like(args[1])]
    _, k, done, rp, rd, snap = outputs(args[0], B,
                                       dim_p + 2 * ns_p if exact else 0)
    smem = 4 * 8 * (2 * dim_p + 3 * ns_p + 2 * (ns_p // 32))
    err = v.fn(*(t.data_ptr() for t in (*args, *its, k, done, rp, rd, snap)),
               B, dim_p, ns_p, kk["cone0"], kk["cone_g"],
               int(kk["use_soc"]), B // 8, max(dim_p, ns_p), smem,
               float(kk["rho"]), float(1.0 / kk["rho"]), float(kk["tol_p"]),
               float(kk["tol_d"]), int(kk["k_max"]), int(kk["check_every"]),
               int(bool(kk["exact_k"])),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return results(its, k, done, rp, rd)


def run_ellip_parent(v, args, kk):
    """The parent K4: 8 lanes a block, one column a thread."""
    B, nzp = args[0].shape
    n = args[4].shape[0]
    k4.launch_plan(B, nzp, kk["t0"], n, tile_b=kk["tile_b"],
                   check_every=kk["check_every"], exact_k=kk["exact_k"],
                   fixed_iters=kk.get("fixed_iters", 0))
    fixed = kk.get("fixed_iters", 0)
    exact = kk["check_every"] > 1 and kk["exact_k"] and not fixed
    its, k, done, rp, rd, snap = outputs(args[0], B, 3 * nzp if exact else 0)
    smem = 4 * 8 * (6 * nzp + 4 * (nzp // 32))
    err = v.fn(*(t.data_ptr() for t in (*args, *its, k, done, rp, rd, snap)),
               B, nzp, kk["t0"], n, B // 8, nzp, smem, float(kk["rho"]),
               float(1.0 / kk["rho"]), float(kk["r_ball"]),
               float(kk["tol_p"]), float(kk["tol_d"]), int(kk["k_max"]),
               int(kk["check_every"]), int(fixed), int(bool(kk["exact_k"])),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return results(its, k, done, rp, rd)    # z, v, lam


def run_fista_parent(v, args, kk):
    """The parent K2: 8 lanes a block, one column a thread."""
    B, nzp = args[0].shape
    nlamp = args[2].shape[1]
    fixed = kk.get("fixed_iters", 0)
    k2.launch_plan(B, nzp, nlamp, tile_b=kk["tile_b"],
                   check_every=kk["check_every"], exact_k=kk["exact_k"],
                   fixed_iters=fixed, k_max=kk["k_max"])
    exact = kk["check_every"] > 1 and kk["exact_k"] and not fixed
    z = torch.empty_like(args[0])
    y, lam = torch.empty_like(args[2]), torch.empty_like(args[2])
    _, k, done, res, _, snap = outputs(
        args[0], B, 2 * nzp + 3 * nlamp if exact else 0)
    smem = 4 * 8 * (3 * nzp + 5 * nlamp + nlamp // 32)
    err = v.fn(*(t.data_ptr() for t in (*args, z, y, lam, k, done, res,
                                        snap)),
               B, nzp, nlamp, B // 8, max(nzp, nlamp), smem,
               float(kk["tol"]), int(kk["k_max"]), int(bool(kk["restart"])),
               int(kk["check_every"]), int(fixed), int(bool(kk["exact_k"])),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return z, y, lam, k, torch.where(done == 1, 1, -1).to(torch.int32), res


def run_eadmm_parent(v, args, kk):
    """The parent K3: 8 lanes a block, one column a thread; the classes of
    columns in kk are not its."""
    B, Z = args[0].shape
    stage.check_mode(B, tile_b=kk["tile_b"], check_every=kk["check_every"],
                     exact_k=kk["exact_k"])
    exact = kk["check_every"] > 1 and kk["exact_k"]
    dev = args[0].device
    its = [torch.empty_like(args[0]) for _ in range(5)]
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    res = [torch.empty((B,), dtype=torch.float32, device=dev)
           for _ in range(3)]
    snap = torch.empty((B if exact else 0, k3.SNAP_LEAVES * Z),
                       dtype=torch.float32, device=dev)
    smem = 4 * 8 * (12 * Z + 3 * (Z // 32))
    err = v.fn(*(t.data_ptr() for t in (*args, *its, k, done, *res, snap)),
               B, Z, B // 8, Z, smem, float(kk["tol"]), int(kk["k_max"]),
               int(kk["check_every"]), int(bool(kk["exact_k"])),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return (*its, k, torch.where(done == 1, 1, -1).to(torch.int32), *res)


def run_split_parent(v, args, kk):
    """The parent K7: 8 lanes a block, one column a thread."""
    B, P = args[0].shape
    k7.launch_plan(B, P, kk["dim_p"], kk["cone0"], kk["cone_g"],
                   tile_b=kk["tile_b"], check_every=kk["check_every"],
                   exact_k=kk["exact_k"])
    exact = kk["check_every"] > 1 and kk["exact_k"]
    its, k, done, rp, rd, snap = outputs(args[0], B, 3 * P if exact else 0)
    smem = 4 * 8 * (6 * P + 4 * (P // 32))
    err = v.fn(*(t.data_ptr() for t in (*args, *its, k, done, rp, rd, snap)),
               B, P, kk["dim_p"], kk["cone0"], kk["cone_g"],
               int(kk["symmetric"]), int(kk["use_soc"]), B // 8, P, smem,
               float(kk["alpha"]), float(kk["tol_p"]), float(kk["tol_d"]),
               int(kk["k_max"]), int(kk["check_every"]),
               int(bool(kk["exact_k"])),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return results(its, k, done, rp, rd)    # zs, lm, aux


def run_soc_parent(v, args, kk):
    """The parent K5: 8 lanes a block, one column a thread."""
    B, P = args[0].shape
    k5.launch_plan(B, P, kk["dim_p"], tile_b=kk["tile_b"],
                   check_every=kk["check_every"], exact_k=kk["exact_k"])
    exact = kk["check_every"] > 1 and kk["exact_k"]
    its, k, done, rp, rd, snap = outputs(args[0], B, 3 * P if exact else 0)
    smem = 4 * 8 * (6 * P + 4 * (P // 32))
    err = v.fn(*(t.data_ptr() for t in (*args, *its, k, done, rp, rd, snap)),
               B, P, kk["dim_p"], B // 8, P, smem, float(kk["tol_p"]),
               float(kk["tol_d"]), int(kk["k_max"]), int(kk["check_every"]),
               int(bool(kk["exact_k"])),
               torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return results(its, k, done, rp, rd)    # zs, lm, aux


# what runs a source: the entry point's name, its C signature, the launcher
RUNNERS = {
    "fused_admm": ("fused_admm_launch", k1.FUSED_ADMM_ARGTYPES, run_admm),
    "fused_admm_parent": ("fused_admm_launch", PARENT_ADMM_ARGTYPES,
                          run_admm_parent),
    "fused_admm_tc": ("fused_admm_tc_launch", TC_ADMM_ARGTYPES, run_admm_tc),
    "fused_split": ("fused_split_launch", k7.FUSED_SPLIT_ARGTYPES, run_stage),
    "fused_split_parent": ("fused_split_launch", PARENT_SPLIT_ARGTYPES,
                           run_split_parent),
    "fused_hmpc": ("fused_hmpc_launch", k6.FUSED_HMPC_ARGTYPES, run_stage),
    "fused_hmpc_parent": ("fused_hmpc_launch", PARENT_HMPC_ARGTYPES,
                          run_hmpc_parent),
    "fused_soc": ("fused_soc_launch", k5.FUSED_SOC_ARGTYPES, run_stage),
    "fused_soc_parent": ("fused_soc_launch", PARENT_SOC_ARGTYPES,
                         run_soc_parent),
    "fused_ellip": ("fused_ellip_launch", k4.FUSED_ELLIP_ARGTYPES, run_stage),
    "fused_ellip_parent": ("fused_ellip_launch", PARENT_ELLIP_ARGTYPES,
                           run_ellip_parent),
    "fused_fista": ("fused_fista_launch", k2.FUSED_FISTA_ARGTYPES, run_stage),
    "fused_fista_parent": ("fused_fista_launch", PARENT_FISTA_ARGTYPES,
                           run_fista_parent),
    "fused_eadmm": ("fused_eadmm_launch", k3.FUSED_EADMM_ARGTYPES,
                    run_stage),
    "fused_eadmm_parent": ("fused_eadmm_launch", PARENT_EADMM_ARGTYPES,
                           run_eadmm_parent),
}


class Variant:
    """One build of a source and the lanes a block it is launched with.
    `macros` are the defaults of tile_product.cuh the build changes."""

    def __init__(self, name, source: Path, lanes=None, macros=None):
        self.name, self.lanes = name, lanes
        self.stem = source.stem
        self.dir = tile_dir(source, macros or {})
        self.fn = None

    def load(self):
        symbol, argtypes, _ = RUNNERS[self.stem]
        _build.CSRC = self.dir
        _build._LOADED.pop(self.stem, None)
        self.fn = _build.load_kernel(self.stem, symbol, argtypes)
        return _build.build_record(self.stem)

    def run(self, args, kk):
        """Run the variant, which is the build of its source loaded last."""
        return RUNNERS[self.stem][2](self, args, kk)

    def __call__(self, args, kk):
        self.load()
        return self.run(args, kk)

    def fits(self, args, kk):
        """Whether the build takes this call's shape (shared memory)."""
        try:
            self(args, dict(kk, k_max=1))
        except ValueError:
            return False
        return True


def tile_variants(kernel: str):
    """K1's parent first, then the committed header at every tile, then the
    other builds of the product stage."""
    assert kernel == "fused_admm", kernel
    parent = VARIANTS / "fused_admm_parent.cu"
    source = CSRC / "fused_admm.cu"
    out = [Variant("parent (8 lanes, one column a thread)", parent, 8)]

    def add(label, macros, tiles):
        for L, tc in tiles:
            m = dict(macros, TP_COLS_16=tc) if L == 16 and tc != 4 else macros
            out.append(Variant(f"{label} {L}x{tc}", source, L, m))
    add("committed", {}, TILES)
    for name, (macros, tiles) in TILE_BUILDS.items():
        add(name, macros, tiles)
    return out


# K5's and K6's builds besides the committed one at each L: (name, lanes,
# macros); the prefix of a kernel's own macros (HM_, SOC_) is filled in
STAGE_BUILDS = [
    ("no refill", 8, {"TP_REFILL": 0}),
    ("no refill", 16, {"TP_REFILL": 0}),
    ("no refill", 32, {"TP_REFILL": 0}),
    ("slabs of 8, 3 blocks an SM", 8, {"{P}_SLAB_8": 8, "{P}_BLOCKS_8": 3}),
    ("slabs of 16", 32, {"{P}_SLAB_32": 16}),
    ("ring of 3, slabs of 16", 32, {"TP_STAGES": 3, "{P}_SLAB_32": 16}),
    ("clock counts", 8, {"TP_CLOCKS": 1}),
    ("clock counts", 16, {"TP_CLOCKS": 1}),
    ("clock counts", 32, {"TP_CLOCKS": 1}),
]
# K6's own: the cones projected in their warps, lane by lane, as the
# parent does
OWN_BUILDS = {
    "fused_ellip": [],
    # K7's (not STAGE_BUILDS: its plan decides refill, so no macro does):
    # without refill, clock counts, other slab rows and blocks an SM, and
    # the cones projected in their warps, lane by lane, as the parent does
    "fused_split": [
        ("no refill", 8, {"TP_REFILL": 0}),
        ("no refill", 16, {"TP_REFILL": 0}),
        ("no refill", 32, {"TP_REFILL": 0}),
        ("clock counts", 8, {"TP_CLOCKS": 1}),
        ("clock counts", 32, {"TP_CLOCKS": 1}),
        ("slabs of 8, 3 blocks an SM", 8, {"SP_SLAB_8": 8, "SP_BLOCKS_8": 3}),
        ("slabs of 8", 32, {"SP_SLAB_32": 8}),
        ("cones in their warps", 32, {"SP_SPREAD_CONES": 0}),
        ("cones in their warps, clock counts", 32, {"SP_SPREAD_CONES": 0,
                                                    "TP_CLOCKS": 1}),
    ],
    # K3's own: clock counts of an iteration's four parts, and its z2
    # chains reading C2d from shared memory or by __ldg, the other way from
    # the committed build's (no variants of slab rows, ring depth or tile)
    "fused_eadmm": [
        ("clock counts", 8, {"TP_CLOCKS": 1}),
        ("clock counts", 16, {"TP_CLOCKS": 1}),
        ("C2d in shared memory", 8, {"EA_STAGE_C2D_8": 1}),
        ("C2d by __ldg", 16, {"EA_STAGE_C2D_16": 0}),
        ("C2d by __ldg, clock counts", 16, {"EA_STAGE_C2D_16": 0,
                                            "TP_CLOCKS": 1}),
    ],
    # K2's own (it has no refill and no clock counts): slab rows, blocks an
    # SM, columns a thread at 16 lanes, a ring of three slabs
    "fused_fista": [
        ("slabs of 8, 3 blocks an SM", 8, {"FI_SLAB_8": 8, "FI_BLOCKS_8": 3}),
        ("slabs of 8, 2 blocks an SM", 16, {"FI_SLAB_16": 8,
                                            "FI_BLOCKS_16": 2}),
        ("4 columns a thread", 16, {"FI_COLS_16": 4}),
        ("slabs of 8", 32, {"FI_SLAB_32": 8}),
        ("ring of 3", 32, {"TP_STAGES": 3}),
        ("clock counts", 8, {"TP_CLOCKS": 1}),
        ("clock counts", 32, {"TP_CLOCKS": 1}),
    ],
    "fused_hmpc": [
        ("cones in their warps", 8, {"HM_SPREAD_CONES": 0}),
        ("cones in their warps", 32, {"HM_SPREAD_CONES": 0}),
        ("cones in their warps, clock counts", 32, {"HM_SPREAD_CONES": 0,
                                                    "TP_CLOCKS": 1}),
    ],
    # K5's own: the cone's squares broadcast by shuffles, each thread its
    # column of every lane, as the parent does
    "fused_soc": [
        ("cone by shuffles", 32, {"SOC_SPREAD_CONE": 0}),
        ("cone by shuffles, clock counts", 32, {"SOC_SPREAD_CONE": 0,
                                                "TP_CLOCKS": 1}),
    ],
}


def stage_variants(kernel: str):
    """The kernel's parent first, then the committed source at each L, then
    the builds of STAGE_BUILDS (where the kernel takes them) and its own."""
    spec = STAGE[kernel]
    out = [Variant("parent (8 lanes, one column a thread)",
                   VARIANTS / f"{kernel}_parent.cu", 8)]
    builds = ([("committed", L, {}) for L in k1.LANES[::-1]
               if L in spec["module"].BUILDS]
              + (STAGE_BUILDS if spec.get("common", True) else [])
              + OWN_BUILDS[kernel])
    for name, L, macros in builds:
        macros = {m.format(P=spec["prefix"]): x for m, x in macros.items()}
        refill = bool(macros.get("TP_REFILL", 1))
        if kernel == "fused_split":    # the plan decides, not the macro
            macros.pop("TP_REFILL", None)
        v = Variant(f"{name} L={L}", CSRC / f"{kernel}.cu", L, macros)
        v.refill = refill
        v.builds = {
            lanes: (macros.get(f"{spec['prefix']}_SLAB_{lanes}", slab),
                    macros.get(f"{spec['prefix']}_BLOCKS_{lanes}", minb))
            for lanes, (slab, minb) in spec["module"].BUILDS.items()}
        out.append(v)
    return out


def build_all(kernel, candidates):
    """Build every candidate's source, eight at a time; returns those that
    built, with their compiler reports logged."""
    def try_build(v):    # a variant that does not build is reported, not run
        try:
            return _build.build(v.stem, v.dir)[1]
        except RuntimeError as e:
            return e
    firsts = list({(v.dir, v.stem): v for v in candidates}.values())
    with ThreadPoolExecutor(8) as pool:
        records = dict(zip(((v.dir, v.stem) for v in firsts),
                           pool.map(try_build, firsts)))
    built = []
    for v in candidates:
        rec = records[(v.dir, v.stem)]
        if isinstance(rec, RuntimeError):
            c.log(f"{kernel} [{v.name}] DOES NOT BUILD: {str(rec)[-1500:]}")
            continue
        c.log(f"{kernel} [{v.name}] nvcc {rec['seconds']:.1f} s")
        log_ptxas(f"{kernel} [{v.name}]", rec)
        built.append(v)
    return built


def clock_shares(plan, k=None):
    """From a TP_CLOCKS build's counts, each a mean over the blocks (per
    block iteration with refill, whose blocks count their iterations, and
    where k, each lane's iterations, is given, the block's slowest lane's;
    else per block). K4-K6: the clocks of an iteration's element-wise half
    (to the product's first barrier) and of the rest, and the element-wise
    share. K2: the clocks of its iterations and of each product's slab
    loop (G', Winv', G), and the share outside the slab loops. K3: the
    clocks of P1, of the z2 chains, of P2 and of P3 (M3p's product, the
    dual ascent and the keepers), and their shares."""
    clocks = plan["block_clocks"].double() * 1024
    if plan["refill"]:
        iters = plan["block_iterations"].double().clamp(min=1)
    elif k is not None:
        iters = k.reshape(-1, plan["lanes"]).amax(dim=1).double().clamp(
            min=1)
    else:
        iters = torch.ones_like(clocks[:, 0])
    mean = [float((clocks[:, i] / iters).mean())
            for i in range(clocks.shape[1])]
    if "nd" in plan:
        total = sum(mean)
        return dict(clocks_p1=mean[0], clocks_chains=mean[1],
                    clocks_p2=mean[2], clocks_p3=mean[3],
                    shares=[x / total for x in mean])
    if len(mean) == 4:
        total, *prods = mean
        return dict(clocks_iterations=total, clocks_products=prods,
                    share_outside_products=1.0 - sum(prods) / total)
    ew, prod = mean
    return dict(clocks_elementwise=ew, clocks_product=prod,
                elementwise_share=ew / (ew + prod))


def ab_stage(kernel: str, result: dict, only=()):
    """K2-K7: every build against the parent, bit for bit, in every mode
    chip_smoke.py runs; then parent and builds timed in turns at the family
    batches, with each build's group and block iterations. With `only`, the
    parent and the builds whose names hold one of its strings."""
    spec = STAGE[kernel]
    variants = stage_variants(kernel)
    if only:
        variants = variants[:1] + [v for v in variants[1:]
                                   if any(o in v.name for o in only)]
    variants = build_all(kernel, variants)
    parent, builds = variants[0], variants[1:]
    for fam, label, B, kw, extra in spec["modes"]:
        solver = spec["solver"](sp, fam, **kw)
        args, kk = spec["args"](solver, spec["inputs"](fam, B, extra))
        ref = parent(args, kk)
        torch.cuda.synchronize()
        ok = []
        for v in builds:
            if not v.fits(args, kk):
                continue
            out = v(args, kk)
            torch.cuda.synchronize()
            assert same_bits(out, ref, B), (kernel, v.name, fam, label)
            ok.append(v.name)
        c.log(f"{kernel} {fam} {label}: bit-identical to the parent: {ok}")
    timings = spec.get("timings") or [(fam, fam, {}, (c.FB, c.BATCH))
                                      for fam in spec["families"]]
    for fam, label, kw, batches in timings:
        solver = spec["solver"](sp, fam, **kw)
        for B in batches:
            args, kk = spec["args"](solver, spec["inputs"](fam, B, {}))
            run = [parent] + [v for v in builds if v.fits(args, kk)]
            for v in run:
                out = v(args, kk)
                torch.cuda.synchronize()
                k = out[spec.get("k_at", 3)][:B].long()
                it = c.iterations(k, spec["solve"] if v is not parent
                                  else None)
                if "clock" in v.name:
                    it.update(clock_shares(spec["solve"].last_plan,
                                           k if "k_at" in spec else None))
                c.log(f"{kernel} [{v.name}] {label} B={B}: k_mean="
                      f"{float(k.float().mean())} " + json.dumps(it))
            t = time_in_turns(run, args, kk)
            c.log(f"{kernel} {label} B={B} ms (CUDA events, in turns): "
                  + json.dumps(t))
            result[f"{kernel} {label} B={B}"] = {n: min(x)
                                                 for n, x in t.items()}


def same_bits(out, ref, B):
    """Every output of `out` equals `ref`'s exactly on the first B lanes."""
    return all(bool(torch.equal(a[:B], b[:B])) for a, b in zip(out, ref))


def block_iterations(k, lanes):
    """Mean over the blocks of the largest k of a block's lanes."""
    return float(k.reshape(-1, lanes).amax(dim=1).float().mean())


def tile_families(kernel):
    """name -> (solver builder, input builder, argument builder): K1's
    families."""
    assert kernel == "fused_admm", kernel
    plain = lambda B: c.problem(sp, 0, B)[2]  # noqa: E731
    return {
        "laxMPC-ADMM": (lambda: c.fused_solver(
            sp, tile_b=c.TILE_B, check_every=c.CHECK_EVERY, exact_k=True),
            plain, c.kernel_args),
        "equMPC-ADMM": (lambda: c.family_solver(sp, "equMPC-ADMM"), plain,
                        c.kernel_args),
        "MPCT-ADMM-cs": (lambda: c.mpct_solver(sp, "MPCT-ADMM-cs"), plain,
                         c.kernel_args),
    }


def time_in_turns(variants, args, kk, reps=3):
    t = {v.name: [] for v in variants}
    for v in list(variants) + list(variants)[::-1]:
        v.load()
        t[v.name].append(c.cuda_ms(lambda: v.run(args, kk), reps=reps))
    return t


def ab_tile(kernel: str, result: dict, only=()):
    """Build, check against the parent and time every variant of K1; with
    `only`, the parent and the builds whose names hold one of its strings,
    and not K1's bf16 and sort_lanes timings."""
    # the state buffers alone at 64 lanes a block: K1's z, v, lam and dq as
    # [width][64] floats
    width = 256
    c.log(f"{kernel} at width {width}: the four [width][64] buffers of 64 "
          f"lanes a block take {4 * 4 * width * 64} of {k1.SMEM_MAX} bytes "
          f"before the ring: not built")
    candidates = tile_variants(kernel)
    if only:
        candidates = candidates[:1] + [v for v in candidates[1:]
                                       if any(o in v.name for o in only)]
    elif kernel == "fused_admm":
        candidates += bf16_variants()[2:]
    variants = [v for v in build_all(kernel, candidates)
                if v.stem != "fused_admm_tc"]
    for fam, (make, inputs, make_args) in tile_families(kernel).items():
        solver = make()
        for B in (c.SMALL_BATCH, c.FB, c.BATCH):
            args, kk = make_args(solver, inputs(B))
            nzp = args[0].shape[1]
            run = [v for v in variants if v.fits(args, kk)]
            c.log(f"{kernel} {fam} B={B}: not run, the shape does not fit "
                  f"their shared memory: "
                  f"{[v.name for v in variants if v not in run]}")
            ref = run[0](args, kk)
            torch.cuda.synchronize()
            k = ref[3][:B]
            c.log(f"{kernel} {fam} B={B} width={nzp}: k_mean="
                  f"{float(k.float().mean())} converged="
                  f"{float((ref[4][:B] == 1).float().mean())} mean block "
                  f"iterations " + json.dumps(
                      {L: block_iterations(k, L) for L in (8, 16, 32)}))
            for v in run[1:]:
                out = v(args, kk)
                torch.cuda.synchronize()
                ok = same_bits(out, ref, B)
                c.log(f"{kernel} [{v.name}] {fam} B={B}: bit-identical to "
                      f"the parent: {ok}")
                assert ok, (kernel, v.name, fam, B)
            t = time_in_turns(run, args, kk)
            c.log(f"{kernel} {fam} B={B} ms (CUDA events, in turns): "
                  + json.dumps(t))
            result[f"{kernel} {fam} B={B}"] = {n: min(x)
                                               for n, x in t.items()}
    if kernel == "fused_admm" and not only:
        ab_bf16(result)
        ab_sort_lanes(result)


def bf16_variants():
    tc = VARIANTS / "fused_admm_tc.cu"
    return [
        Variant("parent bf16 (CUDA cores, 8 lanes)",
                VARIANTS / "fused_admm_parent.cu", 8),
        Variant("bf16 CUDA cores 32x4", CSRC / "fused_admm.cu", 32),
        Variant("bf16 tensor cores L=16", tc, 16),
        Variant("bf16 tensor cores L=32", tc, 32),
    ]


def ab_bf16(result: dict):
    """K1's bf16 mode at the headline: tensor cores (16 and 32 lanes a
    block), CUDA cores and the parent, each against the plain version."""
    variants = bf16_variants()
    solver = c.fused_solver(sp, tile_b=c.TILE_B, check_every=c.CHECK_EVERY,
                            exact_k=True, bf16_delta=True)
    for B in (c.SMALL_BATCH, c.BATCH):
        args, kk = c.kernel_args(solver, c.problem(sp, 0, B)[2])
        ref = k1.fused_admm_reference(*args, **kk)
        for v in variants:
            out = v(args, kk)
            torch.cuda.synchronize()
            a = c.agreement(out, ref, B, solver.m, False)
            dk = (out[3][:B] - ref[3][:B]).abs()
            a["k_within_1"] = float((dk <= 1).float().mean())
            a["k_within_16"] = float((dk <= 16).float().mean())
            a["dk_max"] = int(dk.max())
            c.log(f"fused_admm [{v.name}] bf16 vs plain B={B}: "
                  + json.dumps(a))
        t = time_in_turns(variants, args, kk)
        c.log(f"fused_admm bf16 B={B} ms (CUDA events, in turns): "
              + json.dumps(t))
        result[f"fused_admm bf16 B={B}"] = {n: min(x) for n, x in t.items()}


def ab_sort_lanes(result: dict):
    """The headline solver with sort_lanes off and on, at the dispatch's L."""
    Variant("committed", CSRC / "fused_admm.cu").load()
    x = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
         for a in c.problem(sp, 0, c.BATCH)[2]]
    t = {}
    for sort in (False, True, True, False):
        solver = c.fused_solver(sp, tile_b=c.TILE_B,
                                check_every=c.CHECK_EVERY, exact_k=True,
                                sort_lanes=sort)
        solver.options.timing = False
        res = solver(*x)
        t.setdefault(f"sort_lanes={sort}", []).append(
            c.cuda_ms(lambda: solver(*x), reps=3))
        c.log(f"fused_admm laxMPC-ADMM solver B={c.BATCH} sort_lanes={sort}: "
              f"k_mean={float(res.k.float().mean())} plan="
              f"{k1.fused_admm_solve.last_plan}")
    c.log(f"fused_admm laxMPC-ADMM solver B={c.BATCH} ms (CUDA events): "
          + json.dumps(t))
    result["fused_admm sort_lanes"] = {n: min(v) for n, v in t.items()}


def main(kernels):
    only = ()    # --only a,b: the builds whose names hold a or b
    if "--only" in kernels:
        i = kernels.index("--only")
        only = tuple(kernels[i + 1].split(","))
        kernels = kernels[:i] + kernels[i + 2:]
    c.require_cuda()
    if os.environ.get("SPCIES_LOG_DIR"):    # the lines also go to a file there
        out = Path(os.environ["SPCIES_LOG_DIR"])
        out.mkdir(parents=True, exist_ok=True)
        c.LOG_FILE = open(out / "ab_kernels.log", "w")
    torch.set_float32_matmul_precision("highest")
    c.log(c.card_line())
    result = {}
    for kernel in kernels or ["fused_admm", *STAGE]:
        if kernel in STAGE:
            ab_stage(kernel, result, only)
        else:
            ab_tile(kernel, result, only)
    _build.CSRC = CSRC
    c.log(json.dumps(result))


if __name__ == "__main__":
    main(sys.argv[1:])
