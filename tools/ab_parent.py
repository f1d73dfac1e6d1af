#!/usr/bin/env python3
"""Each kernel built from an earlier source tree against the working tree's
build, on one CUDA card, in one process: ptxas's registers and spills of
every function of the narrow builds' translation unit, then the kernels'
outputs bit for bit and their times in turns at the N=30 shapes each
kernel serves (the bench's families at B=8192; K1 also at the laxMPC-ADMM
headline, B=32768, fp32 and bf16), through the working tree's wrappers
(the earlier tree must take the same C signatures for the narrow builds).

ptxas's allocation of one and the same text moves with the compile's file
path, include directories and file contents (the anonymous namespace's
mangled name hashes them): on an H100, K2's 8-lane two-blocks-an-SM build
takes 0 or 8 bytes of spill stores for the earlier tree's own text
(PERF.md §6). So the two trees' narrow translation units
(-DWIDE_PART=0; kernels/_build.py) are compiled for the report at one path
with one command line, and the earlier tree's also at a second path and,
at the first path, with a comment line appended to each of its files: a
function whose report moves there too moves with the path or the files'
contents, not the code.

The earlier tree is a directory holding its csrc/ (sources and headers),
for example the parent commit's:

    mkdir -p scratch_checkout/parent
    git archive HEAD~1 spcies_tpu_torch/csrc | tar -x -C scratch_checkout/parent
    python3 tools/ab_parent.py scratch_checkout/parent/spcies_tpu_torch/csrc \\
        [fused_fista fused_eadmm ...]

Run from the repository root; with no kernel named, all seven. Each shape
is timed parent, change, change, parent, twice, each a CUDA-event mean of 3
launches. With SPCIES_LOG_DIR set, every line also goes to ab_parent.log
in that directory.

With --wide, K2-K7's wide builds instead: each kernel's family at
chip_smoke.py's WIDE_HORIZONS, B=8192, and at its WIDE_EXTRA
(ellipHMPC-ADMM N=62 for K6, HMPC-SADMM-split N=58 for K7, MPCT-EADMM on
two random plants at 1024 columns for K3's __ldg path), with the
ptxas report of every function (the wide kernels' registers and spills
may move) and no comparison of them. Where the earlier tree's wide build
of a kernel still ran the first wide layout (8 lanes a block, the blocks'
state in global memory: its wide launch takes `state`), that launch is
called with its own C signature (PARENT_WIDE: K2-K7), the working tree's
through its wrappers; else both through the wrappers. For every wide
build (all on the stage) the working tree's other lanes-a-block wide
builds are also held to its planned one bit for bit
and timed, and a build of it with TP_CLOCKS gives the clocks of an
iteration's parts (tools/ab_kernels.py clock_shares: K4-K7's element-wise
half and product, K2's iterations and products, K3's P1, z2 chains, P2
and P3) at each lanes a block. For example, against the commit before K2
and K3 moved onto the stage:

    mkdir -p scratch_checkout/parent
    git archive 27aecea spcies_tpu_torch/csrc | tar -x -C scratch_checkout/parent
    python3 tools/ab_parent.py --wide \
        scratch_checkout/parent/spcies_tpu_torch/csrc fused_fista fused_eadmm
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from spcies_tpu_torch.kernels import _build  # noqa: E402

# kernel -> the N=30 shapes it is timed at: (label, family, batch, solver
# options); the K1 families other than the headline take K1's arguments
# from chip_smoke.kernel_args
CASES = {
    "fused_admm": [("laxMPC-ADMM headline", "laxMPC-ADMM", c.BATCH, {}),
                   ("laxMPC-ADMM headline bf16", "laxMPC-ADMM", c.BATCH,
                    dict(bf16_delta=True)),
                   ("MPCT-ADMM-cs", "MPCT-ADMM-cs", c.FB, {}),
                   ("equMPC-ADMM", "equMPC-ADMM", c.FB, {})],
    "fused_fista": [("laxMPC-FISTA", "laxMPC-FISTA", c.FB, {}),
                    ("equMPC-FISTA", "equMPC-FISTA", c.FB, {})],
    "fused_eadmm": [("MPCT-EADMM", "MPCT-EADMM", c.FB, {})],
    "fused_ellip": [("ellipMPC-ADMM", "ellipMPC-ADMM", c.FB, {})],
    "fused_soc": [("ellipMPC-ADMM-soc", "ellipMPC-ADMM-soc", c.FB, {})],
    "fused_hmpc": [("HMPC-ADMM", "HMPC-ADMM", c.FB, {}),
                   ("ellipHMPC-ADMM", "ellipHMPC-ADMM", c.FB, {})],
    "fused_split": [("HMPC-ADMM-split", "HMPC-ADMM-split", c.FB, {}),
                    ("HMPC-SADMM-split", "HMPC-SADMM-split", c.FB, {})],
}
# the wide launches on the first wide layout: K2, 19 pointers (the 11
# inputs, the 6 outputs, the exact-k snapshot, the blocks' state); B, nzp,
# nlamp, blocks, threads, shared bytes; tol; k_max, restart, check_every,
# fixed_iters, exact_k; the stream. K3, 30 pointers (the 18 inputs with
# C2m's and C2t's classes, the 10 outputs, the snapshot, the state); B, Z,
# nd, blocks, threads, shared bytes; tol; k_max, check_every, exact_k; the
# stream. K4-K7, 17 pointers (the inputs, the outputs, the exact-k
# snapshot, the blocks' state); then K4:
# B, nzp, t0, n, blocks, threads, shared bytes; rho, 1/rho, r, tol_p,
# tol_d; k_max, check_every, fixed_iters, exact_k; K5: B, P, dim_p, blocks,
# threads, shared bytes; tol_p, tol_d; k_max, check_every, exact_k; K6: B,
# dim_p, ns_p, cone0, cone_g, use_soc, blocks, threads, shared bytes; rho,
# 1/rho, tol_p, tol_d; k_max, check_every, exact_k; K7: as K5's with cone0,
# cone_g, symmetric, use_soc after dim_p and alpha before tol_p; the stream
PARENT_WIDE = {
    "fused_fista": ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 5
                    + [ctypes.c_void_p]),
    "fused_eadmm": ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p]),
    "fused_ellip": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p]),
    "fused_soc": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                  + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p]),
    "fused_hmpc": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p]),
    "fused_split": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
                    + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p]),
}
# where k lies in the outputs of the wide builds without refill, whose
# clocks are each block's over its slowest lane's iterations
K_AT = {"fused_fista": 3, "fused_eadmm": 5}
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# the anonymous namespace's mangled name carries hashes of the source file
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_(\d+_\w+?_cu)_[0-9a-f]{8}")


def resources(log: str) -> dict:
    """Function -> (registers, spill stores, spill loads) from ptxas -v."""
    out, fn, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            fn, spill = _ANON.sub(r"_GLOBAL__N__\1", m.group(1)), (0, 0)
            continue
        m = _SPILL.search(line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m and fn:
            out[fn] = (int(m.group(1)),) + spill
            fn = None
    return out


def narrow_report(name: str, runs: list[tuple[Path, str]]) -> list[dict]:
    """ptxas's report (resources) of the narrow translation unit of
    <name>.cu for each (tree, staging directory) of `runs`, in turn, by one
    command line (runs that share a staging directory compile at one
    path)."""
    import shutil
    import subprocess
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    out = []
    for tree, where in runs:
        stage = (_build.BUILD_DIR / where / name / "spcies_tpu_torch"
                 / "csrc")
        cmd = [_build._nvcc(), *flags, "-c", "-DWIDE_PART=0", "-I",
               str(stage), "-o", str(stage / "narrow.o"),
               str(stage / f"{name}.cu")]
        shutil.rmtree(stage, ignore_errors=True)
        stage.mkdir(parents=True)
        for f in list(tree.glob("*.cu")) + list(tree.glob("*.cuh")):
            shutil.copy(f, stage / f.name)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        out.append(resources(proc.stdout + proc.stderr))
    return out


def takes_state(tree: Path, name: str) -> bool:
    """Whether the wide launch of <name>.cu in `tree` is the first wide
    layout's (its C signature takes `state`)."""
    src = (tree / f"{name}.cu").read_text()
    head = src.find(f'extern "C" int {name}_wide_launch(')
    return head >= 0 and "float* state" in src[head:src.index("{", head)]


def parent_wide(name, lib, args, kk):
    """A wide build on the first wide layout (PARENT_WIDE): one block of
    512 threads per 8 lanes, its leaves in global memory, the products'
    inputs (K6: the prepared z and w) and the row maxima in shared memory.
    Returns the wrapper's outputs."""
    fn = getattr(lib, f"{name}_wide_launch")
    fn.argtypes, fn.restype = PARENT_WIDE[name], ctypes.c_int
    if name in ("fused_fista", "fused_eadmm"):
        return parent_wide_k2_k3(name, fn, args, kk)
    B, P = args[0].shape
    dev = args[0].device
    outs = [torch.empty_like(args[i]) for i in
            ((0, 1, 2) if name != "fused_hmpc" else (0, 1, 1))]
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    exact = kk["check_every"] > 1 and kk["exact_k"] and not kk.get(
        "fixed_iters", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = [int(kk["k_max"]), int(kk["check_every"])]
    if name == "fused_ellip":
        n = args[4].shape[0]
        width = 3 * P
        state = 4 * P
        ints = [B, P, int(kk["t0"]), n, B // 8, 512, 4 * 8 * (2 * P + 64)]
        floats = [float(kk["rho"]), float(1.0 / kk["rho"]),
                  float(kk["r_ball"]), float(kk["tol_p"]),
                  float(kk["tol_d"])]
        tail.append(int(kk.get("fixed_iters", 0)))
    elif name == "fused_hmpc":
        ns_p = args[1].shape[1]
        width = state = P + 2 * ns_p
        ints = [B, P, ns_p, int(kk["cone0"]), int(kk["cone_g"]),
                int(bool(kk["use_soc"])), B // 8, 512,
                4 * 8 * (P + ns_p + 32)]
        floats = [float(kk["rho"]), float(1.0 / kk["rho"]),
                  float(kk["tol_p"]), float(kk["tol_d"])]
    else:
        split = name == "fused_split"
        width, state = 3 * P, 4 * P
        ints = [B, P, int(kk["dim_p"])] + ([
            int(kk["cone0"]), int(kk["cone_g"]), int(bool(kk["symmetric"])),
            int(bool(kk["use_soc"]))] if split else []) + [
            B // 8, 512, 4 * 8 * (2 * P + 4 * 16)]
        floats = ([float(kk["alpha"])] if split else []) + [
            float(kk["tol_p"]), float(kk["tol_d"])]
    tail.append(int(bool(kk["exact_k"])))
    snap = torch.empty((B if exact else 0, width), dtype=torch.float32,
                       device=dev)
    scratch = torch.empty((B * state,), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in args + (*outs, k, done, rp, rd, snap,
                                          scratch)]
    err = fn(*ptrs, *ints, *floats, *tail, stream)
    assert err == 0, (name, err)
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return (*outs, k, e_flag, rp, rd)


def parent_wide_k2_k3(name, fn, args, kk):
    """K2's or K3's wide launch on the first wide layout (`fn`, with its
    C signature set), through the working tree's wrapper's arguments:
    shared bytes as that layout reckoned them (K2: dz, r and dy as
    [columns][8] and 16 warps' row maxima; K3: dv2m, dv2t and dq3 as
    [Z][8], 16 warps' three row maxima and C2d), the blocks' state in
    global memory. Returns the wrapper's outputs."""
    B = args[0].shape[0]
    dev = args[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    exact = kk["check_every"] > 1 and kk["exact_k"] and not kk.get(
        "fixed_iters", 0)
    if name == "fused_fista":
        nzp, nlamp = args[0].shape[1], args[2].shape[1]
        z, y, lam = (torch.empty_like(args[i]) for i in (0, 2, 2))
        res = torch.empty((B,), dtype=torch.float32, device=dev)
        width = 2 * nzp + 3 * nlamp
        snap = torch.empty((B if exact else 0, width), dtype=torch.float32,
                           device=dev)
        state = torch.empty((B * width,), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in args + (z, y, lam, k, done, res, snap,
                                              state)]
        err = fn(*ptrs, B, nzp, nlamp, B // 8, 512,
                 4 * 8 * (nzp + 2 * nlamp + 16), float(kk["tol"]),
                 int(kk["k_max"]), int(bool(kk["restart"])),
                 int(kk["check_every"]), int(kk.get("fixed_iters", 0)),
                 int(bool(kk["exact_k"])), stream)
        assert err == 0, (name, err)
        return z, y, lam, k, torch.where(done == 1, 1, -1).to(
            torch.int32), res
    from spcies_tpu_torch.kernels.fused_eadmm import narrow_operands
    Z = args[0].shape[1]
    c2d, c2td, col_of = kk.get("classes") or narrow_operands(args[6],
                                                             args[7])
    nd = c2d.shape[1]
    outs = tuple(torch.empty_like(args[0]) for _ in range(5))
    res = tuple(torch.empty((B,), dtype=torch.float32, device=dev)
                for _ in range(3))
    snap = torch.empty((B if exact else 0, 7 * Z), dtype=torch.float32,
                       device=dev)
    state = torch.empty((B * 9 * Z,), dtype=torch.float32, device=dev)
    ins = args[:6] + (c2d, c2td, col_of) + args[8:]
    ptrs = [t.data_ptr() for t in ins + outs + (k, done) + res + (snap,
                                                                  state)]
    err = fn(*ptrs, B, Z, nd, B // 8, 512,
             4 * (3 * Z * 8 + 3 * 16 * 8 + Z * nd), float(kk["tol"]),
             int(kk["k_max"]), int(kk["check_every"]),
             int(bool(kk["exact_k"])), stream)
    assert err == 0, (name, err)
    return outs + (k, torch.where(done == 1, 1, -1).to(torch.int32)) + res


def args_of(sp, fam, B, **kw):
    """(kernel wrapper, its arguments, its keyword arguments) of a family's
    fused solver (with `kw`) on B lanes of the bench's inputs."""
    if fam in ("MPCT-ADMM-cs", "equMPC-ADMM"):
        from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
        solver = (c.mpct_solver(sp, fam) if fam == "MPCT-ADMM-cs"
                  else c.family_solver(sp, fam))
        args, kk = c.kernel_args(solver, c.problem(sp, 0, B)[2])
        return fused_admm_solve, args, kk
    name, kern = c.fam_kernel(fam)[:2]
    solver = c.fam_solver(sp, fam, **kw)
    args, kk = c.fam_args(sp, fam, solver, B, plant=kw.get("plant"))
    return kern, args, dict(kk, **c.kernel_extra(name, solver))


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    c.require_cuda()
    import spcies_tpu_torch as sp
    torch.set_float32_matmul_precision("highest")
    if os.environ.get("SPCIES_LOG_DIR"):
        out = Path(os.environ["SPCIES_LOG_DIR"])
        out.mkdir(parents=True, exist_ok=True)
        c.LOG_FILE = open(out / "ab_parent.log", "w")
    c.log(c.card_line())
    wide = "--wide" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--wide"]
    parent_dir = Path(argv[0]).resolve()
    names = argv[1:] or (list(c.WIDE_FAMILY) if wide else list(CASES))
    # both trees built afresh beside the cache, for ptxas's reports
    _build.BUILD_DIR = _build.BUILD_DIR / f"ab_parent_{os.getpid()}"
    jobs = [(n, d) for n in names for d in (parent_dir, None)]
    clocks = _build.BUILD_DIR / "clocks"
    if wide:
        # the working tree built with TP_CLOCKS, for the clocks of the wide
        # builds
        clocks.mkdir(parents=True)
        for f in list(_build.CSRC.glob("*.cu")) + list(
                _build.CSRC.glob("*.cuh")):
            (clocks / f.name).write_text(
                ("#define TP_CLOCKS 1\n" if f.stem in c.WIDE_FAMILY else "")
                + f.read_text())
        jobs += [(n, clocks) for n in names]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _build.build(*j), jobs)))
        touched = _build.BUILD_DIR / "parent_touched"
        if not wide:
            touched.mkdir(parents=True)
            for f in list(parent_dir.glob("*.cu")) + list(
                    parent_dir.glob("*.cuh")):
                (touched / f.name).write_text(f.read_text()
                                              + "\n// a comment line\n")
        runs = [(parent_dir, "stage"), (_build.CSRC, "stage"),
                (parent_dir, "stage_elsewhere"), (touched, "stage")]
        reports = ({} if wide else dict(zip(names, pool.map(
            lambda n: narrow_report(n, runs), names))))
    for name in names:
        (lib_p, rec_p), (lib_c, rec_c) = (built[(name, parent_dir)],
                                          built[(name, None)])
        if wide:
            c.log(f"{name} ptxas (registers, spill stores, spill loads): "
                  f"parent {json.dumps(resources(rec_p['log']))} change "
                  f"{json.dumps(resources(rec_c['log']))}")
        else:
            res_p, res_c, res_e, res_t = reports[name]
            moved = {f: (r, res_c.get(f), res_e.get(f), res_t.get(f))
                     for f, r in res_p.items() if res_c.get(f) != r}
            same = not moved and set(res_p) == set(res_c)
            c.log(f"{name}: the narrow translation unit's {len(res_p)} "
                  f"functions (parent) and {len(res_c)} (change), compiled "
                  f"at one path: registers and spills unchanged: {same}; "
                  + (json.dumps(res_c) if same else
                     "moved (parent, change, parent at another path, "
                     "parent with a comment appended): "
                     + json.dumps(moved)))
        libs = {"parent": (ctypes.CDLL(str(lib_p)), rec_p),
                "change": (ctypes.CDLL(str(lib_c)), rec_c)}
        if (name, clocks) in built:
            lib_k, rec_k = built[(name, clocks)]
            libs["clocks"] = (ctypes.CDLL(str(lib_k)), rec_k)
        cases = ([(f"{what} (wide)", fam, c.FB, dict(horizon=h, **pk))
                  for fam, h, pk, what in c.wide_runs(name)]
                 if wide else CASES[name])
        for label, fam, B, kw in cases:
            kern, args, kk = args_of(sp, fam, B, **kw)

            def run(key):
                _build._LOADED[name] = libs[key]
                if (wide and key == "parent" and name in PARENT_WIDE
                        and takes_state(parent_dir, name)):
                    return parent_wide(name, libs[key][0], args, kk)
                return kern(*args, **kk)

            outs = {key: run(key) for key in ("parent", "change")}
            plan = getattr(kern, "last_plan", None) or {}
            c.log(f"{name} {label}: change's plan " + json.dumps(
                {k: v for k, v in plan.items() if not torch.is_tensor(v)}))
            torch.cuda.synchronize()
            same = all(bool(torch.equal(a, b))
                       for a, b in zip(outs["parent"], outs["change"]))
            t = {"parent": [], "change": []}
            for key in ("parent", "change", "change", "parent") * 2:
                t[key].append(c.cuda_ms(lambda: run(key), reps=3))
            c.log(f"{name} {label} B={B}: bits equal {same}; ms "
                  + json.dumps(t) + f"; least parent {min(t['parent'])} "
                  f"change {min(t['change'])} (change / parent "
                  f"{min(t['change']) / min(t['parent']):.4f})")
            assert same, (name, label)
            if "clocks" in libs:
                c.log(f"{name} {label}: the change's builds "
                      + json.dumps(stage_builds(name, libs, kern, args, kk)))
        _build._LOADED[name] = libs["change"]


def stage_builds(name, libs, kern, args, kk):
    """A wide build on the stage of the working tree at each lanes a
    block: the bits of the planned one (those of the last call) and the
    least of two CUDA-event means of 3 launches; then the clocks of an
    iteration's parts in the TP_CLOCKS build (K2, K3: each block's over its
    slowest lane's iterations, K_AT)."""
    from ab_kernels import clock_shares
    from spcies_tpu_torch.kernels.stage import WIDE_BUILDS
    _build._LOADED[name] = libs["change"]
    planned = kern(*args, **kk)
    out = {}
    for L in sorted(WIDE_BUILDS):
        o = kern(*args, **kk, lanes=L)
        torch.cuda.synchronize()
        out[f"lanes={L}"] = dict(
            bits_equal=all(bool(torch.equal(a, b))
                           for a, b in zip(o, planned)),
            ms=min(c.cuda_ms(lambda: kern(*args, **kk, lanes=L), reps=3)
                   for _ in range(2)),
            global_leaves=kern.last_plan["global_leaves"],
            slab=kern.last_plan["slab"])
    _build._LOADED[name] = libs["clocks"]
    for L in sorted(WIDE_BUILDS):
        o = kern(*args, **kk, lanes=L)
        torch.cuda.synchronize()
        k = o[K_AT[name]] if name in K_AT else None
        out[f"lanes={L}"].update(clock_shares(kern.last_plan, k))
    _build._LOADED[name] = libs["change"]
    return out


if __name__ == "__main__":
    main()
