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
with one command line, and the earlier tree's also at a second path: a
function whose report moves there too moves with the path, not the code.

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

With --wide, K2-K7's wide builds instead (both trees must have them, with
the same C signatures): each kernel's family at chip_smoke.py's
WIDE_HORIZONS, B=8192, with the ptxas report of every function (the wide
kernels' registers and spills may move) and no comparison of them.
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
    args, kk = c.fam_args(sp, fam, solver, B)
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
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _build.build(*j), jobs)))
        runs = [(parent_dir, "stage"), (_build.CSRC, "stage"),
                (parent_dir, "stage_elsewhere")]
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
            res_p, res_c, res_e = reports[name]
            moved = {f: (r, res_c.get(f), res_e.get(f))
                     for f, r in res_p.items() if res_c.get(f) != r}
            same = not moved and set(res_p) == set(res_c)
            c.log(f"{name}: the narrow translation unit's {len(res_p)} "
                  f"functions (parent) and {len(res_c)} (change), compiled "
                  f"at one path: registers and spills unchanged: {same}; "
                  + (json.dumps(res_c) if same else
                     "moved (parent, change, parent at another path): "
                     + json.dumps(moved)))
        libs = {"parent": (ctypes.CDLL(str(lib_p)), rec_p),
                "change": (ctypes.CDLL(str(lib_c)), rec_c)}
        cases = ([(f"{c.WIDE_FAMILY[name]} N={h} (wide)",
                   c.WIDE_FAMILY[name], c.FB, dict(horizon=h))
                  for h in c.WIDE_HORIZONS[name]] if wide else CASES[name])
        for label, fam, B, kw in cases:
            kern, args, kk = args_of(sp, fam, B, **kw)

            def run(key):
                _build._LOADED[name] = libs[key]
                return kern(*args, **kk)

            outs = {key: run(key) for key in ("parent", "change")}
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
        _build._LOADED[name] = libs["change"]


if __name__ == "__main__":
    main()
