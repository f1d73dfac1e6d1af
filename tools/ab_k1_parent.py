#!/usr/bin/env python3
"""K1 built from an earlier source tree against the working tree's K1, on
one CUDA card, in one process: bit for bit and timed in turns at the N=30
shapes K1 serves (the laxMPC-ADMM headline at B=32768, fp32 and bf16;
MPCT-ADMM-cs and equMPC-ADMM at B=8192).

The earlier tree is a directory holding its csrc/fused_admm.cu (the
headers come from the working tree), with the C signature K1 had before
its wide build (no `wide` argument), for example the parent commit's:

    mkdir -p scratch_checkout/k1_parent
    git archive HEAD~1 spcies_tpu_torch/csrc/fused_admm.cu \\
        | tar -x -C scratch_checkout/k1_parent
    python3 tools/ab_k1_parent.py \\
        scratch_checkout/k1_parent/spcies_tpu_torch/csrc

Run from the repository root. Each shape is timed parent, change, change,
parent, twice, each a CUDA-event mean of 5 launches. With SPCIES_LOG_DIR
set, every line also goes to ab_k1_parent.log in that directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from spcies_tpu_torch.kernels import _build  # noqa: E402
from spcies_tpu_torch.kernels import fused_admm as k1  # noqa: E402

# fused_admm_launch before the wide build: FUSED_ADMM_ARGTYPES less `wide`
PARENT_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])


def parent_launcher(csrc: Path):
    """fused_admm_solve's CUDA path on the parent's build of `csrc`."""
    lib, _rec = _build.build("fused_admm", csrc)
    fn = ctypes.CDLL(str(lib)).fused_admm_launch
    fn.argtypes, fn.restype = PARENT_ARGTYPES, ctypes.c_int

    def solve(z1, v0, lam0, M, LB, UB, *, rho, tol_p, tol_d, k_max, tile_b,
              bf16, relax_alpha, check_every, fixed_iters, exact_k):
        B, nzp = z1.shape
        plan = k1.launch_plan(B, nzp, tile_b=tile_b, check_every=check_every,
                              exact_k=exact_k, fixed_iters=fixed_iters)
        dev = z1.device
        z, v, lam = (torch.empty_like(z1) for _ in range(3))
        k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
                   for _ in range(2))
        rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
                  for _ in range(2))
        exact = check_every > 1 and exact_k and not fixed_iters
        snap = torch.empty((B if exact else 0, k1.SNAP_LEAVES * nzp),
                           dtype=torch.float32, device=dev)
        m_round = torch.empty((nzp if bf16 else 0, nzp), dtype=torch.float32,
                              device=dev)
        ptrs = [t.data_ptr() for t in (z1, v0, lam0, M, LB, UB, z, v, lam, k,
                                       done, rp, rd, snap, m_round)]
        a = float(relax_alpha)
        err = fn(*ptrs, B, nzp, plan["lanes"], plan["blocks"],
                 plan["threads"], plan["smem"], float(rho), float(1.0 / rho),
                 a, 1.0 - a, int(a != 1.0), float(tol_p), float(tol_d),
                 int(k_max), int(check_every), int(fixed_iters),
                 int(bool(exact_k)), int(bool(bf16)),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent launch failed with CUDA error {err}")
        return z, v, lam, k, torch.where(done == 1, 1, -1).to(torch.int32), \
            rp, rd

    return solve


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    c.require_cuda()
    import spcies_tpu_torch as sp
    torch.set_float32_matmul_precision("highest")
    if os.environ.get("SPCIES_LOG_DIR"):
        out = Path(os.environ["SPCIES_LOG_DIR"])
        out.mkdir(parents=True, exist_ok=True)
        c.LOG_FILE = open(out / "ab_k1_parent.log", "w")
    c.log(c.card_line())
    _build.build("fused_admm")
    _build.load_kernel("fused_admm", "fused_admm_launch",
                       k1.FUSED_ADMM_ARGTYPES)
    parent = parent_launcher(Path(sys.argv[1]).resolve())
    exact = dict(tile_b=c.TILE_B, check_every=c.CHECK_EVERY, exact_k=True)
    cases = [
        ("laxMPC-ADMM headline", c.fused_solver(sp, **exact), c.BATCH),
        ("MPCT-ADMM-cs", c.mpct_solver(sp, "MPCT-ADMM-cs"), c.FB),
        ("equMPC-ADMM", c.family_solver(sp, "equMPC-ADMM"), c.FB),
        ("laxMPC-ADMM headline bf16",
         c.fused_solver(sp, bf16_delta=True, **exact), c.BATCH),
    ]
    for label, solver, B in cases:
        _, _, inputs = c.problem(sp, 0, B)
        args, kk = c.kernel_args(solver, inputs)
        fns = {"parent": lambda: parent(*args, **kk),
               "change": lambda: k1.fused_admm_solve(*args, **kk)}
        same = all(bool(torch.equal(a, b))
                   for a, b in zip(fns["parent"](), fns["change"]()))
        t = {"parent": [], "change": []}
        for key in ("parent", "change", "change", "parent") * 2:
            t[key].append(c.cuda_ms(fns[key], reps=5))
        c.log(f"{label} B={B}: bits equal {same}; ms " + json.dumps(t)
              + f"; least parent {min(t['parent'])} change "
              f"{min(t['change'])}")
        assert same, label


if __name__ == "__main__":
    main()
