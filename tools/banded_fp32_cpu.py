"""fp32 against fp64 on the CPU for the banded backends of chip_smoke.py
phase 20 (HMPC-ADMM, HMPC-ADMM-split, HMPC-SADMM-split and
MPCT-ADMM-semiband at LONG_FAMILIES' settings, tol 1e-4), before the card
runs them: per family and horizon, each fp32 engine's share of lanes whose
k equals the fp64 dense engine's, its largest move in iterations, and the
fp32 banded engines against the fp32 dense one. The bar the card's fp32
rows are held to comes from here.

    PYTHONPATH=. python tools/banded_fp32_cpu.py [--lanes 256] [--long 64]
        [--families HMPC-ADMM,...]

N=30 on --lanes lanes (dense, the sequential band solve and the scan; 0
skips it); N=120 on --long lanes (dense and the scan; the sequential
solve is the scan's iteration in another sum order). One JSON line a
row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import chip_smoke as c
import spcies_tpu_torch as sp


def run(fam, horizon, backend, precision, x, **extra):
    s = c.long_solver(sp, fam, horizon, backend, precision, "cpu", **extra)
    return s(*x)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--long", type=int, default=64)
    ap.add_argument("--families", default="HMPC-ADMM,HMPC-ADMM-split,"
                    "HMPC-SADMM-split,MPCT-ADMM-semiband")
    args = ap.parse_args()
    torch.set_num_threads(4)
    fams = args.families.split(",")
    for horizon, B, engines in (
            (c.N, args.lanes, (("dense", {}), ("banded", {}),
                               ("banded", c.SCAN))),
            (c.LONG_CONV_N, args.long, (("dense", {}),
                                        ("banded", c.SCAN)))):
        if not B:
            continue
        for fam in fams:
            t0 = time.perf_counter()
            x = c.long_inputs(sp, fam, horizon, B, 21)
            ref = run(fam, horizon, "dense", "double", x)
            k64 = ref.k.numpy().astype(int)
            out = dict(family=fam, N=horizon, B=B,
                       fp64_dense_k_mean=float(k64.mean()),
                       fp64_converged=bool((ref.e_flag == 1).all()))
            k32 = {}
            for backend, extra in engines:
                name = c.long_label(fam, horizon, B, backend, extra).split()
                name = name[1] if name[1] != "time-varying" else name[2]
                r = run(fam, horizon, backend, "float", x, **extra)
                k = r.k.numpy().astype(int)
                k32[name] = k
                out[name] = dict(
                    converged=bool((r.e_flag == 1).all()),
                    k_equal_fp64=float((k == k64).mean()),
                    max_move_fp64=int(np.abs(k - k64).max()))
                if name != "dense":
                    out[name].update(
                        k_equal_fp32_dense=float((k == k32["dense"]).mean()),
                        max_move_fp32_dense=int(
                            np.abs(k - k32["dense"]).max()))
            out["seconds"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
