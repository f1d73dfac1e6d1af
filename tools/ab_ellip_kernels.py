#!/usr/bin/env python3
"""A/B of build variants of the port's ellipMPC kernels K4 and K5 on one
CUDA card, in one process.

Each variant is the committed source (spcies_tpu_torch/csrc/) with one
text substitution: the product's unroll depth, or the blocks an SM the
kernel is compiled for. The script builds every variant into the
git-ignored spcies_tpu_torch/_build/ab/, prints ptxas's registers and
spills, holds each variant against the plain PyTorch version at the
chip_smoke.py ellipMPC families (B=8192), and times the variants in turns
(forward, then backward) at B=8192 and 32768 with CUDA events. Run from
the repository root on a machine with a card:

    python3 tools/ab_ellip_kernels.py
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as c  # noqa: E402
import spcies_tpu_torch as sp  # noqa: E402
from spcies_tpu_torch.kernels import _build  # noqa: E402
from spcies_tpu_torch.kernels import fused_ellip as k4  # noqa: E402
from spcies_tpu_torch.kernels import fused_soc as k5  # noqa: E402

# kernel -> variant name -> (text in the committed source, replacement);
# None is the committed source itself
VARIANTS = {
    "fused_ellip": {
        "committed (unroll 16, 3 blocks an SM)": None,
        "unroll 8": ("UNROLL = 16;", "UNROLL = 8; "),
        "unroll 4": ("UNROLL = 16;", "UNROLL = 4;  "),
        "128 registers, 2 blocks an SM": ("nzp <= NARROW ?", "false ?"),
    },
    "fused_soc": {
        "committed (unroll 8, 2 blocks an SM)": None,
        "unroll 16": ("UNROLL = 8; ", "UNROLL = 16;"),
        "128 registers, 1 block an SM": ("P <= NARROW ?", "false ?"),
    },
}
FAMILY = {"fused_ellip": ("ellipMPC-ADMM", k4.fused_ellip_solve,
                          k4.fused_ellip_reference, 1),
          "fused_soc": ("ellipMPC-ADMM-soc", k5.fused_soc_solve,
                        k5.fused_soc_reference, 0)}
ARGTYPES = {"fused_ellip": k4.FUSED_ELLIP_ARGTYPES,
            "fused_soc": k5.FUSED_SOC_ARGTYPES}


def variant_dir(kernel: str, name: str) -> Path:
    """A directory holding the variant's source, written from the
    committed one."""
    if VARIANTS[kernel][name] is None:
        return REPO / "spcies_tpu_torch" / "csrc"
    old, new = VARIANTS[kernel][name]
    src = (REPO / "spcies_tpu_torch" / "csrc" / f"{kernel}.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{kernel} {name}: {old!r} not found once")
    d = _build.BUILD_DIR / "ab" / f"{kernel}-{re.sub(r'\W+', '_', name)}"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{kernel}.cu").write_text(src.replace(old, new))
    return d


def use(kernel: str, directory: Path):
    """Make the wrapper launch the library built from `directory`."""
    _build.CSRC = directory
    _build._LOADED.pop(kernel, None)
    _build.load_kernel(kernel, f"{kernel}_launch", ARGTYPES[kernel])
    return _build.build_record(kernel)


def main():
    c.require_cuda()
    torch.set_float32_matmul_precision("highest")
    c.log(c.card_line())
    result = {}
    for kernel, variants in VARIANTS.items():
        fam, kern, plain, u_at = FAMILY[kernel]
        dirs = {name: variant_dir(kernel, name) for name in variants}
        for name, d in dirs.items():
            rec = use(kernel, d)
            for line in rec["log"].splitlines():
                if "registers" in line or "spill" in line:
                    c.log(f"{kernel} [{name}] ptxas: {line.strip()}")
        for B in (c.FB, c.BATCH):
            solver = c.ellip_solver(sp, fam, device="cuda")
            args, kk = c.ellip_kernel_args(solver,
                                           c.ellip_inputs(sp, fam, 0, B))
            if B == c.FB:
                ref = plain(*args, **kk)
                for name, d in dirs.items():
                    use(kernel, d)
                    out = kern(*args, **kk)
                    torch.cuda.synchronize()
                    a = c.agreement(out, ref, B, solver.m, False, u_at=u_at)
                    c.log(f"{kernel} [{name}] vs plain B={B}: "
                          + json.dumps(a))
                    assert a["k_agree"] >= c.K_AGREE and a["u_err"] <= c.U_TOL
            t = {name: [] for name in dirs}
            for name in list(dirs) + list(dirs)[::-1]:
                use(kernel, dirs[name])
                t[name].append(c.cuda_ms(lambda: kern(*args, **kk), reps=3))
            c.log(f"{kernel} B={B} ms (CUDA events, in turns): "
                  + json.dumps(t))
            result[f"{kernel} B={B}"] = {k: min(v) for k, v in t.items()}
    c.log(json.dumps(result))


if __name__ == "__main__":
    main()
