#!/usr/bin/env python3
"""A/B of build variants of the port's kernels K4-K7 on one CUDA card, in
one process.

Each variant is the committed source (spcies_tpu_torch/csrc/) with one
text substitution: the product's unroll depth, or the blocks an SM the
kernel is compiled for. The script builds every variant into the
git-ignored spcies_tpu_torch/_build/ab/, prints ptxas's registers and
spills, holds each variant against the plain PyTorch version at the
kernel's chip_smoke.py families (B=8192), and times the variants in turns
(forward, then backward) at B=8192 and 32768 with CUDA events. Run from
the repository root on a machine with a card, for all four kernels or the
ones named:

    python3 tools/ab_kernels.py [fused_ellip fused_soc fused_hmpc fused_split]
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
from spcies_tpu_torch.kernels import fused_hmpc as k6  # noqa: E402
from spcies_tpu_torch.kernels import fused_soc as k5  # noqa: E402
from spcies_tpu_torch.kernels import fused_split as k7  # noqa: E402

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
    "fused_hmpc": {
        "committed (unroll 8, 3 blocks an SM)": None,
        "unroll 16": ("UNROLL = 8; ", "UNROLL = 16;"),
        "2 blocks an SM": ("fused_hmpc_kernel<NARROW, 3>",
                           "fused_hmpc_kernel<NARROW, 2>"),
        "128 registers, 1 block an SM": ("width <= NARROW ?", "false ?"),
    },
    "fused_split": {
        "committed (unroll 8, 3 blocks an SM)": None,
        "unroll 16": ("UNROLL = 8; ", "UNROLL = 16;"),
        "2 blocks an SM": ("fused_split_kernel<NARROW, 3>",
                           "fused_split_kernel<NARROW, 2>"),
        "128 registers, 1 block an SM": ("P <= NARROW ?", "false ?"),
    },
}


def _ellip(kern, plain, u_at, *families):
    return dict(families=families, kern=kern, plain=plain, u_at=u_at,
                solver=c.ellip_solver, inputs=c.ellip_inputs,
                args=c.ellip_kernel_args)


def _hmpc(kern, plain, *families):
    return dict(families=families, kern=kern, plain=plain, u_at=0,
                solver=c.hmpc_solver, inputs=c.hmpc_inputs,
                args=c.hmpc_kernel_args)


# kernel -> its families, wrapper, plain version, u's column in the
# kernel's first output, and chip_smoke.py's solver, input and argument
# builders for them
KERNELS = {
    "fused_ellip": _ellip(k4.fused_ellip_solve, k4.fused_ellip_reference, 1,
                          "ellipMPC-ADMM"),
    "fused_soc": _ellip(k5.fused_soc_solve, k5.fused_soc_reference, 0,
                        "ellipMPC-ADMM-soc"),
    "fused_hmpc": _hmpc(k6.fused_hmpc_solve, k6.fused_hmpc_reference,
                        "HMPC-ADMM", "ellipHMPC-ADMM"),
    "fused_split": _hmpc(k7.fused_split_solve, k7.fused_split_reference,
                         "HMPC-ADMM-split", "HMPC-SADMM-split"),
}
ARGTYPES = {"fused_ellip": k4.FUSED_ELLIP_ARGTYPES,
            "fused_soc": k5.FUSED_SOC_ARGTYPES,
            "fused_hmpc": k6.FUSED_HMPC_ARGTYPES,
            "fused_split": k7.FUSED_SPLIT_ARGTYPES}


def variant_dir(kernel: str, name: str, change) -> Path:
    """A directory holding a variant's source, written from the committed
    one: `change` is None (the committed source itself) or an (old, new)
    text substitution."""
    if change is None:
        return REPO / "spcies_tpu_torch" / "csrc"
    src = (REPO / "spcies_tpu_torch" / "csrc" / f"{kernel}.cu").read_text()
    old, new = change
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


def ab(kernel: str, result: dict):
    """Build, check and time every variant of one kernel."""
    spec = KERNELS[kernel]
    kern, plain = spec["kern"], spec["plain"]
    dirs = {name: variant_dir(kernel, name, change)
            for name, change in VARIANTS[kernel].items()}
    for name, d in dirs.items():
        for line in use(kernel, d)["log"].splitlines():
            if "registers" in line or "spill" in line:
                c.log(f"{kernel} [{name}] ptxas: {line.strip()}")
    for fam in spec["families"]:
        for B in (c.FB, c.BATCH):
            solver = spec["solver"](sp, fam, device="cuda")
            args, kk = spec["args"](solver, spec["inputs"](sp, fam, 0, B))
            if B == c.FB:
                ref = plain(*args, **kk)
                for name, d in dirs.items():
                    use(kernel, d)
                    out = kern(*args, **kk)
                    torch.cuda.synchronize()
                    a = c.agreement(out, ref, B, solver.m, False,
                                    u_at=spec["u_at"])
                    c.log(f"{kernel} [{name}] {fam} vs plain B={B}: "
                          + json.dumps(a))
                    assert a["k_agree"] >= c.K_AGREE and a["u_err"] <= c.U_TOL
            t = {name: [] for name in dirs}
            for name in list(dirs) + list(dirs)[::-1]:
                use(kernel, dirs[name])
                t[name].append(c.cuda_ms(lambda: kern(*args, **kk), reps=3))
            c.log(f"{kernel} {fam} B={B} ms (CUDA events, in turns): "
                  + json.dumps(t))
            result[f"{kernel} {fam} B={B}"] = {k: min(v)
                                               for k, v in t.items()}


def main(kernels):
    c.require_cuda()
    torch.set_float32_matmul_precision("highest")
    c.log(c.card_line())
    result = {}
    for kernel in kernels or KERNELS:
        ab(kernel, result)
    c.log(json.dumps(result))


if __name__ == "__main__":
    main(sys.argv[1:])
