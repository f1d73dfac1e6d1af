"""Shared solver result container and termination helpers."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class SolveResult:
    """Batched solve output, the analogue of the reference's
    (u_opt, k, e_flag, sol) C interface (header_laxMPC_ADMM_C.h:14-28).

    All tensors carry a leading batch dim B and live on the solver's device.
      u:      [B, m]  first control move (the reference's u_opt = v_0)
      k:      [B]     iterations performed per lane (int32)
      e_flag: [B]     1 = converged, -1 = k_max reached (int32)
      sol:    dict of final iterates / residuals (the DEBUG `sol` struct).
    """

    u: torch.Tensor
    k: torch.Tensor
    e_flag: torch.Tensor
    sol: dict[str, Any]


def inf_norm(x, dim=-1):
    """Per-lane infinity norm, the reference's residual metric
    (code_laxMPC_ADMM_C.c:570-620 early-break scan is equivalent)."""
    return torch.amax(torch.abs(x), dim=dim)


def hist_sol_entries(hist):
    """Map recorded history traces to the reference's genHist-style sol
    field names (hRp/hRd at level 1; + hZ/hV/hLam at level 2)."""
    if not hist:
        return {}
    names = {"r_p": "hRp", "r_d": "hRd", "res": "hRes",
             "z": "hZ", "z_next": "hZ", "v": "hV", "lam": "hLam",
             "s": "hS", "mu": "hMu",
             "z1": "hZ1", "z2": "hZ2", "z3": "hZ3"}
    return {names.get(k, "h" + k): v for k, v in hist.items()}


def delta_dot(x, M):
    """x @ M for delta-form products, whose operands shrink to zero with
    the residual. On the GPU this runs at full fp32: BatchedSolver.__call__
    turns TF32 off for the whole solve, which is what the JAX package's
    DEFAULT-precision product computes on the CPU."""
    return x @ M


def delta_dot_op(op, x):
    """Apply a linear operator to a shrinking delta: the operator-callback
    form of delta_dot, a plain call for the same reason (the precision is
    BatchedSolver.__call__'s)."""
    return op(x)
