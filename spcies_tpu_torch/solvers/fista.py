"""Batched dual-FISTA iteration engine.

Mirrors the reference's FISTA solvers (code_laxMPC_FISTA_C.c:300-390,
platforms/Matlab/spcies_laxMPC_FISTA_solver.m): accelerated gradient ascent
on the dual of the equality constraints, where the primal minimizer given
duals is a box-clipped diagonal solve and the dual gradient step solves
W d = r with W = G H^{-1} G^T.

  warm start (k=0, outside the loop — one plain gradient step,
  code_laxMPC_FISTA_C.c:300-318):
      q = q_ref - G^T lam; z = clip(-Hinv q); r = b - G z;
      y = lam + W^{-1} r; lam = y; q = q_ref - G^T y
  loop (k >= 1):
      z = clip(-Hinv q); r -= G (z - z_prev); res = ||r||_inf
      exit if res <= tol (e_flag 1) or k >= k_max (e_flag -1)
      else: lam' = y + W^{-1} r; t' = (1+sqrt(1+4t^2))/2;
            y' = lam' + ((t-1)/t') (lam' - lam); q -= G^T (y' - y)
  The momentum updates are masked off on the converging iteration (the
  reference's `if done == 0` guard), so the returned (z, lambda=y, res)
  match the reference in exact arithmetic.

Delta form: q = q_ref - G^T y and r = b - G z are kept incrementally, so
every product inside the loop has operands that shrink with the residual;
the fused kernel (kernels/fused_fista.py) runs the same recursion. Port of
spcies_tpu/solvers/fista.py; the loop is solvers/loop.py.
"""

from __future__ import annotations

from typing import Callable

import torch

from spcies_tpu_torch.solvers.common import delta_dot_op, inf_norm
from spcies_tpu_torch.solvers.loop import run_masked_loop


def fista_solve(
    z_from_q: Callable,        # q [B, nz] -> z = clip(-Hinv q) [B, nz]
    gt_op: Callable,           # y [B, nlam] -> G^T y rows [B, nz] (linear)
    g_op: Callable,            # z [B, nz] -> G z [B, nlam] (linear)
    w_solve: Callable,         # r [B, nlam] -> W^{-1} r
    q_ref,                     # [B, nz] linear cost
    b,                         # [B, nlam] equality RHS
    *,
    tol: float,
    k_max: int,
    batch: int,
    nlam: int,
    dtype,
    lam_init=None,
    fixed_iters: int | None = None,
    history: bool = False,
    restart: bool = False,     # adaptive restart (O'Donoghue & Candes):
                               # reset the momentum (t = 1) on lanes whose
                               # dual residual increased. Opt-in — the
                               # reference has no restart.
    device=None,
):
    """Run batched dual FISTA; returns (z, y, lam, k, e_flag, res, hist)."""
    lam = (torch.zeros((batch, nlam), dtype=dtype, device=device)
           if lam_init is None
           else torch.as_tensor(lam_init, dtype=dtype, device=device))

    # k = 0 warm-start gradient step (outside the loop, no exit check)
    q0 = q_ref - gt_op(lam)
    z0 = z_from_q(q0)
    r0 = b - g_op(z0)
    y = lam + w_solve(r0)
    lam = y
    q1 = q_ref - gt_op(y)

    state0 = dict(
        q=q1, z=z0, r=r0, y=y, lam=lam,
        t=torch.ones((batch,), dtype=dtype, device=device),
        res=torch.full((batch,), float("inf"), dtype=dtype, device=device),
    )

    def body(state, _it):
        z = z_from_q(state["q"])
        r = state["r"] - delta_dot_op(g_op, z - state["z"])
        res = inf_norm(r)
        conv = res <= tol
        # momentum block, masked off on the converging iteration
        lam_new = state["y"] + w_solve(r)
        t_cur = state["t"]
        if restart:
            # residual-increase restart: drop the momentum back to a plain
            # gradient step on lanes that overshot
            t_cur = torch.where(res > state["res"], torch.ones_like(t_cur),
                                t_cur)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t_cur ** 2))
        coef = ((t_cur - 1.0) / t_new)[:, None]
        y_new = lam_new + coef * (lam_new - state["lam"])
        keep = conv[:, None]
        lam_out = torch.where(keep, state["lam"], lam_new)
        y_out = torch.where(keep, state["y"], y_new)
        t_out = torch.where(conv, state["t"], t_new)
        q_out = state["q"] - delta_dot_op(gt_op, y_out - state["y"])
        return (dict(q=q_out, z=z, r=r, y=y_out, lam=lam_out, t=t_out,
                     res=res), conv)

    if history:
        state, k, e_flag, hist = run_masked_loop(
            body, state0, k_max, batch, fixed_iters=fixed_iters,
            history_keys=("res",))
    else:
        state, k, e_flag = run_masked_loop(body, state0, k_max, batch,
                                           fixed_iters=fixed_iters)
        hist = None
    return (state["z"], state["y"], state["lam"], k, e_flag, state["res"],
            hist)
