"""Single-split ADMM engine.

The shared iteration skeleton of the reference's laxMPC/equMPC/ellipMPC/
MPCT-cs ADMM solvers (canonical version: code_laxMPC_ADMM_C.c:308-633):

    q_hat = q_ref + lambda - rho .* v          (dual-adjusted linear cost)
    z     = argmin_z 0.5 z'Hhat z + q_hat'z  s.t. G z = beq   (z_step)
    v     = proj(z + rho^{-1} .* lambda)                       (projection)
    lambda += rho .* (z - v)
    converged per-lane iff  ||z - v||_inf <= tol  (primal feasibility)
                        and ||v - v_prev||_inf <= tol  (fixed point)

The engine is generic over `z_step` (the equality-QP solve) and `proj`,
which is exactly the axis along which the reference formulations differ.

Delta-form iteration (the fp32 enabler, on whenever `z_lin` is given): the
z-step is affine in q_hat, so after one full solve the update can be
computed incrementally:

    dq_k  = rho.*(z_{k-1} - v_{k-1}) - rho.*(v_{k-1} - v_{k-2})
    z_k   = z_{k-1} + M_q dq_k

dq -> 0 as the iteration converges, so the linear-solve rounding error
scales DOWN with the residual instead of staying at eps*|q_hat| — without
this, fp32 stalls near ~1e-3 and can never meet the reference's 1e-4
tolerance. Algebraically identical to the direct form.

Port of spcies_tpu/solvers/admm.py; the loop is solvers/loop.py.
"""

from __future__ import annotations

from typing import Callable

import torch

from spcies_tpu_torch.solvers.common import inf_norm
from spcies_tpu_torch.solvers.loop import _SYNC_EVERY, run_masked_loop


def admm_solve(
    z_step: Callable,          # z_step(q_hat[B, nz]) -> z[B, nz] (affine, incl. beq term)
    proj: Callable,            # proj(y[B, nz]) -> v[B, nz]
    q_ref,                     # [B, nz] or [nz]
    rho,                       # scalar or [nz]
    rho_i,                     # scalar or [nz] (elementwise 1/rho)
    tol_p: float,
    tol_d: float,
    k_max: int,
    batch: int,
    nz: int,
    dtype,
    init=None,                 # optional (z0, v0, lam0) warm start
    fixed_iters: int | None = None,
    z_lin: Callable | None = None,  # linear part only: z_lin(dq) = M_q dq
    history: int = 0,          # genHist level: 1 = residual norms per
                               # iteration, 2 = + full z/v/lam traces
    relax_alpha: float = 1.0,  # over-relaxation (1 = plain ADMM)
    freeze_converged: bool = True,  # False = free-running throughput mode
    straggler_polish: int = 0,  # extra compensated-f32x2 iterations for
                               # lanes that exhaust k_max; 0 = off. k then
                               # counts TOTAL iterations and may exceed
                               # k_max for polished lanes.
    device=None,
):
    """Run batched single-split ADMM; returns
    (z, v, lam, k, e_flag, r_p, r_d, hist).

    If `z_lin` is given the engine uses the delta-form iteration after the
    first (full) z-step; otherwise every iteration does the direct solve.
    relax_alpha != 1 applies over-relaxation: the z-iterate used in the
    v/dual updates is alpha*z + (1-alpha)*v_prev.
    """
    alpha = float(relax_alpha)
    if int(history) >= 2 and not freeze_converged:
        raise ValueError(
            "genHist level 2 (full iterate traces) requires "
            "freeze_converged=True — free-running lanes keep iterating "
            "past their recorded exit, so the traces would not match the "
            "returned per-lane solutions")
    if init is None:
        zeros = torch.zeros((batch, nz), dtype=dtype, device=device)
        z0, v0, lam0 = zeros, zeros, zeros
    else:
        z0, v0, lam0 = init

    rinf = torch.full((batch,), float("inf"), dtype=dtype, device=device)

    if z_lin is not None:
        # Delta form: peel the single full equality-QP solve out of the
        # loop; the body consumes the z prepared by the previous iteration
        # and prepares the next one incrementally. In free-running mode
        # the consumed-z leaf is dropped (the returned z is then the
        # prepared iterate, one solve fresher).
        z1 = z_step(q_ref + lam0 - rho * v0)
        state0 = dict(z_next=z1, v=v0, lam=lam0, r_p=rinf, r_d=rinf)
        if freeze_converged:
            state0["z"] = z1

        def body(state, _it):
            z = state["z_next"]
            v_prev = state["v"]
            zr = z if alpha == 1.0 else alpha * z + (1.0 - alpha) * v_prev
            v = proj(zr + rho_i * state["lam"])
            lam = state["lam"] + rho * (zr - v)
            r_p = inf_norm(z - v)
            r_d = inf_norm(v - v_prev)
            conv = torch.logical_and(r_p <= tol_p, r_d <= tol_d)
            # prepare z for the NEXT iteration:
            # dq = (lam_k - lam_{k-1}) - rho (v_k - v_{k-1})
            dq = rho * (zr - v) - rho * (v - v_prev)
            z_next = z + z_lin(dq)
            out = dict(z_next=z_next, v=v, lam=lam, r_p=r_p, r_d=r_d)
            if freeze_converged:
                out["z"] = z
            return out, conv
    else:
        state0 = dict(z=z0, v=v0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            v_prev = state["v"]
            q_hat = q_ref + state["lam"] - rho * v_prev
            z = z_step(q_hat)
            zr = z if alpha == 1.0 else alpha * z + (1.0 - alpha) * v_prev
            v = proj(zr + rho_i * state["lam"])
            lam = state["lam"] + rho * (zr - v)
            r_p = inf_norm(z - v)
            r_d = inf_norm(v - v_prev)
            conv = torch.logical_and(r_p <= tol_p, r_d <= tol_d)
            return dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d), conv

    if history:
        keys = ("r_p", "r_d")
        if int(history) >= 2:
            keys += (("z", "v", "lam") if "z" in state0
                     else ("z_next", "v", "lam"))
        state, k, e_flag, hist = run_masked_loop(
            body, state0, k_max, batch, fixed_iters=fixed_iters,
            history_keys=keys, freeze=freeze_converged)
    else:
        state, k, e_flag = run_masked_loop(body, state0, k_max, batch,
                                           fixed_iters=fixed_iters,
                                           freeze=freeze_converged)
        hist = None
    z_out = state["z"] if "z" in state else state["z_next"]
    out = (z_out, state["v"], state["lam"], k, e_flag, state["r_p"],
           state["r_d"])

    if (straggler_polish and z_lin is not None and fixed_iters is None
            and bool((e_flag != 1).any())):
        # fp32 convergence-floor fix: a small fraction of hard states
        # reach an fp32 fixed point where accumulated quantization noise
        # in the (z, lam) accumulators floors max|z - v| just above tol.
        # Lanes that exhaust k_max get a compensated continuation: z and
        # lam are carried as double-word pairs (hi + lo), increments
        # accumulate through Knuth TwoSum, and the lo parts feed the
        # projection argument and the primal residual. Runs only when
        # some lane failed (one host-side test); converged lanes stay
        # frozen. The continuation consumes the PREPARED next iterate
        # z_next — the delta-form recursion has already folded dq_k into
        # it, and seeding from the consumed z would carry a permanent
        # -M_q dq offset. Frozen lanes keep their consumed-z output.
        z_seed = torch.where((e_flag == 1)[:, None], out[0],
                             state["z_next"])
        out = _polish(z_seed, *out[1:], proj=proj, z_lin=z_lin, rho=rho,
                      rho_i=rho_i, alpha=alpha, tol_p=tol_p, tol_d=tol_d,
                      budget=int(straggler_polish))
    return out + (hist,)


def _two_sum(a, b):
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _polish(z0, v0, lam0, k, e_flag, rp0, rd0, *, proj, z_lin, rho, rho_i,
            alpha, tol_p, tol_d, budget):
    """Compensated (double-word) continuation of the delta-form ADMM for
    the lanes with e_flag != 1, up to `budget` more iterations."""
    done = e_flag == 1
    lo0 = torch.zeros_like(z0)
    st = dict(z=z0, z_lo=lo0, v=v0, lam=lam0, lam_lo=lo0, r_p=rp0, r_d=rd0)
    for it in range(budget):
        # frozen lanes make an extra iteration an exact no-op
        if it % _SYNC_EVERY == 0 and bool(done.all()):
            break
        z, z_lo, v_prev = st["z"], st["z_lo"], st["v"]
        lam, lam_lo = st["lam"], st["lam_lo"]
        zr = z if alpha == 1.0 else alpha * z + (1.0 - alpha) * v_prev
        zr_lo = z_lo if alpha == 1.0 else alpha * z_lo
        v = proj(zr + rho_i * lam + (zr_lo + rho_i * lam_lo))
        dlt = rho * (zr - v)
        lam_n, e1 = _two_sum(lam, dlt)
        lam_lo_n = lam_lo + (e1 + rho * zr_lo)
        # same residual convention as the main loop: primal residual on
        # the consumed (un-relaxed) z, here with its low word restored
        r_p = inf_norm(z + z_lo - v)
        r_d = inf_norm(v - v_prev)
        conv = torch.logical_and(r_p <= tol_p, r_d <= tol_d)
        dq = rho * (zr - v) - rho * (v - v_prev)
        z_n, e2 = _two_sum(z, z_lin(dq + rho * zr_lo))
        new = dict(z=z_n, z_lo=z_lo + e2, v=v, lam=lam_n, lam_lo=lam_lo_n,
                   r_p=r_p, r_d=r_d)
        active = torch.logical_not(done)
        st = {key: torch.where(active.reshape((-1,) + (1,) * (nw.ndim - 1)),
                               nw, st[key])
              for key, nw in new.items()}
        k = torch.where(active, k + 1, k)
        done = torch.logical_or(done, torch.logical_and(active, conv))
    e = torch.where(done, 1, -1).to(torch.int32)
    return (st["z"] + st["z_lo"], st["v"], st["lam"] + st["lam_lo"], k, e,
            st["r_p"], st["r_d"])
