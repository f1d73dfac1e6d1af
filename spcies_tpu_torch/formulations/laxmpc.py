"""laxMPC formulation — MPC with a terminal cost (no terminal constraint).

    min  sum_{i=0}^{N-1} (||x_i - xr||_Q^2 + ||u_i - ur||_R^2) + ||x_N - xr||_T^2
    s.t. x_{i+1} = A x_i + B u_i,  LB <= (x_i, u_i) <= UB

Decision vector z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, x_N), dim N(n+m).
Reference: formulations/+laxMPC/compute_laxMPC_ADMM_ingredients.m (offline
math), code_laxMPC_ADMM_C.c:308-633 (ADMM loop), TCST 2020 eq. (9).

Port of the ADMM part of spcies_tpu/formulations/laxmpc.py, with two
z-step backends:
  'dense' — the whole equality-QP solve collapsed offline into one affine
            map z = M_q q_hat + M_b b0 (one [B,nz]x[nz,nz] product per
            iteration), run by the masked loop of solvers/admm.py.
  'fused' — the whole ADMM loop in one hand-written GPU kernel per call
            (kernels/fused_admm.py through solvers/fused_backend.py).
"""

from __future__ import annotations

import numpy as np
import torch

from spcies_tpu_torch.config import Options
from spcies_tpu_torch.formulations.base import (register_builder,
                                                get_sys_matrices, get_bounds)
from spcies_tpu_torch.utils import linalg
from spcies_tpu_torch.utils.projections import proj_box
from spcies_tpu_torch.solvers.admm import admm_solve
from spcies_tpu_torch.solvers.common import (SolveResult, hist_sol_entries,
                                             delta_dot)
from spcies_tpu_torch.api import BatchedSolver

_DTYPES = {"double": torch.float64, "float": torch.float32}


def laxmpc_admm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredient computation, the analogue of
    compute_laxMPC_ADMM_ingredients.m:22-187 (all fp64 numpy)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("laxMPC/ADMM requires diagonal Q and R "
                         "(compute_laxMPC_ADMM_ingredients.m:50-52)")
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()
    nz = N * (n + m)

    # rho layout (scalar or vector; compute_laxMPC_ADMM_ingredients.m:55-64)
    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nz, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")

    # Hessian Hhat = blkdiag(R, I_{N-1} (x) blkdiag(Q, R), T) + diag(rho)
    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T)
    Hhat = H + np.diag(rho_vec)

    # Banded equality matrix and W = G Hhat^{-1} G^T
    G = linalg.mpc_equality_matrix(A, B, N)
    Hinv = np.linalg.inv(Hhat)
    W = G @ Hinv @ G.T
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    # Dense affine z-update maps: z = M_q q_hat + M_b b0 with
    # z = -Hinv(q_hat + G' mu), W mu = -G Hinv q_hat - beq, beq = [b0; 0].
    GH = G @ Hinv                      # [N n, nz]
    K = np.linalg.solve(W, GH)         # W^{-1} G Hinv
    M_q = GH.T @ K - Hinv              # [nz, nz]
    M_b = GH.T @ np.linalg.inv(W)[:, :n]   # [nz, n]

    # Stage bounds stacked over the decision vector
    # (LB = [LBx; LBu], v_0 clipped by LBu, v_N by LBx:
    #  code_laxMPC_ADMM_C.c:487-537)
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    LB_z = np.concatenate([LBu] + [np.concatenate([LBx, LBu])] * (N - 1) + [LBx])
    UB_z = np.concatenate([UBu] + [np.concatenate([UBx, UBu])] * (N - 1) + [UBx])

    # Structured pieces for the banded backend (reference vars.Hi* layout,
    # compute_laxMPC_ADMM_ingredients.m:140-147)
    Hi_0 = np.diag(Hinv)[:m].copy()
    Hi_mid = np.diag(Hinv)[m:m + (N - 1) * (n + m)].reshape(N - 1, n + m)
    Hi_N = Hinv[-n:, -n:].copy()

    return dict(
        n=n, m=m, N=N, nz=nz, rho_is_scalar=rho_is_scalar,
        A=A, B=B, AB=np.hstack([A, B]), Qd=Qd, Rd=Rd, T=T,
        rho_vec=rho_vec, rho_inv_vec=1.0 / rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        M_q=M_q, M_b=M_b, LB_z=LB_z, UB_z=UB_z,
        Alpha=Alpha, Beta=Beta,
        Hi_0=Hi_0, Hi_mid=Hi_mid, Hi_N=Hi_N,
        scaling_x=np.asarray(sys.get("Nx", np.ones(n)), float).ravel(),
        scaling_u=np.asarray(sys.get("Nu", np.ones(m)), float).ravel(),
        op_x=np.asarray(sys.get("x0", np.zeros(n)), float).ravel(),
        op_u=np.asarray(sys.get("u0", np.zeros(m)), float).ravel(),
    )


def _q_ref(ing, xr, ur, dtype):
    """Per-call linear cost q_ref = (-R ur, [-Q xr, -R ur] x (N-1), -T xr),
    the reference's baked-negated q update (code_laxMPC_ADMM_C.c:288-298
    with vars.Q = -diag(Q) etc.)."""
    dev = xr.device
    Qd = torch.as_tensor(ing["Qd"], dtype=dtype, device=dev)
    Rd = torch.as_tensor(ing["Rd"], dtype=dtype, device=dev)
    T = torch.as_tensor(ing["T"], dtype=dtype, device=dev)
    qx = -xr * Qd
    qu = -ur * Rd
    qT = -(xr @ T.T)
    mid = torch.cat([qx, qu], dim=-1)
    mid_tiled = mid.repeat(1, ing["N"] - 1)
    return torch.cat([qu, mid_tiled, qT], dim=-1)


def _tag_stagewise(solver, terminal: bool):
    """Mark the solver's decision layout as the laxMPC/equMPC stagewise
    one (u_0 | x_1 u_1 | ... [| x_N]), as the JAX package does for its
    receding-horizon warm-start shift."""
    solver.stage_layout = ("stagewise", terminal)
    return solver


@register_builder("laxMPC", "ADMM")
def build_laxmpc_admm(sys: dict, param: dict, opt: Options,
                      backend: str = "dense", device=None,
                      ingredients: dict | None = None) -> BatchedSolver:
    """Build the laxMPC-ADMM solver on `device`. `ingredients` replaces
    the offline computation (same keys as laxmpc_admm_ingredients)."""
    if opt.time_varying:
        raise NotImplementedError(
            "time-varying laxMPC is not ported to spcies_tpu_torch yet "
            "(ROADMAP queue 1 item 8)")
    if backend == "banded":
        raise NotImplementedError(
            "backend='banded' is not ported to spcies_tpu_torch yet "
            "(ROADMAP queue 1 item 8)")
    if backend not in ("dense", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device if device is not None else "cpu")
    ing = (ingredients if ingredients is not None
           else laxmpc_admm_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    if backend == "fused":
        return _tag_stagewise(
            _build_laxmpc_admm_fused(ing, opt, dtype, device), True)

    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rho = (dev(ing["rho_scalar"]) if ing["rho_is_scalar"]
           else dev(ing["rho_vec"]))
    rho_i = (dev(1.0 / ing["rho_scalar"]) if ing["rho_is_scalar"]
             else dev(ing["rho_inv_vec"]))
    LB_z, UB_z = dev(ing["LB_z"]), dev(ing["UB_z"])
    A, M_q, M_b = dev(ing["A"]), dev(ing["M_q"]), dev(ing["M_b"])
    # bf16 delta path (fp32 only): dq -> 0, so the error of a product of
    # bf16-rounded operands shrinks with the residual. The products of
    # bf16 values are exact in fp32 and summed in fp32, as JAX's
    # preferred_element_type=float32 product computes them.
    bf16_delta = (bool(opt.solver.get("bf16_delta", False))
                  and dtype == torch.float32)
    if bf16_delta:
        M_q_bfT = M_q.to(torch.bfloat16).float().T

        def z_lin(dq):
            return dq.to(torch.bfloat16).float() @ M_q_bfT
    else:
        def z_lin(dq):
            return delta_dot(dq, M_q.T)

    def proj(y):
        return proj_box(y, LB_z, UB_z)

    def _solve(x0, xr, ur, init, fixed_iters):
        b0 = -(x0 @ A.T)

        def z_step(q_hat):
            return q_hat @ M_q.T + b0 @ M_b.T

        q_ref = _q_ref(ing, xr, ur, dtype)
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            z_step, proj, q_ref, rho, rho_i, tol, tol, k_max,
            batch=x0.shape[0], nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=z_lin, history=opt.debug, device=device)
        return SolveResult(u=v[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return _tag_stagewise(
        BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype,
                      device=device),
        True)


def _build_laxmpc_admm_fused(ing, opt, dtype, device):
    """'fused' backend: the whole ADMM loop as one GPU kernel launch per
    solve (kernels/fused_admm.py) via the shared dense box-ADMM adapter
    (solvers/fused_backend.py). fp32 only; supports warm starts and the
    fixed_iters benchmark mode."""
    from spcies_tpu_torch.solvers.fused_backend import (
        build_fused_box_admm_solve)

    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    M_b = torch.as_tensor(ing["M_b"], dtype=torch.float32, device=device)
    A = torch.as_tensor(ing["A"], dtype=torch.float32, device=device)
    _solve = build_fused_box_admm_solve(
        ing, opt, dtype, device,
        make_q_ref=lambda x0, xr, ur: _q_ref(ing, xr, ur, torch.float32),
        make_aux_b=lambda x0, xr, ur: (-(x0 @ A.T)) @ M_b.T,
        u_start=0)
    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz,
                         dtype=dtype, device=device)
