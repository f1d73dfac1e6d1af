"""equMPC formulation — MPC with a terminal equality constraint x_N = x_r.

    min  sum_{i=0}^{N-1} (||x_i - xr||_Q^2 + ||u_i - ur||_R^2)
    s.t. x_{i+1} = A x_i + B u_i,  x_N = x_r,  LB <= (x_i, u_i) <= UB

Same skeleton as laxMPC with the terminal state eliminated: decision vector
z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}), dim N(n+m) - n; no terminal
cost; the equality RHS carries x_r in its last block. Reference:
formulations/+equMPC/compute_equMPC_ADMM_ingredients.m (offline math),
code_equMPC_ADMM_C.c (ADMM loop; terminal equality enters at :351),
code_equMPC_FISTA_C.c, platforms/Matlab/spcies_equMPC_{ADMM,FISTA}_solver.m.

Port of spcies_tpu/formulations/equmpc.py with the 'dense', 'banded'
and 'fused' backends: ADMM fused runs the box-ADMM kernel
(kernels/fused_admm.py), FISTA fused the dual-FISTA kernel
(kernels/fused_fista.py), banded the stagewise operators and band-Cholesky
solves (formulations/stagewise.py); and laxMPC's time-varying mode with no
terminal block (opt.time_varying, whatever the backend).
"""

from __future__ import annotations

import numpy as np
import torch

from spcies_tpu_torch.api import BatchedSolver, resolve_device
from spcies_tpu_torch.config import Options
from spcies_tpu_torch.formulations.base import (get_sys_matrices,
                                                register_builder)
from spcies_tpu_torch.formulations.laxmpc import (_DTYPES, _tag_stagewise,
                                                  _tv_admm_solver,
                                                  _tv_fista_solver,
                                                  build_fista,
                                                  stacked_bounds)
from spcies_tpu_torch.solvers.admm import admm_solve
from spcies_tpu_torch.solvers.common import (SolveResult, delta_dot,
                                             hist_sol_entries)
from spcies_tpu_torch.utils import linalg
from spcies_tpu_torch.utils.projections import proj_box


def _diag_qr(param, what):
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError(f"equMPC/{what} requires diagonal Q and R "
                         f"(compute_equMPC_{what}_ingredients.m)")
    return np.diag(Q).copy(), np.diag(R).copy()


def equmpc_admm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients, analogue of
    compute_equMPC_ADMM_ingredients.m (decision dim N(n+m)-n :54, truncated
    Aeq :85, no T in H)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Qd, Rd = _diag_qr(param, "ADMM")
    nz = N * (n + m) - n

    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nz, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1))
    hinv_diag = 1.0 / (h_diag + rho_vec)

    G = linalg.mpc_equality_matrix(A, B, N, drop_terminal=True)
    W = G @ (hinv_diag[:, None] * G.T)
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    # dense affine maps: z = M_q q_hat + M_b beq (beq = [-A x0; 0; ...; xr])
    GH = G * hinv_diag[None, :]
    Winv = np.linalg.inv(W)
    M_q = GH.T @ (Winv @ GH) - np.diag(hinv_diag)
    M_b = GH.T @ Winv                      # [nz, N n]

    LB_z, UB_z = stacked_bounds(sys, n, m, N, opt.inf_value,
                                terminal=False)

    return dict(
        n=n, m=m, N=N, nz=nz, rho_is_scalar=rho_is_scalar,
        A=A, B=B, AB=np.hstack([A, B]), Qd=Qd, Rd=Rd,
        rho_vec=rho_vec, rho_inv_vec=1.0 / rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        hinv_diag=hinv_diag,
        Hi_0=hinv_diag[:m].copy(),
        Hi_mid=hinv_diag[m:].reshape(N - 1, n + m).copy(),
        M_q=M_q,
        M_b0=M_b[:, :n].copy(), M_bN=M_b[:, -n:].copy(),
        Alpha=Alpha, Beta=Beta, LB_z=LB_z, UB_z=UB_z,
        scaling_x=np.asarray(sys.get("Nx", np.ones(n)), float).ravel(),
        scaling_u=np.asarray(sys.get("Nu", np.ones(m)), float).ravel(),
        op_x=np.asarray(sys.get("x0", np.zeros(n)), float).ravel(),
        op_u=np.asarray(sys.get("u0", np.zeros(m)), float).ravel(),
    )


def _equmpc_q_ref(ing, xr, ur, dtype):
    """q = -(R ur, [Q xr, R ur] x (N-1)) (spcies_equMPC_ADMM_solver.m:274)."""
    Qd = torch.as_tensor(ing["Qd"], dtype=dtype, device=xr.device)
    Rd = torch.as_tensor(ing["Rd"], dtype=dtype, device=xr.device)
    qx = -xr * Qd
    qu = -ur * Rd
    mid = torch.cat([qx, qu], dim=-1)
    return torch.cat([qu, mid.repeat(1, ing["N"] - 1)], dim=-1)


@register_builder("equMPC", "ADMM")
def build_equmpc_admm(sys: dict, param: dict, opt: Options,
                      backend: str = "dense", device="cuda",
                      ingredients: dict | None = None) -> BatchedSolver:
    """Build the equMPC-ADMM solver on `device`. `ingredients` replaces
    the offline computation (same keys as equmpc_admm_ingredients)."""
    device = resolve_device(device)
    if opt.time_varying:
        return _tag_stagewise(
            _tv_admm_solver(sys, param, opt, terminal=False, device=device,
                            ingredients=ingredients), False)
    if backend not in ("dense", "banded", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    ing = (ingredients if ingredients is not None
           else equmpc_admm_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    if backend == "fused":
        # the box-ADMM kernel unchanged: the terminal equality enters only
        # through the affine offset of the peeled first solve
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_box_admm_solve)
        A, M_b0, M_bN = (dev(ing[key], torch.float32)
                         for key in ("A", "M_b0", "M_bN"))
        _solve_f = build_fused_box_admm_solve(
            ing, opt, dtype, device,
            make_q_ref=lambda x0, xr, ur: _equmpc_q_ref(ing, xr, ur,
                                                        torch.float32),
            make_aux_b=lambda x0, xr, ur: ((-(x0 @ A.T)) @ M_b0.T
                                           + xr @ M_bN.T),
            u_start=0)
        return _tag_stagewise(
            BatchedSolver(_solve_f, ing, opt, n=n, m=m, N=N, nz=nz,
                          dtype=dtype, device=device), False)

    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    rho = (dev(ing["rho_scalar"]) if ing["rho_is_scalar"]
           else dev(ing["rho_vec"]))
    rho_i = (dev(1.0 / ing["rho_scalar"]) if ing["rho_is_scalar"]
             else dev(ing["rho_inv_vec"]))
    LB_z, UB_z, A = dev(ing["LB_z"]), dev(ing["UB_z"]), dev(ing["A"])
    if backend == "banded":
        from spcies_tpu_torch.formulations.stagewise import (
            make_banded_eq_qp)
        eq_qp = make_banded_eq_qp(
            ing, dtype, terminal=False,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)),
            device=device)

        def z_lin(dq):
            return eq_qp(dq, None)

        def make_z_step(b0, xr):
            def z_step(q_hat):
                rhs_extra = torch.zeros((q_hat.shape[0], N, n), dtype=dtype,
                                        device=device)
                rhs_extra[:, 0] = -b0
                rhs_extra[:, -1] = -xr
                return eq_qp(q_hat, rhs_extra)
            return z_step
    else:
        M_q, M_b0, M_bN = (dev(ing[key]) for key in ("M_q", "M_b0", "M_bN"))

        def z_lin(dq):
            return delta_dot(dq, M_q.T)

        def make_z_step(b0, xr):
            def z_step(q_hat):
                return q_hat @ M_q.T + b0 @ M_b0.T + xr @ M_bN.T
            return z_step

    def proj(y):
        return proj_box(y, LB_z, UB_z)

    def _solve(x0, xr, ur, init, fixed_iters):
        b0 = -(x0 @ A.T)
        q_ref = _equmpc_q_ref(ing, xr, ur, dtype)
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            make_z_step(b0, xr), proj, q_ref, rho, rho_i, tol, tol, k_max,
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
                      device=device), False)


# ---------------------------------------------------------------------------
# FISTA
# ---------------------------------------------------------------------------

def equmpc_fista_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Analogue of compute_equMPC_FISTA_ingredients.m: H without rho,
    diagonal Q/R, truncated G, b carries xr in the last block."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Qd, Rd = _diag_qr(param, "FISTA")
    nz = N * (n + m) - n

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1))
    hinv_diag = 1.0 / h_diag
    G = linalg.mpc_equality_matrix(A, B, N, drop_terminal=True)
    W = G @ (hinv_diag[:, None] * G.T)
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)
    LB_z, UB_z = stacked_bounds(sys, n, m, N, opt.inf_value,
                                terminal=False)

    return dict(
        n=n, m=m, N=N, nz=nz, A=A, B=B, AB=np.hstack([A, B]),
        Qd=Qd, Rd=Rd, hinv_diag=hinv_diag,
        G=G, Winv=np.linalg.inv(W), Alpha=Alpha, Beta=Beta,
        LB_z=LB_z, UB_z=UB_z,
    )


def _b_equ(ing, x0, xr, dtype):
    """Equality right-hand side b = (-A x0, 0, ..., 0, xr)."""
    A = torch.as_tensor(ing["A"], dtype=dtype, device=x0.device)
    n = ing["n"]
    b = torch.zeros((x0.shape[0], ing["N"] * n), dtype=dtype,
                    device=x0.device)
    b[:, :n] = -(x0 @ A.T)
    b[:, -n:] = xr
    return b


@register_builder("equMPC", "FISTA")
def build_equmpc_fista(sys: dict, param: dict, opt: Options,
                       backend: str = "dense", device="cuda",
                       ingredients: dict | None = None) -> BatchedSolver:
    """equMPC via dual FISTA (code_equMPC_FISTA_C.c,
    spcies_equMPC_FISTA_solver.m) on `device`. `ingredients` replaces the
    offline computation (same keys as equmpc_fista_ingredients)."""
    device = resolve_device(device)
    if opt.time_varying:
        return _tag_stagewise(
            _tv_fista_solver(sys, param, opt, terminal=False, device=device,
                             ingredients=ingredients), False)
    ing = (ingredients if ingredients is not None
           else equmpc_fista_ingredients(sys, param, opt))
    return build_fista(ing, opt, backend, device,
                       make_q_ref=_equmpc_q_ref, make_b=_b_equ,
                       terminal=False)
