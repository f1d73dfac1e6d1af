"""laxMPC formulation — MPC with a terminal cost (no terminal constraint).

    min  sum_{i=0}^{N-1} (||x_i - xr||_Q^2 + ||u_i - ur||_R^2) + ||x_N - xr||_T^2
    s.t. x_{i+1} = A x_i + B u_i,  LB <= (x_i, u_i) <= UB

Decision vector z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, x_N), dim N(n+m).
Reference: formulations/+laxMPC/compute_laxMPC_ADMM_ingredients.m (offline
math), code_laxMPC_ADMM_C.c:308-633 (ADMM loop), TCST 2020 eq. (9).

Port of the ADMM and FISTA parts of spcies_tpu/formulations/laxmpc.py,
with two backends each:
  'dense' — ADMM: the whole equality-QP solve collapsed offline into one
            affine map z = M_q q_hat + M_b b0 (one [B,nz]x[nz,nz] product
            per iteration), run by the masked loop of solvers/admm.py.
            FISTA: products with G, G' and Winv, run by solvers/fista.py.
  'fused' — the whole loop in one hand-written GPU kernel per call
            (kernels/fused_admm.py, kernels/fused_fista.py, through
            solvers/fused_backend.py).
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
from spcies_tpu_torch.solvers.fista import fista_solve
from spcies_tpu_torch.solvers.common import (SolveResult, hist_sol_entries,
                                             delta_dot)
from spcies_tpu_torch.api import BatchedSolver, resolve_device

_DTYPES = {"double": torch.float64, "float": torch.float32}


def stacked_bounds(sys, n, m, N, inf_value, *, terminal: bool):
    """Stage bounds stacked over the decision vector: LB = (LBu, [LBx, LBu]
    x (N-1)[, LBx]), v_0 clipped by LBu and, with a terminal state, v_N by
    LBx (code_laxMPC_ADMM_C.c:487-537; equMPC has no terminal block,
    spcies_equMPC_ADMM_solver.m:195-196)."""
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, inf_value)
    tail = 1 if terminal else 0
    LB = np.concatenate([LBu] + [np.concatenate([LBx, LBu])] * (N - 1)
                        + [LBx] * tail)
    UB = np.concatenate([UBu] + [np.concatenate([UBx, UBu])] * (N - 1)
                        + [UBx] * tail)
    return LB, UB


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

    LB_z, UB_z = stacked_bounds(sys, n, m, N, opt.inf_value, terminal=True)

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
                      backend: str = "dense", device="cuda",
                      ingredients: dict | None = None) -> BatchedSolver:
    """Build the laxMPC-ADMM solver on `device`. `ingredients` replaces
    the offline computation (same keys as laxmpc_admm_ingredients)."""
    _reject_unported(opt, backend)
    if backend not in ("dense", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# FISTA
# ---------------------------------------------------------------------------

def laxmpc_fista_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients for dual FISTA, the analogue of
    compute_laxMPC_FISTA_ingredients.m (H without rho; Q, R, T all diagonal
    required, :50-52; exports Hinv diag and the W band factors :71-97)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    for name, M in (("Q", Q), ("R", R), ("T", T)):
        if not np.allclose(M, np.diag(np.diag(M))):
            raise ValueError(
                f"laxMPC/FISTA requires diagonal {name} "
                "(compute_laxMPC_FISTA_ingredients.m:50-52)")
    Qd, Rd, Td = np.diag(Q).copy(), np.diag(R).copy(), np.diag(T).copy()
    nz = N * (n + m)

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1)
                            + [Td])
    hinv_diag = 1.0 / h_diag
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ (hinv_diag[:, None] * G.T)
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    LB_z, UB_z = stacked_bounds(sys, n, m, N, opt.inf_value, terminal=True)

    return dict(
        n=n, m=m, N=N, nz=nz, A=A, B=B, AB=np.hstack([A, B]),
        Qd=Qd, Rd=Rd, T=T, hinv_diag=hinv_diag,
        G=G, Winv=np.linalg.inv(W), Alpha=Alpha, Beta=Beta,
        LB_z=LB_z, UB_z=UB_z,
    )


def _make_fista_parts(ing, dtype, device):
    """Dense FISTA operators, shared by laxMPC and equMPC: z-from-q clip,
    the linear G^T / G applies (consumed on deltas by the engine) and the
    W solve as a product with Winv."""
    hinv = torch.as_tensor(ing["hinv_diag"], dtype=dtype, device=device)
    LB_z = torch.as_tensor(ing["LB_z"], dtype=dtype, device=device)
    UB_z = torch.as_tensor(ing["UB_z"], dtype=dtype, device=device)
    G = torch.as_tensor(ing["G"], dtype=dtype, device=device)
    Winv = torch.as_tensor(ing["Winv"], dtype=dtype, device=device)

    def z_from_q(q):
        return proj_box(-hinv * q, LB_z, UB_z)

    def gt_op(y):
        return y @ G

    def g_op(z):
        return z @ G.T

    def w_solve(r):
        return r @ Winv.T

    return z_from_q, gt_op, g_op, w_solve


def _fista_b_lax(ing, x0, xr, dtype):
    """Equality right-hand side b = (-A x0, 0, ..., 0)."""
    A = torch.as_tensor(ing["A"], dtype=dtype, device=x0.device)
    b = torch.zeros((x0.shape[0], ing["N"] * ing["n"]), dtype=dtype,
                    device=x0.device)
    b[:, :ing["n"]] = -(x0 @ A.T)
    return b


def build_fista(ing, opt, backend, device, *, make_q_ref, make_b,
                terminal: bool):
    """The dense or fused dual-FISTA solver of laxMPC (terminal=True) or
    equMPC (terminal=False): make_q_ref(ing, xr, ur, dtype) and
    make_b(ing, x0, xr, dtype) build the per-call cost and right-hand
    side."""
    if backend not in ("dense", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    dtype = _DTYPES[opt.precision]
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_fista_solve)
        f32 = torch.float32
        _solve = build_fused_fista_solve(
            ing, opt, dtype, device,
            make_q_ref=lambda x0, xr, ur: make_q_ref(ing, xr, ur, f32),
            make_b=lambda x0, xr, ur: make_b(ing, x0, xr, f32))
        return _tag_stagewise(
            BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz,
                          dtype=dtype, device=device), terminal)

    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    z_from_q, gt_op, g_op, w_solve = _make_fista_parts(ing, dtype, device)

    def _solve(x0, xr, ur, init, fixed_iters):
        z, y, lam, k, e_flag, res, hist = fista_solve(
            z_from_q, gt_op, g_op, w_solve, make_q_ref(ing, xr, ur, dtype),
            make_b(ing, x0, xr, dtype), tol=tol, k_max=k_max,
            batch=x0.shape[0], nlam=N * n, dtype=dtype,
            lam_init=None if init is None else init[0],
            fixed_iters=fixed_iters,
            restart=bool(opt.solver.get("restart", False)),
            history=opt.debug, device=device)
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, lam=y, res=res,
                                    **hist_sol_entries(hist)))

    return _tag_stagewise(
        BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype,
                      device=device), terminal)


def _reject_unported(opt, backend):
    if opt.time_varying:
        raise NotImplementedError(
            "time-varying laxMPC/equMPC is not ported to spcies_tpu_torch "
            "yet (ROADMAP queue 1 item 8)")
    if backend == "banded":
        raise NotImplementedError(
            "backend='banded' is not ported to spcies_tpu_torch yet "
            "(ROADMAP queue 1 item 8)")


@register_builder("laxMPC", "FISTA")
def build_laxmpc_fista(sys: dict, param: dict, opt: Options,
                       backend: str = "dense", device="cuda",
                       ingredients: dict | None = None) -> BatchedSolver:
    """laxMPC via dual FISTA (code_laxMPC_FISTA_C.c,
    spcies_laxMPC_FISTA_solver.m) on `device`. `ingredients` replaces the
    offline computation (same keys as laxmpc_fista_ingredients)."""
    _reject_unported(opt, backend)
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else laxmpc_fista_ingredients(sys, param, opt))
    return build_fista(ing, opt, backend, device,
                       make_q_ref=_q_ref, make_b=_fista_b_lax, terminal=True)
