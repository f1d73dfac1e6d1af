"""laxMPC formulation — MPC with a terminal cost (no terminal constraint).

    min  sum_{i=0}^{N-1} (||x_i - xr||_Q^2 + ||u_i - ur||_R^2) + ||x_N - xr||_T^2
    s.t. x_{i+1} = A x_i + B u_i,  LB <= (x_i, u_i) <= UB

Decision vector z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, x_N), dim N(n+m).
Reference: formulations/+laxMPC/compute_laxMPC_ADMM_ingredients.m (offline
math), code_laxMPC_ADMM_C.c:308-633 (ADMM loop), TCST 2020 eq. (9).

Port of the ADMM and FISTA parts of spcies_tpu/formulations/laxmpc.py,
with three backends each:
  'dense'  — ADMM: the whole equality-QP solve collapsed offline into one
             affine map z = M_q q_hat + M_b b0 (one [B,nz]x[nz,nz] product
             per iteration), run by the masked loop of solvers/admm.py.
             FISTA: products with G, G' and Winv, run by solvers/fista.py.
  'banded' — structured blockwise RHS build + Alpha/Beta banded Cholesky
             solves (kernels/band_chol.py, formulations/stagewise.py),
             O(N n^2) memory like the reference; scales to long horizons.
  'fused'  — the whole loop in one hand-written GPU kernel per call
             (kernels/fused_admm.py, kernels/fused_fista.py, through
             solvers/fused_backend.py).
and the time-varying mode (opt.time_varying, whatever the backend): the
nine-input signature (x0, xr, ur, A, B, Q, R, LB, UB) with every lane's
band factors computed per call (kernels/online_band_chol.py).
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
    Hi_mid = (np.diag(Hinv)[m:m + (N - 1) * (n + m)]
              .reshape(N - 1, n + m).copy())
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
    device = resolve_device(device)
    if opt.time_varying:
        return _tag_stagewise(
            _tv_admm_solver(sys, param, opt, terminal=True, device=device,
                            ingredients=ingredients), True)
    if backend not in ("dense", "banded", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
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
    A = dev(ing["A"])
    if backend == "banded":
        from spcies_tpu_torch.formulations.stagewise import (
            make_banded_eq_qp)
        eq_qp = make_banded_eq_qp(
            ing, dtype, terminal=True,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)),
            device=device)

        def z_lin(dq):
            return eq_qp(dq, None)

        def make_z_step(b0):
            def z_step(q_hat):
                rhs_extra = torch.zeros((q_hat.shape[0], N, n), dtype=dtype,
                                        device=device)
                rhs_extra[:, 0] = -b0
                return eq_qp(q_hat, rhs_extra)
            return z_step
    else:
        M_q, M_b = dev(ing["M_q"]), dev(ing["M_b"])
        # bf16 delta path (fp32 only): dq -> 0, so the error of a product
        # of bf16-rounded operands shrinks with the residual. The products
        # of bf16 values are exact in fp32 and summed in fp32, as JAX's
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

        def make_z_step(b0):
            def z_step(q_hat):
                return q_hat @ M_q.T + b0 @ M_b.T
            return z_step

    def proj(y):
        return proj_box(y, LB_z, UB_z)

    def _solve(x0, xr, ur, init, fixed_iters):
        b0 = -(x0 @ A.T)
        q_ref = _q_ref(ing, xr, ur, dtype)
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            make_z_step(b0), proj, q_ref, rho, rho_i, tol, tol, k_max,
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
    M_b, A, Qd, Rd, T = (
        torch.as_tensor(ing[key], dtype=torch.float32, device=device)
        for key in ("M_b", "A", "Qd", "Rd", "T"))
    # the weights on the device once: a call copies nothing from the host,
    # so that a CUDA graph can capture it (runtime/rollout.py)
    weights = dict(ing, Qd=Qd, Rd=Rd, T=T)
    _solve = build_fused_box_admm_solve(
        ing, opt, dtype, device,
        make_q_ref=lambda x0, xr, ur: _q_ref(weights, xr, ur, torch.float32),
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


def _make_fista_parts(ing, dtype, device, backend, terminal: bool):
    """FISTA operators shared by laxMPC (terminal=True) and equMPC
    (terminal=False): z-from-q clip, the linear G^T / G applies (consumed
    on deltas by the engine) and the W solve, dense (products with G and
    Winv) or banded (stagewise G applies and the band-Cholesky solve)."""
    from spcies_tpu_torch.formulations import stagewise
    n, m, N = ing["n"], ing["m"], ing["N"]

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    hinv, LB_z, UB_z = (dev(ing[key]) for key in ("hinv_diag", "LB_z",
                                                  "UB_z"))

    def z_from_q(q):
        return proj_box(-hinv * q, LB_z, UB_z)

    if backend == "dense":
        G, Winv = dev(ing["G"]), dev(ing["Winv"])

        def gt_op(y):
            return y @ G

        def g_op(z):
            return z @ G.T

        def w_solve(r):
            return r @ Winv.T
    else:   # banded
        from spcies_tpu_torch.kernels.band_chol import (BandSolve,
                                                        beta_inverses)
        band_solve = BandSolve(
            *(torch.as_tensor(a) for a in beta_inverses(ing["Alpha"],
                                                        ing["Beta"])),
            dtype=dtype, device=device)
        A_, B_, AB = dev(ing["A"]), dev(ing["B"]), dev(ing["AB"])

        def gt_op(y):
            mu = y.reshape(y.shape[0], N, n)
            return stagewise.gt_apply(mu, n, m, B_, AB, terminal)

        def g_op(z):
            z0, zm, zN = stagewise.split_z(z, n, m, N, terminal)
            gz = stagewise.g_apply(z0, zm, zN, A_, B_, AB)
            return gz.reshape(z.shape[0], -1)

        def w_solve(r):
            return band_solve(r.reshape(r.shape[0], N, n)).reshape(
                r.shape[0], -1)

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
    if backend not in ("dense", "banded", "fused"):
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
    z_from_q, gt_op, g_op, w_solve = _make_fista_parts(ing, dtype, device,
                                                       backend, terminal)

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


@register_builder("laxMPC", "FISTA")
def build_laxmpc_fista(sys: dict, param: dict, opt: Options,
                       backend: str = "dense", device="cuda",
                       ingredients: dict | None = None) -> BatchedSolver:
    """laxMPC via dual FISTA (code_laxMPC_FISTA_C.c,
    spcies_laxMPC_FISTA_solver.m) on `device`. `ingredients` replaces the
    offline computation (same keys as laxmpc_fista_ingredients)."""
    device = resolve_device(device)
    if opt.time_varying:
        return _tag_stagewise(
            _tv_fista_solver(sys, param, opt, terminal=True, device=device,
                             ingredients=ingredients), True)
    ing = (ingredients if ingredients is not None
           else laxmpc_fista_ingredients(sys, param, opt))
    return build_fista(ing, opt, backend, device,
                       make_q_ref=_q_ref, make_b=_fista_b_lax, terminal=True)


# ---------------------------------------------------------------------------
# Time-varying mode (opt.time_varying): per-call (A, B, Q, R, LB, UB)
# ---------------------------------------------------------------------------

TV_INPUTS = ("x0", "xr", "ur", "A", "B", "Q", "R", "LB", "UB")
TV_CORE_NDIMS = (1, 1, 1, 2, 2, 1, 1, 1, 1)


def tv_dims(sys, param, opt, ingredients, terminal: bool):
    """(n, m, N, nz) of a time-varying solver. Its ingredients are
    computed per call from the inputs, so a given ingredient dict is
    refused rather than ignored."""
    if ingredients is not None:
        raise ValueError(
            "the time-varying mode computes its ingredients per call from "
            "its inputs; build it from sys and param (ingredients=None)")
    A0, B0, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    return n, m, N, N * (n + m) - (0 if terminal else n)


def tv_stage_bounds(LB, UB, n, N, terminal: bool):
    """Stacked bounds over z from the per-call single-stage [LBx; LBu],
    held constant over the horizon (struct_laxMPC_ADMM_C_Matlab.c:29-88)."""
    LBx, LBu = LB[:, :n], LB[:, n:]
    UBx, UBu = UB[:, :n], UB[:, n:]
    mid_lb = torch.cat([LBx, LBu], dim=-1).repeat(1, N - 1)
    mid_ub = torch.cat([UBx, UBu], dim=-1).repeat(1, N - 1)
    if terminal:
        return (torch.cat([LBu, mid_lb, LBx], dim=-1),
                torch.cat([UBu, mid_ub, UBx], dim=-1))
    return torch.cat([LBu, mid_lb], dim=-1), torch.cat([UBu, mid_ub], dim=-1)


def _tv_admm_solver(sys, param, opt, *, terminal: bool, device,
                    ingredients=None):
    """Shared time-varying ADMM builder for laxMPC (terminal=True) and
    equMPC (terminal=False).

    Mirrors the reference's TIME_VARYING=1 solvers: 9-input signature
    (x0, xr, ur, A, B, Qdiag, Rdiag, LB, UB) with LB/UB = [LBx; LBu] held
    constant over the horizon (struct_laxMPC_ADMM_C_Matlab.c:29-88), scalar
    rho only (cons_laxMPC_ADMM_C.m:47-52), and the Alpha/Beta band factors
    recomputed online (code_laxMPC_ADMM_C.c:150-279), here as a batched
    blocked Cholesky over the stages (kernels/online_band_chol.py), so
    every lane can carry a DIFFERENT model, which the reference cannot
    express.

    solver options:
      band_parallel_scan — O(log N)-depth scan band solve.
      tv_dense_w — materialize each lane's dense W = G Hhat^-1 G'
        ([B, Nn, Nn]) and solve with a batched dense Cholesky instead of
        the O(N) banded factors: the structure-oblivious path, whose
        memory is quadratic in the horizon PER LANE.
    """
    from spcies_tpu_torch.formulations import stagewise
    from spcies_tpu_torch.kernels.band_chol import BandSolve
    from spcies_tpu_torch.kernels.online_band_chol import online_band_chol_fn

    n, m, N, nz = tv_dims(sys, param, opt, ingredients, terminal)
    dtype = _DTYPES[opt.precision]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    rho_f = opt.solver["rho"]
    if np.ndim(rho_f) != 0:
        raise ValueError("time-varying mode requires scalar rho "
                         "(cons_laxMPC_ADMM_C.m:47-52)")
    rho = torch.tensor(float(rho_f), dtype=dtype, device=device)
    rho_i = torch.tensor(1.0 / float(rho_f), dtype=dtype, device=device)

    if terminal:
        T = np.asarray(param["T"], dtype=float)
        # (T + rho I)^-1 is computed OFFLINE (T is not time-varying;
        # compute_laxMPC_ADMM_ingredients.m:109-118)
        T_rho_i = torch.as_tensor(np.linalg.inv(T + float(rho_f) * np.eye(n)),
                                  dtype=dtype, device=device)
        Tt = torch.as_tensor(T, dtype=dtype, device=device)
    else:
        T_rho_i = None
        Tt = None
    chol_fn = online_band_chol_fn(N, terminal)
    dense_w = bool(opt.solver.get("tv_dense_w", False))
    scan = bool(opt.solver.get("band_parallel_scan", False))

    def _make_dense_w_solve(A, B, Qhat_inv, Rhat_inv):
        """Per-lane dense W [B, Nn, Nn] + batched Cholesky (tv_dense_w).
        W is block-tridiagonal: D_0 = B Ri B' + diag(Qi);
        D_l = A Qi A' + B Ri B' + (diag(Qi) | T_rho_i | nothing) for the
        next-state weight; E_l = -diag(Qi) A' couples stages l, l+1. The
        blocks are written into one zeroed [B, N, n, N, n] tensor, which
        the factor then replaces."""
        Bsz = A.shape[0]
        Nn = N * n
        AQ = A * Qhat_inv[:, None, :]            # A diag(Qi)
        BR = B * Rhat_inv[:, None, :]
        AQA = torch.einsum("bij,bkj->bik", AQ, A)
        BRB = torch.einsum("bij,bkj->bik", BR, B)
        Dmid = AQA + BRB                          # [B, n, n]
        Qdiag = torch.diag_embed(Qhat_inv)        # [B, n, n]
        D_last = Dmid + T_rho_i if terminal else Dmid
        D = torch.stack([BRB + Qdiag] + [Dmid + Qdiag] * (N - 2) + [D_last])
        E = -torch.einsum("bi,bji->bij", Qhat_inv, A)   # -diag(Qi) A'
        stage = torch.arange(N, device=A.device)
        W = torch.zeros((Bsz, N, n, N, n), dtype=A.dtype, device=A.device)
        W[:, stage, :, stage, :] = D
        W[:, stage[:-1], :, stage[1:], :] = E
        W[:, stage[1:], :, stage[:-1], :] = E.transpose(-1, -2)
        L, info = torch.linalg.cholesky_ex(W.reshape(Bsz, Nn, Nn),
                                           check_errors=False)
        del W
        # a lane whose W is not positive definite gets NaN, as the JAX
        # package's Cholesky gives
        L.masked_fill_((info != 0)[:, None, None], float("nan"))

        def solve_W(rhs):                         # rhs [B, N, n]
            out = torch.cholesky_solve(rhs.reshape(Bsz, Nn, 1), L)
            return out.reshape(Bsz, N, n)

        return solve_W

    def _solve(x0, xr, ur, A, B, Qd, Rd, LB, UB, init, fixed_iters):
        Bsz = x0.shape[0]
        Qhat_inv = 1.0 / (Qd + rho)              # [B, n]
        Rhat_inv = 1.0 / (Rd + rho)              # [B, m]
        if dense_w:
            solve_W = _make_dense_w_solve(A, B, Qhat_inv, Rhat_inv)
        else:
            solve_W = BandSolve(*chol_fn(A, B, Qhat_inv, Rhat_inv, T_rho_i),
                                scan=scan)
        AB = torch.cat([A, B], dim=-1)           # [B, n, n+m]
        Hi_0 = Rhat_inv
        Hi_mid = (torch.cat([Qhat_inv, Rhat_inv], dim=-1).repeat(1, N - 1)
                  .reshape(Bsz, N - 1, n + m))

        def hinv(q):
            q0, qm, qN = stagewise.split_z(q, n, m, N, terminal)
            hN = qN @ T_rho_i.T if terminal else None
            return Hi_0 * q0, Hi_mid * qm, hN

        def z_of_rhs(h0, hm, hN, rhs):
            mu = solve_W(rhs)
            g0, gm, gN = stagewise.split_z(
                stagewise.gt_apply(mu, n, m, B, AB, terminal),
                n, m, N, terminal)
            z0 = -(h0 + Hi_0 * g0)
            zm = -(hm + Hi_mid * gm)
            zN = -(hN + gN @ T_rho_i.T) if terminal else None
            return stagewise.join_z(z0, zm, zN)

        b0 = -torch.einsum("bij,bj->bi", A, x0)

        def z_step_full(q_hat):
            h0, hm, hN = hinv(q_hat)
            rhs = -stagewise.g_apply(h0, hm, hN, A, B, AB)
            rhs[:, 0] += -b0
            if not terminal:
                rhs[:, -1] += -xr
            return z_of_rhs(h0, hm, hN, rhs)

        def z_lin(dq):
            h0, hm, hN = hinv(dq)
            return z_of_rhs(h0, hm, hN,
                            -stagewise.g_apply(h0, hm, hN, A, B, AB))

        LB_z, UB_z = tv_stage_bounds(LB, UB, n, N, terminal)

        # linear cost from runtime diagonals
        qu = -ur * Rd
        mid_q = torch.cat([-xr * Qd, qu], dim=-1).repeat(1, N - 1)
        if terminal:
            q_ref = torch.cat([qu, mid_q, -(xr @ Tt.T)], dim=-1)
        else:
            q_ref = torch.cat([qu, mid_q], dim=-1)

        def proj(y):
            return proj_box(y, LB_z, UB_z)

        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            z_step_full, proj, q_ref, rho, rho_i, tol, tol, k_max,
            batch=Bsz, nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=z_lin, history=opt.debug, device=device)
        return SolveResult(u=v[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, dict(n=n, m=m, N=N, nz=nz), opt, n=n, m=m, N=N, nz=nz,
        dtype=dtype, device=device, input_names=TV_INPUTS,
        input_core_ndims=TV_CORE_NDIMS)


def _tv_fista_solver(sys, param, opt, *, terminal: bool, device,
                     ingredients=None):
    """Time-varying dual FISTA for laxMPC (terminal=True) / equMPC
    (terminal=False): same 9-input signature as the TIME_VARYING ADMM
    (code_laxMPC_FISTA_C.c TIME_VARYING path); W = G H^-1 G' factored
    online per lane (no rho in H)."""
    from spcies_tpu_torch.formulations import stagewise
    from spcies_tpu_torch.kernels.band_chol import BandSolve
    from spcies_tpu_torch.kernels.online_band_chol import online_band_chol_fn

    n, m, N, nz = tv_dims(sys, param, opt, ingredients, terminal)
    dtype = _DTYPES[opt.precision]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    if terminal:
        T = np.asarray(param["T"], dtype=float)
        if not np.allclose(T, np.diag(np.diag(T))):
            raise ValueError("laxMPC/FISTA requires diagonal T")
        Td = np.diag(T).copy()
        T_inv = torch.as_tensor(np.diag(1.0 / Td), dtype=dtype,
                                device=device)
        Td_t = torch.as_tensor(Td, dtype=dtype, device=device)
    else:
        T_inv = None
        Td_t = None
    chol_fn = online_band_chol_fn(N, terminal)

    def _solve(x0, xr, ur, A, B, Qd, Rd, LB, UB, init, fixed_iters):
        Bsz = x0.shape[0]
        Qinv = 1.0 / Qd
        Rinv = 1.0 / Rd
        band_solve = BandSolve(*chol_fn(A, B, Qinv, Rinv, T_inv))
        AB = torch.cat([A, B], dim=-1)
        hinv = [Rinv, torch.cat([Qinv, Rinv], dim=-1).repeat(1, N - 1)]
        if terminal:
            hinv.append((1.0 / Td_t)[None, :].expand(Bsz, n))
        hinv = torch.cat(hinv, dim=-1)

        LB_z, UB_z = tv_stage_bounds(LB, UB, n, N, terminal)

        qu = -ur * Rd
        mid_q = torch.cat([-xr * Qd, qu], dim=-1).repeat(1, N - 1)
        if terminal:
            q_ref = torch.cat([qu, mid_q, -xr * Td_t], dim=-1)
        else:
            q_ref = torch.cat([qu, mid_q], dim=-1)

        b = torch.zeros((Bsz, N * n), dtype=dtype, device=device)
        b[:, :n] = -torch.einsum("bij,bj->bi", A, x0)
        if not terminal:
            b[:, -n:] = xr

        def z_from_q(q):
            return proj_box(-hinv * q, LB_z, UB_z)

        def gt_op(y):
            mu = y.reshape(Bsz, N, n)
            return stagewise.gt_apply(mu, n, m, B, AB, terminal)

        def g_op(z):
            z0, zm, zN = stagewise.split_z(z, n, m, N, terminal)
            gz = stagewise.g_apply(z0, zm, zN, A, B, AB)
            return gz.reshape(Bsz, -1)

        def w_solve(r):
            return band_solve(r.reshape(Bsz, N, n)).reshape(Bsz, -1)

        z, y, lam, k, e_flag, res, hist = fista_solve(
            z_from_q, gt_op, g_op, w_solve, q_ref, b,
            tol=tol, k_max=k_max, batch=Bsz, nlam=N * n, dtype=dtype,
            lam_init=None if init is None else init[0],
            fixed_iters=fixed_iters,
            restart=bool(opt.solver.get("restart", False)), device=device)
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, lam=y, res=res,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, dict(n=n, m=m, N=N, nz=nz), opt, n=n, m=m, N=N, nz=nz,
        dtype=dtype, device=device, input_names=TV_INPUTS,
        input_core_ndims=TV_CORE_NDIMS)
