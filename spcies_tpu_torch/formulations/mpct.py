"""MPCT formulation — MPC for tracking with artificial references
(arXiv:2008.09071).

    min  sum_{i=0}^{N} (||x_i - x_s||_Q^2 + ||u_i - u_s||_R^2)
         + ||x_s - xr||_T^2 + ||u_s - ur||_S^2
    s.t. x_0 = x(t), x_{i+1} = A x_i + B u_i, (x_s, u_s) steady state,
         x_N = x_s, u_N = u_s, LB <= (x_i, u_i) <= UB (eps-tightened at N)

Port of the EADMM and ADMM-cs parts of spcies_tpu/formulations/mpct.py:

  EADMM    three-block extended ADMM (compute_MPCT_EADMM_ingredients.m,
           code_MPCT_EADMM_C.c:85-459): z1 = (x_i, u_i) box-clipped
           diagonal QP, z2 = (x_s, u_s) dense W2 multiply, z3 = (hat x_i,
           hat u_i) equality QP over the prediction dynamics. 'dense' runs
           the coupling matrices A1/A2/A3 matrix-free (reshapes and sums) on
           the masked loop of solvers/loop.py; 'fused' runs the whole loop
           in one hand-written GPU kernel per call (kernels/fused_eadmm.py,
           through solvers/fused_backend.py FusedEADMMSolve).
  ADMM-cs  ADMM on the extended (x_i, x_s, u_i, u_s) state space
           (code_MPCT_ADMM_cs_C.c:94-218): 'dense' is the affine map
           z = M_q q_hat + M_b x0 on solvers/admm.py; 'fused' the box-ADMM
           kernel (kernels/fused_admm.py) unchanged.
  ADMM-semiband  ADMM on the semiband (non-extended) parameterisation
           (code_MPCT_ADMM_semiband_C.c:119-1125) with the reference's
           soft constraints and constrained output: 'dense' collapses the
           two-level Woodbury KKT solve into the affine map
           z = M_q p + M_b x0, 'banded' keeps it as stage-local operators
           (`_make_semiband_structured_z_step`), both on the masked loop
           of solvers/loop.py.

ADMM-cs also runs 'banded', the O(N)-memory long-horizon path (stage-
local operators and a block-tridiagonal Cholesky, kernels/band_chol.py),
and a time-varying mode (opt.time_varying, whatever the backend): the
nine-input signature of laxMPC's, every lane's band factors computed per
call (kernels/online_band_chol.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from spcies_tpu_torch.api import BatchedSolver, resolve_device
from spcies_tpu_torch.config import Options
from spcies_tpu_torch.formulations.base import (get_bounds, get_sys_matrices,
                                                register_builder)
from spcies_tpu_torch.formulations.laxmpc import _DTYPES
from spcies_tpu_torch.solvers.admm import admm_solve
from spcies_tpu_torch.solvers.common import (SolveResult, delta_dot,
                                             hist_sol_entries, inf_norm)
from spcies_tpu_torch.solvers.loop import run_masked_loop
from spcies_tpu_torch.utils import linalg
from spcies_tpu_torch.utils.projections import proj_box


def _mpct_rho_vector(n, m, N, rho_base, rho_mult):
    """Structured penalty vector emphasizing the initial/terminal equality
    rows (compute_MPCT_EADMM_ingredients.m:81-91)."""
    nm = n + m
    nrow = (N + 1) * nm + n + nm
    rho = np.full(nrow, rho_base, dtype=float)
    hi = rho_mult * rho_base
    rho[:2 * n] = hi                          # x_0 = x and (6i) i=0 x-part
    rho[nrow - 2 * nm:] = hi                  # final coupling + (xs,us) rows
    return rho


def mpct_eadmm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients (compute_MPCT_EADMM_ingredients.m:60-316)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    S = np.asarray(param["S"], dtype=float)
    nm = n + m
    nz1 = (N + 1) * nm
    nrow = nz1 + n + nm

    if "rho" in opt.solver:
        # a scalar rho collapses to rho_base=rho, rho_mult=1
        # (compute_MPCT_EADMM_ingredients.m:76-79)
        rho_base = float(opt.solver["rho"])
        rho_mult = 1.0
    else:
        rho_base = float(opt.solver["rho_base"])
        rho_mult = float(opt.solver["rho_mult"])
    rho = _mpct_rho_vector(n, m, N, rho_base, rho_mult)
    # rho partitioned along the constraint rows: head n, middle (N+1)(n+m),
    # tail (n+m)
    rho_mid = rho[n:n + nz1]
    rho_head = rho[:n]
    rho_tail = rho[-nm:]

    # P1: H1 = (rho.*A1)'A1 is diagonal; diag = rho_mid + head/tail additions
    h1_diag = rho_mid.copy()
    h1_diag[:n] += rho_head
    h1_diag[-nm:] += rho_tail
    H1i = 1.0 / h1_diag

    # P2: H2 = blkdiag(T, S) + (rho.*A2)'A2, with A2'diag(rho)A2 the sum of
    # the middle rho blocks and the tail block on the diagonal
    r2 = rho_mid.reshape(N + 1, nm).sum(axis=0) + rho_tail
    H2 = linalg.blkdiag(T, S) + np.diag(r2)
    H2i = np.linalg.inv(H2)
    Az2 = np.hstack([A - np.eye(n), B])
    W2 = H2i @ Az2.T @ np.linalg.inv(Az2 @ H2i @ Az2.T) @ Az2 @ H2i - H2i

    # P3: H3 = kron(I_{N+1}, blkdiag(Q, R)) + diag(rho_mid)
    H3 = linalg.blkdiag(*([linalg.blkdiag(Q, R)] * (N + 1))) + np.diag(rho_mid)
    # force_diagonal (compute_MPCT_EADMM_ingredients.m:142-155): with
    # diagonal Q and R, H3^{-1} is the reciprocal of its diagonal; otherwise
    # the general inverse. M3 is baked offline either way, so the solve is
    # the same.
    is_diag = (np.allclose(Q, np.diag(np.diag(Q)))
               and np.allclose(R, np.diag(np.diag(R))))
    if opt.force_diagonal and is_diag:
        H3inv = np.diag(1.0 / np.diag(H3))
    else:
        H3inv = np.linalg.inv(H3)
    # Az3: hat-dynamics A x_i + B u_i - x_{i+1} = 0 over N row blocks,
    # z3 stage-ordered (x_i, u_i) for i = 0..N
    Az3 = np.zeros((N * n, nz1))
    for i in range(N):
        Az3[i * n:(i + 1) * n, i * nm:i * nm + n] = A
        Az3[i * n:(i + 1) * n, i * nm + n:(i + 1) * nm] = B
        Az3[i * n:(i + 1) * n, (i + 1) * nm:(i + 1) * nm + n] = -np.eye(n)
    W3 = Az3 @ H3inv @ Az3.T
    W3inv = np.linalg.inv(W3)
    M3 = H3inv @ Az3.T @ W3inv @ Az3 @ H3inv - H3inv  # z3 = M3 q3

    # z1 bounds: x_0 free, stages 1..N-1 plain, stage N eps-tightened
    # (compute_MPCT_EADMM_ingredients.m:295-296)
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    eps_x = float(opt.solver.get("epsilon_x", 1e-6))
    eps_u = float(opt.solver.get("epsilon_u", 1e-6))
    inf_v = opt.inf_value
    LB0 = np.concatenate([-inf_v * np.ones(n), LBu])
    UB0 = np.concatenate([inf_v * np.ones(n), UBu])
    LBmid = np.concatenate([LBx, LBu])
    UBmid = np.concatenate([UBx, UBu])
    LBs = np.concatenate([LBx + eps_x, LBu + eps_u])
    UBs = np.concatenate([UBx - eps_x, UBu - eps_u])
    LB = np.concatenate([LB0] + [LBmid] * (N - 1) + [LBs])
    UB = np.concatenate([UB0] + [UBmid] * (N - 1) + [UBs])

    return dict(
        n=n, m=m, N=N, nm=nm, nz1=nz1, nrow=nrow,
        A=A, B=B, T=T, S=S,
        rho=rho, H1i=H1i, W2=W2, M3=M3, H3inv=H3inv, Az3=Az3, W3=W3,
        LB=LB, UB=UB,
    )


@register_builder("MPCT", "EADMM")
def build_mpct_eadmm(sys: dict, param: dict, opt: Options,
                     backend: str = "dense", device="cuda",
                     ingredients: dict | None = None) -> BatchedSolver:
    """Build the MPCT-EADMM solver on `device`. `ingredients` replaces the
    offline computation (same keys as mpct_eadmm_ingredients). The warm
    start is init=(z1, z2, z3, lam)."""
    if backend not in ("dense", "fused"):
        raise ValueError("MPCT/EADMM has dense and fused backends")
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else mpct_eadmm_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N, nm = ing["n"], ing["m"], ing["N"], ing["nm"]
    nz1, nrow = ing["nz1"], ing["nrow"]
    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_eadmm_solve)
        _solve_f = build_fused_eadmm_solve(ing, opt, dtype, device)
        return BatchedSolver(_solve_f, ing, opt, n=n, m=m, N=N, nz=nz1,
                             dtype=dtype, device=device)
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rho, H1i, W2, M3, LB, UB, T, S = (
        dev(ing[key]) for key in ("rho", "H1i", "W2", "M3", "LB", "UB", "T",
                                  "S"))
    rho_head = rho[:n]
    rho_mid = rho[n:n + nz1].reshape(N + 1, nm)
    rho_tail = rho[-nm:]

    # Matrix-free applies of the coupling matrices
    # (compute_MPCT_EADMM_ingredients.m:95-105): constraint rows split into
    # head [B, n] (x_0 = x), middle [B, N+1, nm] (-z1 + z2 + z3 = 0),
    # tail [B, nm] (z2 = (x_N, u_N)).
    def couple(z1, z2, z3, b0):
        """A1 z1 + A2 z2 + A3 z3 - b as (head, mid, tail)."""
        z1b = z1.reshape(-1, N + 1, nm)
        head = z1b[:, 0, :n] - b0
        mid = -z1b + z2[:, None, :] + z3.reshape(-1, N + 1, nm)
        tail = z2 - z1b[:, N, :]
        return head, mid, tail

    def a1t(head, mid, tail):
        """A1' applied to rows -> [B, nz1]."""
        out = -mid
        out[:, 0, :n] = out[:, 0, :n] + head
        out[:, N, :] = out[:, N, :] + (-tail)
        return out.reshape(-1, nz1)

    def a2t(head, mid, tail):
        """A2' applied to rows -> [B, nm]."""
        return mid.sum(dim=1) + tail

    def a3t(head, mid, tail):
        """A3' applied to rows -> [B, nz1]."""
        return mid.reshape(-1, nz1)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        # z2's linear cost (spcies_MPCT_EADMM_solver.m:194)
        q2_ref = -torch.cat([xr @ T.T, ur @ S.T], dim=-1)

        def zeros(*shape):
            return torch.zeros((Bsz, *shape), dtype=dtype, device=device)

        if init is None:
            z1_0, z2_0, z3_0, lam0 = zeros(nz1), zeros(nm), zeros(nz1), zeros(
                nrow)
        else:
            z1_0, z2_0, z3_0, lam0 = (torch.as_tensor(a, dtype=dtype,
                                                      device=device)
                                      for a in init)

        rinf = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
        state0 = dict(z1=z1_0, z2=z2_0, z3=z3_0, lam=lam0,
                      r_pf=rinf, r_z2=rinf, r_z3=rinf)
        zn, z1z = zeros(n), zeros(nz1)

        def lam_split(lam):
            return (lam[:, :n], lam[:, n:n + nz1].reshape(-1, N + 1, nm),
                    lam[:, -nm:])

        def body(state, _it):
            z2, z3, lam = state["z2"], state["z3"], state["lam"]
            lh, lm, lt = lam_split(lam)
            # P1 (spcies_MPCT_EADMM_solver.m:183-189): couple() with z1=0
            # gives the A2 z2 + A3 z3 - b rows
            h, mid, t = couple(z1z, z2, z3, x0)
            q1 = (a1t(rho_head * h, rho_mid * mid, rho_tail * t)
                  + a1t(lh, lm, lt))
            z1 = proj_box(-q1 * H1i, LB, UB)
            # P2 (:194-198): the A1 z1 + A3 z3 rows (b has no A2' support)
            h, mid, t = couple(z1, zeros(nm), z3, zn)
            q2 = (q2_ref + a2t(rho_head * h, rho_mid * mid, rho_tail * t)
                  + a2t(lh, lm, lt))
            z2_new = q2 @ W2.T
            # P3 (:203-210): the A1 z1 + A2 z2 rows
            h, mid, t = couple(z1, z2_new, z1z, zn)
            q3 = (a3t(rho_head * h, rho_mid * mid, rho_tail * t)
                  + a3t(lh, lm, lt))
            z3_new = q3 @ M3.T
            # residuals and dual update (:213-228)
            h, mid, t = couple(z1, z2_new, z3_new, x0)
            res_flat = torch.cat([h, mid.reshape(Bsz, -1), t], dim=-1)
            lam_new = lam + rho * res_flat
            r_pf = inf_norm(res_flat)
            r_z2 = inf_norm(z2_new - z2)
            r_z3 = inf_norm(z3_new - z3)
            conv = (r_pf <= tol) & (r_z2 <= tol) & (r_z3 <= tol)
            return (dict(z1=z1, z2=z2_new, z3=z3_new, lam=lam_new,
                         r_pf=r_pf, r_z2=r_z2, r_z3=r_z3), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_pf", "r_z2", "r_z3")
                + (("z1", "z2", "z3", "lam")
                   if int(opt.debug) >= 2 else ()))
            traces = {"hRpf": hist["r_pf"], "hRz2": hist["r_z2"],
                      "hRz3": hist["r_z3"]}
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            traces = {}
        return SolveResult(u=state["z1"][:, n:n + m], k=k, e_flag=e_flag,
                           sol=dict(z1=state["z1"], z2=state["z2"],
                                    z3=state["z3"], lam=state["lam"],
                                    r_pf=state["r_pf"], r_z2=state["r_z2"],
                                    r_z3=state["r_z3"], **traces))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz1,
                         dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# ADMM-cs: compact/extended state space
# ---------------------------------------------------------------------------

def mpct_cs_equality_matrix(A: np.ndarray, B: np.ndarray, N: int):
    """Equality matrix over the extended stage variables
    z_j = (x_j, x_s, u_j, u_s), j = 0..N-1
    (compute_MPCT_ADMM_cs_ingredients.m:96-113):
      rows 0..n:      x_0 = x(t)
      rows n..2n:     (A - I) x_s + B u_s = 0
      per transition: A x_j + B u_j - x_{j+1} = 0; x_s, u_s constant
      last n rows:    A x_{N-1} + B u_{N-1} = x_s
    """
    n, m = A.shape[0], B.shape[1]
    sd = 2 * (n + m)                    # stage dim
    neq = 2 * n + (2 * n + m) * (N - 1) + n
    Aeq = np.zeros((neq, N * sd))
    # init condition + steady-state condition on stage 0
    Aeq[:n, :n] = np.eye(n)
    Aeq[n:2 * n, n:2 * n] = A - np.eye(n)
    Aeq[n:2 * n, 2 * n + m:sd] = B
    r = 2 * n
    for j in range(N - 1):
        c = j * sd
        # A x_j + B u_j - x_{j+1} = 0
        Aeq[r:r + n, c:c + n] = A
        Aeq[r:r + n, c + 2 * n:c + 2 * n + m] = B
        Aeq[r:r + n, c + sd:c + sd + n] = -np.eye(n)
        # x_s carried: x_s_j - x_s_{j+1} = 0
        Aeq[r + n:r + 2 * n, c + n:c + 2 * n] = np.eye(n)
        Aeq[r + n:r + 2 * n, c + sd + n:c + sd + 2 * n] = -np.eye(n)
        # u_s carried
        Aeq[r + 2 * n:r + 2 * n + m, c + 2 * n + m:c + sd] = np.eye(m)
        Aeq[r + 2 * n:r + 2 * n + m, c + sd + 2 * n + m:c + 2 * sd] = -np.eye(m)
        r += 2 * n + m
    # terminal: A x_{N-1} + B u_{N-1} - x_s = 0
    c = (N - 1) * sd
    Aeq[r:r + n, c:c + n] = A
    Aeq[r:r + n, c + n:c + 2 * n] = -np.eye(n)
    Aeq[r:r + n, c + 2 * n:c + 2 * n + m] = B
    return Aeq


def mpct_admm_cs_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients (compute_MPCT_ADMM_cs_ingredients.m:83-141): the
    reference's CSR SpMV and sparse LDL collapse into the dense affine map
    z = M_q q_hat + M_b x0."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    S = np.asarray(param["S"], dtype=float)
    sd = 2 * (n + m)
    nz = N * sd

    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nz, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")

    Qz = np.block([[Q, -Q], [-Q, Q + T / N]])
    Rz = np.block([[R, -R], [-R, R + S / N]])
    H = linalg.blkdiag(*([linalg.blkdiag(Qz, Rz)] * N))
    Hhat = H + np.diag(rho_vec)
    Hinv = np.linalg.inv(Hhat)

    G = mpct_cs_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T
    GH = G @ Hinv
    Winv = np.linalg.inv(W)
    M_q = GH.T @ (Winv @ GH) - Hinv
    M_b = GH.T @ Winv[:, :n]          # beq nonzero only in x_0 = x(t) rows

    # eps-tightened bounds on every stage (:115-122)
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    eps_x = float(opt.solver["epsilon_x"])
    eps_u = float(opt.solver["epsilon_u"])
    LBst = np.concatenate([LBx, LBx + eps_x, LBu, LBu + eps_u])
    UBst = np.concatenate([UBx, UBx - eps_x, UBu, UBu - eps_u])
    LB = np.tile(LBst, N)
    UB = np.tile(UBst, N)

    return dict(
        n=n, m=m, N=N, nz=nz, rho_is_scalar=rho_is_scalar,
        A=A, B=B, T=T, S=S,
        rho_vec=rho_vec, rho_inv_vec=1.0 / rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        M_q=M_q, M_b=M_b, LB=LB, UB=UB,
    )


def mpct_cs_banded_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """O(N)-memory structured ingredients for MPCT ADMM-cs, the
    long-horizon path (the role the reference's CSR/LDL sparsity plays,
    compute_MPCT_ADMM_cs_ingredients.m:124-141, done with stacked stage
    blocks + a block-tridiagonal Cholesky, never forming dense H/G/W/M_q).

    The multiplier rows partition into Nb = N+1 blocks of non-uniform
    size (2n for init + steady-state on stage 0, 2n+m per transition, n
    for the terminal x_s coupling), padded to bmax = 2n+m with identity
    diagonal pads (zero rhs pads keep the padded mu entries exactly 0).
    Memory: O(N (2(n+m))^2) against the dense path's O((N 2(n+m))^2) M_q.
    """
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    S = np.asarray(param["S"], dtype=float)
    sd = 2 * (n + m)
    nz = N * sd
    bmax = 2 * n + m

    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nz, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")

    # per-stage Hessian blocks + inverses [N, sd, sd]
    Qz = np.block([[Q, -Q], [-Q, Q + T / N]])
    Rz = np.block([[R, -R], [-R, R + S / N]])
    Hs = linalg.blkdiag(Qz, Rz)
    Hinv_st = np.empty((N, sd, sd))
    for j in range(N):
        Hinv_st[j] = np.linalg.inv(Hs + np.diag(rho_vec[j * sd:(j + 1) * sd]))

    # stage coefficient matrices of the equality rows
    # (mpct_cs_equality_matrix layout: z_j = (x_j, x_s, u_j, u_s))
    E0 = np.zeros((2 * n, sd))               # stage 0: init + steady state
    E0[:n, :n] = np.eye(n)
    E0[n:, n:2 * n] = A - np.eye(n)
    E0[n:, 2 * n + m:] = B
    C = np.zeros((bmax, sd))                 # transition rows on stage j-1
    C[:n, :n] = A
    C[:n, 2 * n:2 * n + m] = B
    C[n:2 * n, n:2 * n] = np.eye(n)
    C[2 * n:, 2 * n + m:] = np.eye(m)
    D = np.zeros((bmax, sd))                 # transition rows on stage j
    D[:n, :n] = -np.eye(n)
    D[n:2 * n, n:2 * n] = -np.eye(n)
    D[2 * n:, 2 * n + m:] = -np.eye(m)
    F = np.zeros((n, sd))                    # terminal rows on stage N-1
    F[:, :n] = A
    F[:, n:2 * n] = -np.eye(n)
    F[:, 2 * n:2 * n + m] = B

    # padded block-tridiagonal W blocks (identity on pad diagonals)
    Nb = N + 1
    Wd = np.zeros((Nb, bmax, bmax))
    Wu = np.zeros((Nb - 1, bmax, bmax))
    Wd[0, :2 * n, :2 * n] = E0 @ Hinv_st[0] @ E0.T
    Wd[0, 2 * n:, 2 * n:] = np.eye(m)
    Wu[0, :2 * n, :] = E0 @ Hinv_st[0] @ C.T
    for j in range(1, N):
        Wd[j] = C @ Hinv_st[j - 1] @ C.T + D @ Hinv_st[j] @ D.T
        if j < N - 1:
            Wu[j] = D @ Hinv_st[j] @ C.T
    Wu[N - 1, :, :n] = D @ Hinv_st[N - 1] @ F.T
    Wd[N, :n, :n] = F @ Hinv_st[N - 1] @ F.T
    Wd[N, n:, n:] = np.eye(bmax - n)
    Alpha, BetaInv = linalg.band_chol_blocks_tridiag(Wd, Wu)

    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    eps_x = float(opt.solver["epsilon_x"])
    eps_u = float(opt.solver["epsilon_u"])
    LBst = np.concatenate([LBx, LBx + eps_x, LBu, LBu + eps_u])
    UBst = np.concatenate([UBx, UBx - eps_x, UBu, UBu - eps_u])

    return dict(
        n=n, m=m, N=N, nz=nz, sd=sd, bmax=bmax,
        rho_is_scalar=rho_is_scalar,
        A=A, B=B, T=T, S=S,
        rho_vec=rho_vec, rho_inv_vec=1.0 / rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        Hinv_st=Hinv_st, E0=E0, Cst=C, Dst=D, Fst=F,
        Alpha=Alpha, BetaInv=BetaInv, LB=np.tile(LBst, N),
        UB=np.tile(UBst, N),
    )


def _cs_q_ref(T, S, N):
    """The per-stage linear cost [0; -(T/N) xr; 0; -(S/N) ur], tiled
    (spcies_MPCT_ADMM_cs_solver.m:172 with vars.Tz = -T/N)."""
    def q_ref(x0, xr, ur):
        qstage = torch.cat(
            [torch.zeros_like(x0), -(xr @ T.T) / N,
             torch.zeros_like(ur), -(ur @ S.T) / N], dim=-1)
        return qstage.repeat(1, N)
    return q_ref


def _make_cs_banded_z_step(ing, dtype, device, parallel_scan=False):
    """z_step(q_hat, x0 | None) for the structured MPCT-cs backend:
    z = -Hinv(q_hat + G'mu), W mu = -G Hinv q_hat - beq, all operations
    stage-local, the band solve through the Alpha/BetaInv blocks.
    parallel_scan routes it through the O(log N)-depth scan
    (kernels.band_chol.BandSolve) for long horizons."""
    from spcies_tpu_torch.kernels.band_chol import BandSolve
    n, N, sd, bmax = ing["n"], ing["N"], ing["sd"], ing["bmax"]
    Hinv_st, E0, C, D, F = (
        torch.as_tensor(ing[key], dtype=dtype, device=device)
        for key in ("Hinv_st", "E0", "Cst", "Dst", "Fst"))
    band_solve = BandSolve(
        *(torch.as_tensor(ing[key]) for key in ("Alpha", "BetaInv")),
        scan=parallel_scan, dtype=dtype, device=device)

    def hinv_apply(q):
        return torch.einsum("bls,lts->blt", q, Hinv_st)

    def g_apply(h):
        """G h -> padded [B, Nb, bmax] row blocks."""
        blk0 = F_.pad(h[:, 0] @ E0.T, (0, bmax - 2 * n))
        mid = h[:, :N - 1] @ C.T + h[:, 1:] @ D.T
        blkN = F_.pad(h[:, N - 1] @ F.T, (0, bmax - n))
        return torch.cat([blk0[:, None], mid, blkN[:, None]], dim=1)

    def gt_apply(mu):
        """G' mu -> [B, N, sd] stage contributions."""
        out = torch.zeros((mu.shape[0], N, sd), dtype=dtype, device=device)
        out[:, :N - 1] = mu[:, 1:N] @ C                     # stage j-1
        out[:, 1:N] += mu[:, 1:N] @ D
        out[:, 0] += mu[:, 0, :2 * n] @ E0
        out[:, N - 1] += mu[:, N, :n] @ F
        return out

    def z_step(q_hat, x0=None):
        Bsz = q_hat.shape[0]
        h = hinv_apply(q_hat.reshape(Bsz, N, sd))
        rhs = -g_apply(h)
        if x0 is not None:
            # beq nonzero only in the x_0 = x(t) rows (rhs -= beq)
            rhs[:, 0, :n] += -x0
        mu = band_solve(rhs)
        z = -(h + hinv_apply(gt_apply(mu)))
        return z.reshape(Bsz, -1)

    return z_step


@register_builder("MPCT", "ADMM", "cs")
def build_mpct_admm_cs(sys: dict, param: dict, opt: Options,
                       backend: str = "dense", device="cuda",
                       ingredients: dict | None = None) -> BatchedSolver:
    """MPCT via ADMM on the extended (x_i, x_s, u_i, u_s) state space
    (code_MPCT_ADMM_cs_C.c:94-218, spcies_MPCT_ADMM_cs_solver.m) on
    `device`. `ingredients` replaces the offline computation (same keys as
    mpct_admm_cs_ingredients, or mpct_cs_banded_ingredients for
    backend='banded'). backend='banded' is the O(N)-memory long-horizon
    path; opt.time_varying takes the per-lane time-varying path whatever
    the backend."""
    if backend not in ("dense", "fused", "banded"):
        raise ValueError("MPCT/ADMM-cs has dense, banded and fused backends")
    device = resolve_device(device)
    if opt.time_varying:
        return _tv_cs_banded_solver(sys, param, opt, device, ingredients)
    if backend == "banded":
        return _build_mpct_cs_banded(sys, param, opt, device, ingredients)
    ing = (ingredients if ingredients is not None
           else mpct_admm_cs_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_box_admm_solve)
        f32 = torch.float32
        M_b32 = dev(ing["M_b"], f32)
        _solve_f = build_fused_box_admm_solve(
            ing, opt, dtype, device,
            make_q_ref=_cs_q_ref(dev(ing["T"], f32), dev(ing["S"], f32),
                                 N),
            make_aux_b=lambda x0, xr, ur: x0 @ M_b32.T,
            u_start=2 * n, lb_key="LB", ub_key="UB")
        return BatchedSolver(_solve_f, ing, opt, n=n, m=m, N=N, nz=nz,
                             dtype=dtype, device=device)

    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    rho, rho_i = _admm_rho(ing, dev)
    LB, UB, M_q, M_b = (dev(ing[key]) for key in ("LB", "UB", "M_q", "M_b"))
    q_ref_fn = _cs_q_ref(dev(ing["T"]), dev(ing["S"]), N)

    def proj(y):
        return proj_box(y, LB, UB)

    def _solve(x0, xr, ur, init, fixed_iters):
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            lambda q_hat: q_hat @ M_q.T + x0 @ M_b.T, proj,
            q_ref_fn(x0, xr, ur), rho, rho_i, tol, tol, k_max,
            batch=x0.shape[0], nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=lambda dq: delta_dot(dq, M_q.T), history=opt.debug,
            device=device)
        return SolveResult(u=v[:, 2 * n:2 * n + m], k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype,
                         device=device)


def _admm_rho(ing, dev):
    """(rho, rho_i) of an ADMM ingredient dict: scalars, or per-entry
    vectors."""
    if ing["rho_is_scalar"]:
        return dev(ing["rho_scalar"]), dev(1.0 / ing["rho_scalar"])
    return dev(ing["rho_vec"]), dev(ing["rho_inv_vec"])


def _build_mpct_cs_banded(sys, param, opt, device, ingredients=None):
    ing = (ingredients if ingredients is not None
           else mpct_cs_banded_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rho, rho_i = _admm_rho(ing, dev)
    LB, UB = dev(ing["LB"]), dev(ing["UB"])
    q_ref_fn = _cs_q_ref(dev(ing["T"]), dev(ing["S"]), N)
    z_step = _make_cs_banded_z_step(
        ing, dtype, device,
        parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))

    def _solve(x0, xr, ur, init, fixed_iters):
        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            lambda q_hat: z_step(q_hat, x0),
            lambda y: proj_box(y, LB, UB), q_ref_fn(x0, xr, ur), rho, rho_i,
            tol, tol, k_max, batch=x0.shape[0], nz=nz, dtype=dtype,
            init=init, fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=lambda dq: z_step(dq, None), history=opt.debug,
            device=device)
        return SolveResult(u=v[:, 2 * n:2 * n + m], k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype,
                         device=device)


def _tv_cs_banded_solver(sys, param, opt, device, ingredients=None):
    """Per-lane time-varying MPCT-ADMM-cs through the O(N) banded path.

    9-input signature matching the laxMPC/equMPC time-varying convention
    (x0, xr, ur, A, B, Qdiag, Rdiag, LB, UB): every lane carries its OWN
    model and single-stage bounds [LBx; LBu]. T and S stay offline
    constants (the laxMPC time-varying mode's T treatment,
    compute_laxMPC_ADMM_ingredients.m:109-118); scalar rho only. All
    per-lane ingredients (the stage Hessian inverse, the E0/C/D/F equality
    stage maps, and the block-tridiagonal W factors) are rebuilt inside
    the solve (kernels/online_band_chol.py online_band_chol_tridiag), so
    memory stays O(B N (2n+m)^2). No reference counterpart: the reference
    has no TIME_VARYING mode for MPCT (cons_laxMPC_ADMM_C.m:47-52 scope).
    """
    from spcies_tpu_torch.formulations.laxmpc import (TV_CORE_NDIMS,
                                                      TV_INPUTS, tv_dims)
    from spcies_tpu_torch.kernels.band_chol import BandSolve
    from spcies_tpu_torch.kernels.online_band_chol import (
        online_band_chol_tridiag)

    n, m, N, _ = tv_dims(sys, param, opt, ingredients, True)
    sd = 2 * (n + m)
    bmax = 2 * n + m
    nz = N * sd
    Nb = N + 1
    dtype = _DTYPES[opt.precision]
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    rho_f = opt.solver["rho"]
    if np.ndim(rho_f) != 0:
        raise ValueError("time-varying mode requires scalar rho "
                         "(cons_laxMPC_ADMM_C.m:47-52 convention)")

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rho, rho_i = dev(float(rho_f)), dev(1.0 / float(rho_f))
    eps_x = float(opt.solver["epsilon_x"])
    eps_u = float(opt.solver["epsilon_u"])
    T = np.asarray(param["T"], dtype=float)
    S = np.asarray(param["S"], dtype=float)
    q_ref_fn = _cs_q_ref(dev(T), dev(S), N)
    TN, SN = dev(T / N), dev(S / N)
    scan = bool(opt.solver.get("band_parallel_scan", False))

    def _solve(x0, xr, ur, A, B, Qd, Rd, LB1, UB1, init, fixed_iters):
        Bsz = x0.shape[0]

        def zeros(*shape):
            return torch.zeros((Bsz,) + shape, dtype=dtype, device=device)

        # per-lane stage Hessian Hhat = blkdiag(Qz, Rz) + rho I and its
        # inverse (one sd x sd per lane; every stage shares it)
        dQ = torch.diag_embed(Qd)                 # [B, n, n]
        dR = torch.diag_embed(Rd)
        Hs = zeros(sd, sd)
        Hs[:, :n, :n] = dQ
        Hs[:, :n, n:2 * n] = -dQ
        Hs[:, n:2 * n, :n] = -dQ
        Hs[:, n:2 * n, n:2 * n] = dQ + TN
        Hs[:, 2 * n:2 * n + m, 2 * n:2 * n + m] = dR
        Hs[:, 2 * n:2 * n + m, 2 * n + m:] = -dR
        Hs[:, 2 * n + m:, 2 * n:2 * n + m] = -dR
        Hs[:, 2 * n + m:, 2 * n + m:] = dR + SN
        Hinv = torch.linalg.inv_ex(
            Hs + rho * torch.eye(sd, dtype=dtype, device=device),
            check_errors=False).inverse

        # per-lane equality stage maps (mpct_cs_banded_ingredients layout)
        eyen = torch.eye(n, dtype=dtype, device=device)
        eyem = torch.eye(m, dtype=dtype, device=device)
        E0 = zeros(2 * n, sd)
        E0[:, :n, :n] = eyen
        E0[:, n:, n:2 * n] = A - eyen
        E0[:, n:, 2 * n + m:] = B
        C = zeros(bmax, sd)
        C[:, :n, :n] = A
        C[:, :n, 2 * n:2 * n + m] = B
        C[:, n:2 * n, n:2 * n] = eyen
        C[:, 2 * n:, 2 * n + m:] = eyem
        D = zeros(bmax, sd)
        D[:, :n, :n] = -eyen
        D[:, n:2 * n, n:2 * n] = -eyen
        D[:, 2 * n:, 2 * n + m:] = -eyem
        F = zeros(n, sd)
        F[:, :, :n] = A
        F[:, :, n:2 * n] = -eyen
        F[:, :, 2 * n:2 * n + m] = B

        # X Hinv per lane, and the outer products X Hinv Y'
        E0H, CH, DH, FH = (X @ Hinv for X in (E0, C, D, F))

        def outer(XH, Y):
            return XH @ Y.transpose(-1, -2)

        # block-tridiagonal W blocks, identity on pad diagonals
        Wd = zeros(Nb, bmax, bmax)
        Wd[:, 0, :2 * n, :2 * n] = outer(E0H, E0)
        Wd[:, 0, 2 * n:, 2 * n:] = eyem
        Wd[:, 1:N] = (outer(CH, C) + outer(DH, D))[:, None]
        Wd[:, N, :n, :n] = outer(FH, F)
        Wd[:, N, n:, n:] = torch.eye(bmax - n, dtype=dtype, device=device)
        Wu = zeros(Nb - 1, bmax, bmax)
        Wu[:, 0, :2 * n, :] = outer(E0H, C)
        Wu[:, 1:N - 1] = outer(DH, C)[:, None]
        Wu[:, N - 1, :, :n] = outer(DH, F)
        band_solve = BandSolve(*online_band_chol_tridiag(Wd, Wu), scan=scan)

        def hinv_apply(q):                      # q [B, N, sd]
            return q @ Hinv.transpose(-1, -2)

        def lane_rows(h, M):                    # h [B, sd] -> h M' [B, r]
            return (h[:, None] @ M.transpose(-1, -2))[:, 0]

        def g_apply(h):
            blk0 = F_.pad(lane_rows(h[:, 0], E0), (0, bmax - 2 * n))
            mid = (h[:, :N - 1] @ C.transpose(-1, -2)
                   + h[:, 1:] @ D.transpose(-1, -2))
            blkN = F_.pad(lane_rows(h[:, N - 1], F), (0, bmax - n))
            return torch.cat([blk0[:, None], mid, blkN[:, None]], dim=1)

        def gt_apply(mu):
            out = zeros(N, sd)
            out[:, :N - 1] = mu[:, 1:N] @ C
            out[:, 1:N] += mu[:, 1:N] @ D
            out[:, 0] += (mu[:, 0, None, :2 * n] @ E0)[:, 0]
            out[:, N - 1] += (mu[:, N, None, :n] @ F)[:, 0]
            return out

        def z_step(q_hat, with_b0):
            h = hinv_apply(q_hat.reshape(Bsz, N, sd))
            rhs = -g_apply(h)
            if with_b0:
                rhs[:, 0, :n] += -x0
            mu = band_solve(rhs)
            z = -(h + hinv_apply(gt_apply(mu)))
            return z.reshape(Bsz, -1)

        # eps-tightened per-lane stage bounds (mpct_admm_cs_ingredients)
        LBx, LBu = LB1[:, :n], LB1[:, n:]
        UBx, UBu = UB1[:, :n], UB1[:, n:]
        LB = torch.cat([LBx, LBx + eps_x, LBu, LBu + eps_u],
                       dim=-1).repeat(1, N)
        UB = torch.cat([UBx, UBx - eps_x, UBu, UBu - eps_u],
                       dim=-1).repeat(1, N)

        z, v, lam, k, e_flag, r_p, r_d, hist = admm_solve(
            lambda qh: z_step(qh, True),
            lambda y: proj_box(y, LB, UB), q_ref_fn(x0, xr, ur), rho, rho_i,
            tol, tol, k_max, batch=Bsz, nz=nz, dtype=dtype, init=init,
            fixed_iters=fixed_iters,
            relax_alpha=float(opt.solver.get("relax_alpha", 1.0)),
            freeze_converged=bool(opt.solver.get("freeze_converged", True)),
            straggler_polish=int(opt.solver.get("straggler_polish", 0)),
            z_lin=lambda dq: z_step(dq, False), history=opt.debug,
            device=device)
        return SolveResult(u=v[:, 2 * n:2 * n + m], k=k, e_flag=e_flag,
                           sol=dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d,
                                    **hist_sol_entries(hist)))

    return BatchedSolver(
        _solve, dict(n=n, m=m, N=N, nz=nz), opt, n=n, m=m, N=N, nz=nz,
        dtype=dtype, device=device, input_names=TV_INPUTS,
        input_core_ndims=TV_CORE_NDIMS)


# ---------------------------------------------------------------------------
# ADMM-semiband
# ---------------------------------------------------------------------------

def _soft_box_prox(y, lb, ub, br):
    """Prox of the soft-constraint penalty beta*dist_box(v) at y: the
    reference's five-case scalar branch
    (spcies_MPCT_ADMM_semiband_solver.m:407-430), branch-free. br = beta/rho
    (scalar or per-entry)."""
    v1 = y + br
    v3 = y - br
    inside = (y >= lb) & (y <= ub)
    return torch.where(v1 <= lb, v1,
                       torch.where(inside, y,
                                   torch.where(v3 >= ub, v3,
                                               proj_box(y, lb, ub))))


def mpct_semiband_equality_matrix(A: np.ndarray, B: np.ndarray, N: int):
    """G over z = (x_0,u_0,...,x_{N-1},u_{N-1},x_s,u_s)
    (compute_MPCT_ADMM_semiband_ingredients.m:136-151): x_0 = x(t), the N
    dynamics rows (the last one maps into x_s), and the equilibrium row."""
    n, m = A.shape[0], B.shape[1]
    nm = n + m
    nz = (N + 1) * nm
    G = np.zeros(((N + 2) * n, nz))
    G[:n, :n] = np.eye(n)
    for k in range(N):
        r = (k + 1) * n
        c = k * nm
        G[r:r + n, c:c + n] = A
        G[r:r + n, c + n:c + nm] = B
        G[r:r + n, c + nm:c + nm + n] = -np.eye(n)
    G[-n:, -nm:-m] = A - np.eye(n)
    G[-n:, -m:] = B
    return G


def mpct_admm_semiband_ingredients(sys: dict, param: dict,
                                   opt: Options,
                                   structured: bool = False) -> dict:
    """Offline ingredients (compute_MPCT_ADMM_semiband_ingredients.m), in
    two arms:
      structured=False: the reference's two-level Woodbury (banded
        Gamma_hat plus a rank-2(n+m) correction, ECC'24) avoids dense
        factorisation on embedded CPUs; here the same KKT solve collapses
        into the dense affine map z = M_q p + M_b x0, algebraically
        identical and one matrix product online. O(N^2) memory.
      structured=True: the long-horizon arm keeping the reference's O(N)
        memory (:163-227): the per-stage Hhat block inverses, the level-1
        Woodbury factors of the rank-2(n+m) stage <-> terminal coupling
        (Gu, Gv, K1), the block-tridiagonal Cholesky of Gamma_tilde =
        G Gamma_hat^-1 G' (Alpha, BetaInv) and the level-2 correction (Pu,
        Vt, K2), each O(N (n+m)^2); M_q and M_b are None."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    S = np.asarray(param["S"], dtype=float)
    nm = n + m
    nz = (N + 1) * nm
    constrained_output = bool(opt.solver["constrained_output"])
    soft = bool(opt.solver["soft_constraints"])
    eps_x = float(opt.solver["epsilon_x"])
    eps_u = float(opt.solver["epsilon_u"])
    eps_y = float(opt.solver["epsilon_y"])
    beta = float(opt.solver["beta"])

    if constrained_output:
        if "C" not in sys or "LBy" not in sys or "UBy" not in sys:
            raise ValueError(
                "MPCT/ADMM-semiband constrained_output=True requires sys "
                "fields C (output map), LBy, UBy (and optionally D): the "
                "cons_MPCT_ADMM_semiband_C.m constrained-output contract")
        C = np.asarray(sys["C"], dtype=float)
        D = np.asarray(sys.get("D", np.zeros((C.shape[0], m))), dtype=float)
        p = C.shape[0]
        stage_map = np.vstack([np.hstack([np.eye(n), np.zeros((n, m))]),
                               np.hstack([np.zeros((m, n)), np.eye(m)]),
                               np.hstack([C, D])])
        C_tilde = linalg.blkdiag(*([stage_map] * (N + 1)))
    else:
        p = 0
        C_tilde = None
    sv = nm + p            # per-stage v dimension
    nv = (N + 1) * sv

    rho = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho.ndim == 0 and not force_vec
    rho_vec = np.full(nv, float(rho)) if rho.ndim == 0 else rho.ravel().copy()
    if rho_vec.size != nv:
        raise ValueError(f"rho vector must have length {nv}")

    # Hessian: banded stage costs + rank-(n+m) coupling to (x_s, u_s)
    # (:119-133), by stage blocks in the structured arm
    QR = linalg.blkdiag(Q, R)
    QT = linalg.blkdiag(N * Q + T, N * R + S)
    structured_keys = {}
    if structured:
        structured_keys = _semiband_structured_keys(
            A, B, N, QR, QT, rho_vec.reshape(N + 1, sv),
            stage_map if constrained_output else None)
        M_q = M_b = None
    else:
        H = linalg.blkdiag(*([QR] * N), QT)
        H[:N * nm, -nm:] = np.tile(-QR, (N, 1))
        H[-nm:, :N * nm] = np.tile(-QR, (1, N))
        if constrained_output:
            Hhat = H + C_tilde.T @ (rho_vec[:, None] * C_tilde)
        else:
            Hhat = H + np.diag(rho_vec)
        Hinv = np.linalg.inv(Hhat)
        G = mpct_semiband_equality_matrix(A, B, N)
        W = G @ Hinv @ G.T
        GH = G @ Hinv
        Winv = np.linalg.inv(W)
        M_q = GH.T @ (Winv @ GH) - Hinv
        M_b = GH.T @ Winv[:, :n]

    # per-entry bound vectors + soft mask over v (:358-520 branch layout)
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
    if constrained_output:
        LBy = np.asarray(sys.get("LBy", -opt.inf_value * np.ones(p)),
                         float).ravel()
        UBy = np.asarray(sys.get("UBy", opt.inf_value * np.ones(p)),
                         float).ravel()
        stage_lb = np.concatenate([LBx, LBu, LBy])
        stage_ub = np.concatenate([UBx, UBu, UBy])
        eps_stage = np.concatenate([np.full(n, eps_x), np.full(m, eps_u),
                                    np.full(p, eps_y)])
    else:
        stage_lb = np.concatenate([LBx, LBu])
        stage_ub = np.concatenate([UBx, UBu])
        eps_stage = np.concatenate([np.full(n, eps_x), np.full(m, eps_u)])

    inf_v = opt.inf_value
    lb0 = stage_lb.copy()
    ub0 = stage_ub.copy()
    lb0[:n] = -inf_v          # x_0 unconstrained
    ub0[:n] = inf_v
    if soft:                   # terminal untightened in soft mode
        lbT, ubT = stage_lb, stage_ub
    else:
        lbT = stage_lb + eps_stage
        ubT = stage_ub - eps_stage
    LBv = np.concatenate([lb0] + [stage_lb] * (N - 1) + [lbT])
    UBv = np.concatenate([ub0] + [stage_ub] * (N - 1) + [ubT])
    # soft mask: x_0 and u_0 never soft; y_0 and stages 1..N soft
    soft_mask = np.ones(nv, dtype=bool)
    soft_mask[:nm] = False

    return dict(
        n=n, m=m, N=N, p=p, nz=nz, nv=nv,
        rho_is_scalar=rho_is_scalar, rho_vec=rho_vec,
        rho_scalar=float(rho) if rho.ndim == 0 else None,
        A=A, T=T, S=S, M_q=M_q, M_b=M_b, C_tilde=C_tilde,
        LBv=LBv, UBv=UBv, soft_mask=soft_mask,
        beta=beta, soft=soft, constrained_output=constrained_output,
        **structured_keys,
    )


def _semiband_structured_keys(A, B, N, QR, QT, rho_st, stage_map):
    """The structured arm's offline factors, fp64 numpy
    (compute_MPCT_ADMM_semiband_ingredients.m:163-227). Hhat = Gamma_hat +
    U V' with Gamma_hat the per-stage blocks (QR, or QT at the terminal,
    plus each stage's rho shift) and the rank-2(n+m) stage <-> terminal
    coupling Y = 1_N (x) (-QR) (:118-132): U = [1_N (x) I, 0; 0, I],
    V = [0, 1_N (x) (-QR); -QR, 0]. rho_st [N + 1, sv] is rho by stage;
    stage_map the constrained output's stage map, or None."""
    n, m = B.shape
    nm = n + m
    nz = (N + 1) * nm
    Nb = N + 2
    blocks = np.empty((N + 1, nm, nm))
    for i in range(N + 1):
        Hst = QR if i < N else QT
        if stage_map is not None:
            blocks[i] = Hst + stage_map.T @ (rho_st[i][:, None] * stage_map)
        else:
            blocks[i] = Hst + np.diag(rho_st[i])
    blocks_inv = np.linalg.inv(blocks)
    # level-1 Woodbury: Hhat^-1 = Gamma^-1 - Gu K1 Gv' with
    # Gu = Gamma^-1 U, Gv = Gamma^-1 V, K1 = (I + V' Gu)^-1
    Gu = np.zeros((nz, 2 * nm))
    Gv = np.zeros((nz, 2 * nm))
    for i in range(N):
        Gu[i * nm:(i + 1) * nm, :nm] = blocks_inv[i]
        Gv[i * nm:(i + 1) * nm, nm:] = -blocks_inv[i] @ QR
    Gu[N * nm:, nm:] = blocks_inv[N]
    Gv[N * nm:, :nm] = -blocks_inv[N] @ QR
    VtGu = np.zeros((2 * nm, 2 * nm))
    VtGu[:nm] = -QR @ Gu[N * nm:]
    VtGu[nm:] = -QR @ Gu[:N * nm].reshape(N, nm, 2 * nm).sum(axis=0)
    K1 = np.linalg.inv(np.eye(2 * nm) + VtGu)
    # Gamma_tilde = G Gamma^-1 G' is block tridiagonal in n x n blocks
    # (row blocks: the x_0 pin, N dynamics rows, the equilibrium row)
    E = np.hstack([np.eye(n), np.zeros((n, m))])
    Cst = np.hstack([A, B])
    Dst = np.hstack([-np.eye(n), np.zeros((n, m))])
    Eq = np.hstack([A - np.eye(n), B])
    Wd = np.zeros((Nb, n, n))
    Wu = np.zeros((Nb - 1, n, n))
    Wd[0] = blocks_inv[0][:n, :n]
    Wu[0] = (E @ blocks_inv[0]) @ Cst.T
    for k in range(1, N + 1):
        Wd[k] = (Cst @ blocks_inv[k - 1] @ Cst.T
                 + Dst @ blocks_inv[k] @ Dst.T)
        if k < N:
            Wu[k] = Dst @ blocks_inv[k] @ Cst.T
    Wu[N] = Dst @ blocks_inv[N] @ Eq.T
    Wd[N + 1] = Eq @ blocks_inv[N] @ Eq.T
    Alpha, BetaInv = linalg.band_chol_blocks_tridiag(Wd, Wu)

    def g_np(Z):
        """G Z columnwise (offline, structural)."""
        Zs = Z.reshape(N + 1, nm, -1)
        out = np.empty((Nb * n, Z.shape[1]))
        out[:n] = Zs[0, :n]
        for k in range(N):
            out[(k + 1) * n:(k + 2) * n] = (
                A @ Zs[k][:n] + B @ Zs[k][n:] - Zs[k + 1][:n])
        out[-n:] = (A - np.eye(n)) @ Zs[N][:n] + B @ Zs[N][n:]
        return out

    # level-2 Woodbury: W = Gamma_tilde - Ut K1 Vt' with Ut = G Gu,
    # Vt = G Gv; W^-1 r = Gt^-1 r + Pu K2 Vt' Gt^-1 r, Pu = Gt^-1 Ut,
    # K2 = (K1^-1 - Vt' Pu)^-1. The dense Gamma_tilde is an offline
    # temporary.
    Ut = g_np(Gu)
    Vt = g_np(Gv)
    Gt = np.zeros((Nb * n, Nb * n))
    for k in range(Nb):
        Gt[k * n:(k + 1) * n, k * n:(k + 1) * n] = Wd[k]
        if k < Nb - 1:
            Gt[k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n] = Wu[k]
            Gt[(k + 1) * n:(k + 2) * n, k * n:(k + 1) * n] = Wu[k].T
    Pu = np.linalg.solve(Gt, Ut)
    K2 = np.linalg.inv(np.eye(2 * nm) + VtGu - Vt.T @ Pu)
    return dict(blocks_inv=blocks_inv, Gu=Gu, Gv=Gv, K1=K1, Alpha=Alpha,
                BetaInv=BetaInv, Pu=Pu, Vt=Vt, K2=K2, B=B,
                stage_map=stage_map)


def _make_semiband_structured_z_step(ing, dtype, device,
                                     parallel_scan=False):
    """z_step(p, x0 | None) for the O(N)-memory semiband backend, the
    reference's Alg. 2 two-level Woodbury (code_MPCT_ADMM_semiband_C.c:
    119-496) as stage-local batched products: the block-diagonal
    Gamma_hat solves with the rank-2(n+m) level-1 correction, the band
    solve on Gamma_tilde (kernels/band_chol.py `BandSolve`, the scan with
    parallel_scan, its products of the fixed blocks formed once, here) and
    the level-2 correction. Nothing O(N^2) is on the device. Port of
    spcies_tpu/formulations/mpct.py `_make_semiband_structured_z_step`."""
    from spcies_tpu_torch.kernels.band_chol import BandSolve
    n, m, N = ing["n"], ing["m"], ing["N"]
    nm = n + m
    Nb = N + 2

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    Bi, Gu, Gv, K1, Pu, Vt, K2, A_, B_ = (dev(ing[key]) for key in (
        "blocks_inv", "Gu", "Gv", "K1", "Pu", "Vt", "K2", "A", "B"))
    band_solve = BandSolve(
        *(torch.as_tensor(ing[key]) for key in ("Alpha", "BetaInv")),
        scan=parallel_scan, dtype=dtype, device=device)
    AmI = A_ - torch.eye(n, dtype=dtype, device=device)

    def hinv(x):
        """Hhat^-1 x = Gamma^-1 x - Gu K1 (Gv' x) (level-1 Woodbury)."""
        xs = x.reshape(-1, N + 1, nm)
        gx = torch.einsum("bls,lts->blt", xs, Bi).reshape(x.shape)
        return gx - ((x @ Gv) @ K1.T) @ Gu.T

    def g_apply(h):
        """G h -> [B, Nb, n] row blocks (x_0 pin, dynamics, equilibrium)."""
        hs = h.reshape(-1, N + 1, nm)
        hx, hu = hs[..., :n], hs[..., n:]
        r0 = hx[:, 0]
        rdyn = (torch.einsum("blj,ij->bli", hx[:, :N], A_)
                + torch.einsum("blj,ij->bli", hu[:, :N], B_)
                - hx[:, 1:])
        rlast = hx[:, N] @ AmI.T + hu[:, N] @ B_.T
        return torch.cat([r0[:, None], rdyn, rlast[:, None]], dim=1)

    def gt_apply(mu):
        """G' mu -> flat [B, nz] stage contributions."""
        gx = torch.einsum("blj,ji->bli", mu[:, 1:N + 1], A_)
        gu = torch.einsum("blj,ji->bli", mu[:, 1:N + 1], B_)
        # the x_0 pin's rows on stage 0, the next-state rows on stages 1..
        gx = gx + torch.cat([mu[:, :1], -mu[:, 1:N]], dim=1)
        tx = -mu[:, N] + mu[:, N + 1] @ AmI
        tu = mu[:, N + 1] @ B_
        stages = torch.cat([gx, gu], dim=-1).reshape(mu.shape[0], -1)
        return torch.cat([stages, tx, tu], dim=-1)

    def z_step(p, x0=None):
        h1 = hinv(p)
        rhs = -g_apply(h1)
        if x0 is not None:
            # out of place: the delta-form step passes its inputs on
            rhs = torch.cat([rhs[:, :1] - x0[:, None], rhs[:, 1:]], dim=1)
        wr = band_solve(rhs)
        wf = wr.reshape(wr.shape[0], -1)
        muf = wf + ((wf @ Vt) @ K2.T) @ Pu.T
        return -(h1 + hinv(gt_apply(muf.reshape(-1, Nb, n))))

    return z_step


@register_builder("MPCT", "ADMM", "semiband")
def build_mpct_admm_semiband(sys: dict, param: dict, opt: Options,
                             backend: str = "dense", device="cuda",
                             ingredients: dict | None = None
                             ) -> BatchedSolver:
    """MPCT via ADMM on the semiband (non-extended) parameterisation
    (code_MPCT_ADMM_semiband_C.c:119-1125,
    spcies_MPCT_ADMM_semiband_solver.m) on `device`, with the reference's
    soft-constraint and constrained-output options. `ingredients` replaces
    the offline computation (same keys as mpct_admm_semiband_ingredients,
    its structured arm's for backend='banded'). backend='banded' is the
    O(N)-memory long-horizon path: the two-level Woodbury as stage-local
    operators, the constrained output's C~ applied stage by stage. The
    warm start is init=(z, v, lam)."""
    if backend not in ("dense", "banded"):
        raise ValueError("MPCT/ADMM-semiband has dense and banded backends")
    banded = backend == "banded"
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else mpct_admm_semiband_ingredients(sys, param, opt,
                                               structured=banded))
    dtype = _DTYPES[opt.precision]
    n, m, N, nz, nv = ing["n"], ing["m"], ing["N"], ing["nz"], ing["nv"]
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    soft = ing["soft"]
    con_out = ing["constrained_output"]

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if ing["rho_is_scalar"]:
        rho = dev(ing["rho_scalar"])
        rho_i = dev(1.0 / ing["rho_scalar"])
    else:
        rho = dev(ing["rho_vec"])
        rho_i = dev(1.0 / np.asarray(ing["rho_vec"]))
    LBv, UBv, T, S = (dev(ing[key]) for key in ("LBv", "UBv", "T", "S"))
    soft_mask = torch.as_tensor(np.asarray(ing["soft_mask"], dtype=bool),
                                device=device)
    beta_rho_i = ing["beta"] * rho_i
    sv = nv // (N + 1)

    if banded:
        zs_structured = _make_semiband_structured_z_step(
            ing, dtype, device,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))

        def z_step_lin(dp):
            return zs_structured(dp)

        # C~ is block diagonal with one shared stage map: applied stage by
        # stage, the constrained output stays O(N)
        Smap = dev(ing["stage_map"]) if con_out else None

        def ct_apply(z):
            if not con_out:
                return z
            zt = torch.einsum("bls,ts->blt", z.reshape(-1, N + 1, n + m),
                              Smap)
            return zt.reshape(z.shape[0], -1)

        def ct_t_apply(y):
            if not con_out:
                return y
            ys = torch.einsum("blt,ts->bls", y.reshape(-1, N + 1, sv),
                              Smap)
            return ys.reshape(y.shape[0], -1)
    else:
        M_q, M_b = dev(ing["M_q"]), dev(ing["M_b"])

        def z_step_lin(dp):
            return delta_dot(dp, M_q.T)

        Ct = dev(ing["C_tilde"]) if con_out else None

        def ct_apply(z):
            return z @ Ct.T if con_out else z

        def ct_t_apply(y):
            return y @ Ct if con_out else y

    def proj(y):
        hard = proj_box(y, LBv, UBv)
        if not soft:
            return hard
        return torch.where(soft_mask,
                           _soft_box_prox(y, LBv, UBv, beta_rho_i), hard)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        q = torch.zeros((Bsz, nz), dtype=dtype, device=device)
        q[:, nz - n - m:nz - m] = -(xr @ T.T)
        q[:, nz - m:] = -(ur @ S.T)

        if init is None:
            v0 = torch.zeros((Bsz, nv), dtype=dtype, device=device)
            lam0 = torch.zeros((Bsz, nv), dtype=dtype, device=device)
        else:
            v0, lam0 = (torch.as_tensor(a, dtype=dtype, device=device)
                        for a in init[1:])

        def z_step(pvec):
            if banded:
                return zs_structured(pvec, x0)
            return pvec @ M_q.T + x0 @ M_b.T

        rinf = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
        p0 = q + ct_t_apply(lam0 - rho * v0)
        z1 = z_step(p0)
        state0 = dict(z=z1, z_next=z1, v=v0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            z = state["z_next"]
            v_prev = state["v"]
            lam = state["lam"]
            zt = ct_apply(z)
            v = proj(zt + rho_i * lam)
            lam_new = lam + rho * (zt - v)
            r_p = inf_norm(zt - v)
            r_d = inf_norm(v - v_prev)
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            # delta form: dp = C~'(dlam - rho dv) = C~'(rho(zt - 2v + v_prev))
            dp = ct_t_apply(rho * (zt - 2.0 * v + v_prev))
            z_next = z + z_step_lin(dp)
            return (dict(z=z, z_next=z_next, v=v, lam=lam_new,
                         r_p=r_p, r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "v", "lam")
                   if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        u = state["v"][:, n:n + m]
        return SolveResult(u=u, k=k, e_flag=e_flag,
                           sol=dict(z=state["z"], v=state["v"],
                                    lam=state["lam"], r_p=state["r_p"],
                                    r_d=state["r_d"],
                                    **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype,
                         device=device)
