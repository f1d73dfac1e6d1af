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
           z = M_q p + M_b x0, on the masked loop of solvers/loop.py.

The banded backends of ADMM-cs and ADMM-semiband and ADMM-cs's
time-varying mode are not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

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


@register_builder("MPCT", "ADMM", "cs")
def build_mpct_admm_cs(sys: dict, param: dict, opt: Options,
                       backend: str = "dense", device="cuda",
                       ingredients: dict | None = None) -> BatchedSolver:
    """MPCT via ADMM on the extended (x_i, x_s, u_i, u_s) state space
    (code_MPCT_ADMM_cs_C.c:94-218, spcies_MPCT_ADMM_cs_solver.m) on
    `device`. `ingredients` replaces the offline computation (same keys as
    mpct_admm_cs_ingredients)."""
    if backend not in ("dense", "fused", "banded"):
        raise ValueError("MPCT/ADMM-cs has dense, banded and fused backends")
    if opt.time_varying:
        raise NotImplementedError(
            "time-varying MPCT-ADMM-cs is not ported to spcies_tpu_torch "
            "yet (ROADMAP queue 1 item 8)")
    if backend == "banded":
        raise NotImplementedError(
            "backend='banded' is not ported to spcies_tpu_torch yet "
            "(ROADMAP queue 1 item 8)")
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else mpct_admm_cs_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    def q_ref_of(T, S):
        """The per-stage linear cost [0; -(T/N) xr; 0; -(S/N) ur], tiled
        (spcies_MPCT_ADMM_cs_solver.m:172 with vars.Tz = -T/N)."""
        def q_ref(x0, xr, ur):
            qstage = torch.cat(
                [torch.zeros_like(x0), -(xr @ T.T) / N,
                 torch.zeros_like(ur), -(ur @ S.T) / N], dim=-1)
            return qstage.repeat(1, N)
        return q_ref

    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_box_admm_solve)
        f32 = torch.float32
        M_b32 = dev(ing["M_b"], f32)
        _solve_f = build_fused_box_admm_solve(
            ing, opt, dtype, device,
            make_q_ref=q_ref_of(dev(ing["T"], f32), dev(ing["S"], f32)),
            make_aux_b=lambda x0, xr, ur: x0 @ M_b32.T,
            u_start=2 * n, lb_key="LB", ub_key="UB")
        return BatchedSolver(_solve_f, ing, opt, n=n, m=m, N=N, nz=nz,
                             dtype=dtype, device=device)

    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])
    rho = (dev(ing["rho_scalar"]) if ing["rho_is_scalar"]
           else dev(ing["rho_vec"]))
    rho_i = (dev(1.0 / ing["rho_scalar"]) if ing["rho_is_scalar"]
             else dev(ing["rho_inv_vec"]))
    LB, UB, M_q, M_b = (dev(ing[key]) for key in ("LB", "UB", "M_q", "M_b"))
    q_ref_fn = q_ref_of(dev(ing["T"]), dev(ing["S"]))

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
                                   opt: Options) -> dict:
    """Offline ingredients (compute_MPCT_ADMM_semiband_ingredients.m), the
    dense arm: the reference's two-level Woodbury (banded Gamma_hat plus a
    rank-2(n+m) correction, ECC'24) avoids dense factorisation on embedded
    CPUs; here the same KKT solve collapses into the dense affine map
    z = M_q p + M_b x0, algebraically identical and one matrix product
    online. O(N^2) memory."""
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
    # (:119-133)
    QR = linalg.blkdiag(Q, R)
    H = linalg.blkdiag(*([QR] * N), linalg.blkdiag(N * Q + T, N * R + S))
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
    )


@register_builder("MPCT", "ADMM", "semiband")
def build_mpct_admm_semiband(sys: dict, param: dict, opt: Options,
                             backend: str = "dense", device="cuda",
                             ingredients: dict | None = None
                             ) -> BatchedSolver:
    """MPCT via ADMM on the semiband (non-extended) parameterisation
    (code_MPCT_ADMM_semiband_C.c:119-1125,
    spcies_MPCT_ADMM_semiband_solver.m) on `device`, with the reference's
    soft-constraint and constrained-output options. `ingredients` replaces
    the offline computation (same keys as mpct_admm_semiband_ingredients).
    The warm start is init=(z, v, lam)."""
    if backend not in ("dense", "banded"):
        raise ValueError("MPCT/ADMM-semiband has dense and banded backends")
    if backend == "banded":
        raise NotImplementedError(
            "backend='banded' is not ported to spcies_tpu_torch yet "
            "(ROADMAP queue 1 item 8)")
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else mpct_admm_semiband_ingredients(sys, param, opt))
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
    LBv, UBv, T, S, M_q, M_b = (dev(ing[key]) for key in (
        "LBv", "UBv", "T", "S", "M_q", "M_b"))
    soft_mask = torch.as_tensor(np.asarray(ing["soft_mask"], dtype=bool),
                                device=device)
    beta_rho_i = ing["beta"] * rho_i
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
            z_next = z + delta_dot(dp, M_q.T)
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
