"""ellipMPC formulation — MPC with an ellipsoidal terminal constraint
(x_N - c)' P (x_N - c) <= r^2 (arXiv:2105.08419).

Port of spcies_tpu/formulations/ellipmpc.py, two solvers:

ADMM ('' submethod) — the terminal penalty is rho*P instead of rho*I, which
makes the v-update's terminal prox an exact P-norm ellipsoid projection
(compute_ellipMPC_ADMM_ingredients.m:86, code_ellipMPC_ADMM_C.c:321-351).
Centre c and radius r are baked at build time. Backends: 'dense' (scalar
or vector rho, on the masked loop), 'banded' (the same loop, its z-step
through the stagewise operators and band-Cholesky solves of
formulations/stagewise.py) and 'fused' (kernels/fused_ellip.py, in P_half
coordinates).

ADMM-soc ('soc' submethod) — the terminal set as a second-order-cone
constraint with one slack scalar; the ellipsoid centre is the runtime
state reference xr and the radius a runtime 4th input r_ellip
(code_ellipMPC_ADMM_soc_C.c:20). The reference's LDL + CSR pipeline is the
equivalent dense affine map aux = M1 q_hat + M2 bh
(spcies_ellipMPC_ADMM_soc_solver.m:198). Backends: 'dense' and 'fused'
(kernels/fused_soc.py).
"""

from __future__ import annotations

import numpy as np
import torch

from spcies_tpu_torch.api import BatchedSolver, resolve_device
from spcies_tpu_torch.config import Options
from spcies_tpu_torch.formulations.base import (register_builder,
                                                get_sys_matrices, get_bounds)
from spcies_tpu_torch.formulations.laxmpc import _DTYPES
from spcies_tpu_torch.utils import linalg
from spcies_tpu_torch.utils.projections import (proj_box, proj_ellipsoid,
                                                proj_soc)
from spcies_tpu_torch.solvers.common import (SolveResult, inf_norm,
                                             hist_sol_entries, delta_dot)
from spcies_tpu_torch.solvers.loop import run_masked_loop


def _sym_sqrtm(P: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root (MATLAB sqrtm on SPD input,
    compute_ellipMPC_ADMM_ingredients.m:84)."""
    w, V = np.linalg.eigh(P)
    return (V * np.sqrt(np.maximum(w, 0.0))) @ V.T


def _tightened_bounds(sys, param, n, m, N, inf_value):
    """Stage bounds with per-stage tightening incBx/incBu
    (compute_ellipMPC_ADMM_ingredients.m:105-139): covers u_0 and stages
    1..N-1; the terminal state has no box (ellipsoid only)."""
    LBx, UBx, LBu, UBu = get_bounds(sys, n, m, inf_value)
    incBx = np.asarray(param.get("incBx", np.zeros((n, N + 1))), float)
    incBu = np.asarray(param.get("incBu", np.zeros((m, N + 1))), float)
    if incBx.ndim == 1:
        incBx = incBx.reshape(n, N + 1)
    if incBu.ndim == 1:
        incBu = incBu.reshape(m, N + 1)
    LB = [LBu]
    UB = [UBu]
    for i in range(1, N):
        LB.append(np.concatenate([LBx + incBx[:, i], LBu + incBu[:, i]]))
        UB.append(np.concatenate([UBx - incBx[:, i], UBu - incBu[:, i]]))
    return np.concatenate(LB), np.concatenate(UB)


def ellipmpc_admm_ingredients(sys: dict, param: dict, opt: Options) -> dict:
    """Offline ingredients (compute_ellipMPC_ADMM_ingredients.m), fp64
    numpy."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    P = np.asarray(param["P"], dtype=float)
    c = np.asarray(param.get("c", np.zeros(n)), dtype=float).ravel()
    r = float(param.get("r", 1.0))
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("ellipMPC/ADMM requires diagonal Q and R "
                         "(compute_ellipMPC_ADMM_ingredients.m:64-66)")
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()
    nz = N * (n + m)

    # rho layout (compute_ellipMPC_ADMM_ingredients.m:68-77): scalar, or a
    # vector of length N(n+m); force_vector_rho expands the scalar to a
    # constant vector. The reference's H = Hz + rho .* blkdiag(I, P) is a
    # ROW scaling, a symmetric penalty only when the terminal n entries of
    # rho are equal: any other vector raises.
    rho_in = np.asarray(opt.solver["rho"], dtype=float)
    force_vec = bool(opt.solver.get("force_vector_rho", False))
    rho_is_scalar = rho_in.ndim == 0 and not force_vec
    rho_vec = (np.full(nz, float(rho_in)) if rho_in.ndim == 0
               else rho_in.ravel().copy())
    if rho_vec.size != nz:
        raise ValueError(f"rho vector must have length {nz}")
    rho_T = float(rho_vec[-1])
    if not np.allclose(rho_vec[nz - n:], rho_T):
        raise ValueError(
            "ellipMPC/ADMM vector rho must be constant over the terminal "
            "block (last n entries): the reference's rho.*blkdiag(I,P) row "
            "scaling (compute_ellipMPC_ADMM_ingredients.m:84-86) gives a "
            "non-symmetric penalty diag(rho_N) P otherwise, and chol(W) "
            "fails")
    rho_s = rho_vec[:nz - n].copy()     # stage entries (diagonal penalty)
    rho = rho_T if rho_is_scalar else None

    P_half = _sym_sqrtm(P)
    Hz = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T)
    Hhat = Hz + linalg.blkdiag(np.diag(rho_s), rho_T * P)
    Hinv = np.linalg.inv(Hhat)
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T
    Alpha, Beta = linalg.band_chol_blocks(W, n, N)

    GH = G @ Hinv
    Winv = np.linalg.inv(W)
    M_q = GH.T @ (Winv @ GH) - Hinv
    M_b = GH.T @ Winv[:, :n]

    LB, UB = _tightened_bounds(sys, param, n, m, N, opt.inf_value)

    return dict(
        n=n, m=m, N=N, nz=nz, A=A, B=B, AB=np.hstack([A, B]),
        Qd=Qd, Rd=Rd, T=T, rho=rho, rho_is_scalar=rho_is_scalar,
        rho_s=rho_s, rho_T=rho_T,
        P=P, P_half=P_half, Pinv_half=np.linalg.inv(P) @ P_half,
        c=c, r=r, M_q=M_q, M_b=M_b,
        Hi_0=np.diag(Hinv)[:m].copy(),
        Hi_mid=(np.diag(Hinv)[m:m + (N - 1) * (n + m)]
                .reshape(N - 1, n + m).copy()),
        Hi_N=Hinv[-n:, -n:].copy(),
        Alpha=Alpha, Beta=Beta, LB=LB, UB=UB,
    )


def _ellipmpc_q_ref(ing, xr, ur, dtype):
    """Linear cost q from the references (spcies_ellipMPC_ADMM_solver.m):
    (-R ur, [-Q xr, -R ur] x (N-1), -T xr)."""
    dev = xr.device
    Qd, Rd, T = (torch.as_tensor(ing[key], dtype=dtype, device=dev)
                 for key in ("Qd", "Rd", "T"))
    qu = -ur * Rd
    mid = torch.cat([-xr * Qd, qu], dim=-1)
    return torch.cat([qu, mid.repeat(1, ing["N"] - 1), -(xr @ T.T)], dim=-1)


@register_builder("ellipMPC", "ADMM")
def build_ellipmpc_admm(sys: dict, param: dict, opt: Options,
                        backend: str = "dense", device="cuda",
                        ingredients: dict | None = None) -> BatchedSolver:
    """Build the ellipMPC-ADMM solver on `device`. `ingredients` replaces
    the offline computation (same keys as ellipmpc_admm_ingredients). The
    warm start is init=(z, v, lam)."""
    if backend not in ("dense", "banded", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else ellipmpc_admm_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N, nz = ing["n"], ing["m"], ing["N"], ing["nz"]
    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_ellip_solve)
        _solve_f = build_fused_ellip_solve(
            ing, opt, dtype, device,
            make_q_ref=lambda xr, ur: _ellipmpc_q_ref(ing, xr, ur,
                                                      torch.float32))
        return BatchedSolver(_solve_f, ing, opt, n=n, m=m, N=N, nz=nz,
                             dtype=dtype, device=device)

    ns = nz - n     # stage entries (the box-constrained part)
    tol = float(opt.solver["tol"])
    k_max = int(opt.solver["k_max"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # rho enters the iteration split by block: a per-entry vector on the
    # stage entries, a scalar on the terminal (P-weighted) block
    if ing["rho_is_scalar"]:
        rho, rho_i = dev(ing["rho_T"]), dev(1.0 / ing["rho_T"])
    else:
        rho, rho_i = dev(ing["rho_s"]), dev(1.0 / np.asarray(ing["rho_s"]))
    rho_T, rho_Ti = dev(ing["rho_T"]), dev(1.0 / ing["rho_T"])
    LB, UB, A, P, P_half, Pinv_half, c = (
        dev(ing[key]) for key in ("LB", "UB", "A", "P", "P_half",
                                  "Pinv_half", "c"))
    r = dev(ing["r"])
    if backend == "banded":
        from spcies_tpu_torch.formulations.stagewise import (
            make_banded_eq_qp)
        eq_qp = make_banded_eq_qp(ing, dtype, terminal=True, device=device)

        def z_first(q_hat, b0):
            rhs_extra = torch.zeros((q_hat.shape[0], N, n), dtype=dtype,
                                    device=device)
            rhs_extra[:, 0] = -b0
            return eq_qp(q_hat, rhs_extra)

        def z_lin(dq):
            return eq_qp(dq, None)
    else:
        M_q, M_b = dev(ing["M_q"]), dev(ing["M_b"])

        def z_first(q_hat, b0):
            return q_hat @ M_q.T + b0 @ M_b.T

        def z_lin(dq):
            return delta_dot(dq, M_q.T)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        b0 = -(x0 @ A.T)
        q_ref = _ellipmpc_q_ref(ing, xr, ur, dtype)
        if init is None:
            zeros = torch.zeros((Bsz, nz), dtype=dtype, device=device)
            v0, lam0 = zeros, zeros
        else:
            v0, lam0 = (dev(a) for a in init[1:])

        def q_hat_of(lam, v):
            qs = q_ref[:, :ns] + lam[:, :ns] - rho * v[:, :ns]
            qT = (q_ref[:, ns:] + lam[:, ns:] @ P_half.T
                  - rho_T * (v[:, ns:] @ P.T))
            return torch.cat([qs, qT], dim=-1)

        rinf = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
        z1 = z_first(q_hat_of(lam0, v0), b0)
        state0 = dict(z=z1, z_next=z1, v=v0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            z = state["z_next"]
            v_prev = state["v"]
            lam = state["lam"]
            # v-update: box on stages, P-norm ellipsoid projection on x_N
            # (spcies_ellipMPC_ADMM_solver.m:179-189)
            vs = proj_box(z[:, :ns] + rho_i * lam[:, :ns], LB, UB)
            yT = z[:, ns:] + rho_Ti * (lam[:, ns:] @ Pinv_half.T)
            vT = proj_ellipsoid(yT, P, c, r)
            v = torch.cat([vs, vT], dim=-1)
            # dual update (:192-193)
            lam_s = lam[:, :ns] + rho * (z[:, :ns] - vs)
            lam_T = lam[:, ns:] + rho_T * ((z[:, ns:] - vT) @ P_half.T)
            lam_new = torch.cat([lam_s, lam_T], dim=-1)
            r_p = inf_norm(z - v)
            r_d = inf_norm(v - v_prev)
            conv = (r_p <= tol) & (r_d <= tol)
            # delta-form next z: dq = rho (z - 2v + v_prev) through
            # blkdiag(diag(rho_s), rho_T P)
            dz = z - 2.0 * v + v_prev
            dq = torch.cat([rho * dz[:, :ns], rho_T * (dz[:, ns:] @ P.T)],
                           dim=-1)
            z_next = z + z_lin(dq)
            return (dict(z=z, z_next=z_next, v=v, lam=lam_new, r_p=r_p,
                         r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "v", "lam") if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        v = state["v"]
        return SolveResult(u=v[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=state["z"], v=v, lam=state["lam"],
                                    r_p=state["r_p"], r_d=state["r_d"],
                                    **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=nz, dtype=dtype,
                         device=device)


# ---------------------------------------------------------------------------
# ADMM-soc
# ---------------------------------------------------------------------------

def ellipmpc_admm_soc_ingredients(sys: dict, param: dict,
                                  opt: Options) -> dict:
    """Offline ingredients (compute_ellipMPC_ADMM_soc_ingredients.m):
    slack-augmented decision vector, SOC rows C, dense M1/M2 maps in place
    of the reference's LDL/CSR pipeline."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    T = np.asarray(param["T"], dtype=float)
    P = np.asarray(param["P"], dtype=float)
    r_default = float(param.get("r", 1.0))
    if not (np.allclose(Q, np.diag(np.diag(Q))) and
            np.allclose(R, np.diag(np.diag(R)))):
        raise ValueError("ellipMPC/ADMM-soc requires diagonal Q and R")
    sigma = float(opt.solver["sigma"])
    rho = float(opt.solver["rho"])
    Qd, Rd = np.diag(Q).copy(), np.diag(R).copy()

    dim = N * (n + m) + 1           # + slack scalar
    n_s = n + 1                     # cone dimension
    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T,
                       np.zeros((1, 1)))
    G = linalg.mpc_equality_matrix(A, B, N)
    G = linalg.blkdiag(G, np.ones((1, 1)))   # slack = r equality row
    n_eq = G.shape[0]

    P_half = _sym_sqrtm(P)
    # cone rows: C z + s = d with s in SOC
    # (compute_ellipMPC_ADMM_soc_ingredients.m:94-97)
    C = np.zeros((n_s, dim))
    C[0, dim - 1] = -1.0
    C[1:, dim - 1 - n:dim - 1] = -P_half

    Hh = linalg.blkdiag(H + sigma * np.eye(dim), rho * np.eye(n_s))
    Gh = np.block([[G, np.zeros((n_eq, n_s))], [C, np.eye(n_s)]])
    Hhi = np.linalg.inv(Hh)
    W = Gh @ Hhi @ Gh.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ Gh.T @ Winv @ Gh @ Hhi - Hhi
    M2 = Hhi @ Gh.T @ Winv

    LB, UB = _tightened_bounds(sys, param, n, m, N, opt.inf_value)
    PhiP = np.linalg.solve(P_half, P)    # P_half^{-1} P

    return dict(
        n=n, m=m, N=N, dim=dim, n_s=n_s, n_eq=n_eq,
        A=A, Qd=Qd, Rd=Rd, T=T, sigma=sigma, rho=rho,
        M1=M1,
        M2_b0=M2[:, :n].copy(),              # -A x0 block of bh
        M2_r=M2[:, n_eq - 1].copy(),         # runtime radius column
        M2_d=M2[:, n_eq + 1:].copy(),        # -PhiP xr block of bh
        PhiP=PhiP, LB=LB, UB=UB, r_default=r_default,
    )


def _soc_q(ing, xr, ur, dtype):
    """Linear cost over [z | slack]: _ellipmpc_q_ref's, then 0."""
    q = _ellipmpc_q_ref(ing, xr, ur, dtype)
    return torch.cat([q, torch.zeros_like(q[:, :1])], dim=-1)


@register_builder("ellipMPC", "ADMM", "soc")
def build_ellipmpc_admm_soc(sys: dict, param: dict, opt: Options,
                            backend: str = "dense", device="cuda",
                            ingredients: dict | None = None
                            ) -> BatchedSolver:
    """Build the ellipMPC-ADMM-soc solver on `device`: inputs (x0, xr, ur
    [, r_ellip]), the runtime radius defaulting to param's r. `ingredients`
    replaces the offline computation (same keys as
    ellipmpc_admm_soc_ingredients). The warm start is
    init=(z, s, lam, mu)."""
    if backend not in ("dense", "fused"):
        raise ValueError("ellipMPC/ADMM-soc has dense and fused backends "
                         "(the KKT is not block-tridiagonal)")
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else ellipmpc_admm_soc_ingredients(sys, param, opt))
    dtype = _DTYPES[opt.precision]
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s = ing["dim"], ing["n_s"]
    io = dict(input_names=("x0", "xr", "ur", "r_ellip"),
              default_inputs=(np.array([ing["r_default"]]),))
    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_soc_solve)
        _solve_f = build_fused_soc_solve(
            ing, opt, dtype, device,
            make_q=lambda xr, ur: _soc_q(ing, xr, ur, torch.float32))
        return BatchedSolver(_solve_f, ing, opt, n=n, m=m, N=N, nz=dim,
                             dtype=dtype, device=device, **io)

    nbox = (N - 1) * (n + m) + m
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    sigma, rho = dev(ing["sigma"]), dev(ing["rho"])
    sigma_i, rho_i = dev(1.0 / ing["sigma"]), dev(1.0 / ing["rho"])
    LB, UB, A, M1, M2_b0, M2_r, M2_d, PhiP = (
        dev(ing[key]) for key in ("LB", "UB", "A", "M1", "M2_b0", "M2_r",
                                  "M2_d", "PhiP"))

    def _solve(x0, xr, ur, r_ellip, init, fixed_iters):
        Bsz = x0.shape[0]
        q = _soc_q(ing, xr, ur, dtype)
        # aux = M1 q_hat + M2 bh, bh = [-A x0; 0...; r; 0; -PhiP xr]
        # (spcies_ellipMPC_ADMM_soc_solver.m:168-199)
        aux_b = ((-(x0 @ A.T)) @ M2_b0.T + r_ellip[:, 0:1] * M2_r
                 + (-(xr @ PhiP.T)) @ M2_d.T)
        if init is None:
            z0 = torch.zeros((Bsz, dim), dtype=dtype, device=device)
            s0 = torch.zeros((Bsz, n_s), dtype=dtype, device=device)
            lam0, mu0 = torch.zeros_like(z0), torch.zeros_like(s0)
        else:
            z0, s0, lam0, mu0 = (dev(a) for a in init)

        aux1 = (torch.cat([q - sigma * z0 + lam0, mu0 - rho * s0], dim=-1)
                @ M1.T + aux_b)
        rinf = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
        state0 = dict(aux=aux1, aux_next=aux1, z=z0, s=s0, lam=lam0,
                      mu=mu0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            aux = state["aux_next"]
            z_hat, s_hat = aux[:, :dim], aux[:, dim:]
            lam, mu = state["lam"], state["mu"]
            z_old, s_old = state["z"], state["s"]
            # primal projections (:203-224): box on stage vars only (x_N
            # and the slack unclipped), SOC on the slack block
            zc = z_hat + sigma_i * lam
            z = torch.cat([proj_box(zc[:, :nbox], LB, UB), zc[:, nbox:]],
                          dim=-1)
            s = proj_soc(s_hat + rho_i * mu)
            lam_new = lam + sigma * (z_hat - z)
            mu_new = mu + rho * (s_hat - s)
            r_p = torch.maximum(inf_norm(z_hat - z), inf_norm(s_hat - s))
            r_d = torch.maximum(inf_norm(z - z_old), inf_norm(s - s_old))
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            # delta form: dq_hat = [sigma (z_hat - 2z + z_old);
            #                       rho (s_hat - 2s + s_old)]
            dq = torch.cat([sigma * (z_hat - 2.0 * z + z_old),
                            rho * (s_hat - 2.0 * s + s_old)], dim=-1)
            aux_next = aux + delta_dot(dq, M1.T)
            return (dict(aux=aux, aux_next=aux_next, z=z, s=s, lam=lam_new,
                         mu=mu_new, r_p=r_p, r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "s", "lam", "mu") if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        z, aux = state["z"], state["aux"]
        return SolveResult(
            u=z[:, :m], k=k, e_flag=e_flag,
            sol=dict(z=z, s=state["s"], z_hat=aux[:, :dim],
                     s_hat=aux[:, dim:], lam=state["lam"], mu=state["mu"],
                     r_p=state["r_p"], r_d=state["r_d"],
                     **hist_sol_entries(hist)))

    return BatchedSolver(_solve, ing, opt, n=n, m=m, N=N, nz=dim,
                         dtype=dtype, device=device, **io)
