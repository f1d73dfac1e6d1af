"""HMPC formulation — harmonic MPC (arXiv:2202.06629) — and ellipHMPC.

Port of spcies_tpu/formulations/hmpc.py. The terminal artificial reference
is a sinusoid parameterized by offset/sine/cosine components with base
frequency w: the decision vector is z = (u_0, x_1, u_1, ..., x_{N-1},
u_{N-1}, xe, xs, xc, ue, us, uc). The harmonic Hessian blocks come from
sin/cos sums over the horizon, equality constraints couple the last
predicted state to the harmonic at phase w*N and impose the 3n
harmonic-equilibrium conditions, and the constraint sets are per-stage
boxes plus per-output 3-dimensional cone sets: "diamond" D-sets (a box on
the harmonic amplitude, use_soc=False) or pairs of shifted SOCs
(use_soc=True). Reference: compute_HMPC_ADMM_ingredients.m (shared offline
math), spcies_HMPC_ADMM_solver.m / code_HMPC_ADMM_C.c (single-split
"reduced" ADMM), spcies_HMPC_{ADMM,SADMM}_split_solver.m /
code_HMPC_ADMM_split_C.c (two-block split (z,s) vs (zhat,shat); SADMM =
symmetric half-step duals scaled by alpha), code_ellipHMPC_ADMM_C.c
(coupled outputs, decomposed references, sigma-tightened D-sets).

The reference's permuted-LDL sparse path is replaced by the dense M1/M2
affine maps (its own non-sparse path, spcies_HMPC_ADMM_solver.m:135).
Backends: 'dense' (the masked loop), 'fused' (kernels/fused_hmpc.py for
the single-split solvers, kernels/fused_split.py for the split ones) and,
for HMPC-ADMM and the split pair, 'banded': the O(N)-memory arrowhead-
Woodbury structured KKT (`_make_hmpc_split_structured_kkt`) on the
band-Cholesky solve of kernels/band_chol.py, on the same masked loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spcies_tpu_torch.api import BatchedSolver, resolve_device
from spcies_tpu_torch.config import Options
from spcies_tpu_torch.formulations.base import (register_builder,
                                                get_sys_matrices, get_bounds)
from spcies_tpu_torch.formulations.laxmpc import _DTYPES
from spcies_tpu_torch.utils import linalg
from spcies_tpu_torch.utils.projections import (proj_box, proj_diamond,
                                                proj_soc)
from spcies_tpu_torch.solvers.common import (SolveResult, inf_norm,
                                             hist_sol_entries, delta_dot,
                                             delta_dot_op)
from spcies_tpu_torch.solvers.loop import run_masked_loop

ELLIP_INPUTS = ("x0", "xre", "xrs", "xrc", "ure", "urs", "urc")


def harmonic_hessian(Q, R, Te, Th, Se, Sh, w, N, n, m):
    """The harmonic Hessian blocks H11/H12/H13/H22/H23/H33
    (compute_HMPC_ADMM_ingredients.m:83-137)."""
    j = np.arange(N)
    s_j = np.sin(w * j)
    c_j = np.cos(w * j)
    s_sum, c_sum = s_j.sum(), c_j.sum()
    s2_sum, c2_sum = (s_j ** 2).sum(), (c_j ** 2).sum()
    sc_sum = (s_j * c_j).sum()

    H11 = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)))
    ns = (N - 1) * (n + m) + m
    H12 = np.zeros((ns, 3 * n))
    for jj in range(N - 1):
        r = jj * (n + m) + m
        H12[r:r + n] = np.hstack([-Q, -s_j[jj + 1] * Q, -c_j[jj + 1] * Q])
    H13 = np.zeros((ns, 3 * m))
    for jj in range(N):
        r = jj * (n + m)
        H13[r:r + m] = np.hstack([-R, -s_j[jj] * R, -c_j[jj] * R])
    H22 = np.block([[Te + N * Q, s_sum * Q, c_sum * Q],
                    [s_sum * Q, Th + s2_sum * Q, sc_sum * Q],
                    [c_sum * Q, sc_sum * Q, Th + c2_sum * Q]])
    H33 = np.block([[Se + N * R, s_sum * R, c_sum * R],
                    [s_sum * R, Sh + s2_sum * R, sc_sum * R],
                    [c_sum * R, sc_sum * R, Sh + c2_sum * R]])
    H23 = np.zeros((3 * n, 3 * m))
    return np.block([[H11, H12, H13],
                     [H12.T, H22, H23],
                     [H13.T, H23.T, H33]])


def harmonic_equality_matrix(A, B, w, N):
    """G: stage dynamics, terminal harmonic coupling at phase w*N, and the
    3n harmonic-equilibrium rows (compute_HMPC_ADMM_ingredients.m:140-152).
    Returns (G, n_eq); beq is zero except beq[:n] = -A x0."""
    n, m = A.shape[0], B.shape[1]
    ns = (N - 1) * (n + m) + m
    dim = ns + 3 * (n + m)
    G = np.zeros((N * n + 3 * n, dim))
    # row 0: B u0 - x1 = -A x0
    G[:n, :m] = B
    G[:n, m:m + n] = -np.eye(n)
    # rows l = 1..N-1 over stage (x_l, u_l); row N-1 couples to the harmonic
    for l in range(1, N):
        r = l * n
        c = m + (l - 1) * (n + m)
        G[r:r + n, c:c + n] = A
        G[r:r + n, c + n:c + n + m] = B
        if l < N - 1:
            G[r:r + n, c + n + m:c + 2 * n + m] = -np.eye(n)
    # terminal: A x_{N-1} + B u_{N-1} = xe + sin(wN) xs + cos(wN) xc
    r = (N - 1) * n
    G[r:r + n, ns:ns + n] = -np.eye(n)
    G[r:r + n, ns + n:ns + 2 * n] = -np.sin(w * N) * np.eye(n)
    G[r:r + n, ns + 2 * n:ns + 3 * n] = -np.cos(w * N) * np.eye(n)
    # harmonic equilibrium (A - I, A - cos(w) I +- sin(w) I pattern)
    cw, sw = np.cos(w), np.sin(w)
    r = N * n
    he = ns
    hu = ns + 3 * n
    G[r:r + n, he:he + n] = A - np.eye(n)
    G[r:r + n, hu:hu + m] = B
    G[r + n:r + 2 * n, he + n:he + 2 * n] = A - cw * np.eye(n)
    G[r + n:r + 2 * n, he + 2 * n:he + 3 * n] = sw * np.eye(n)
    G[r + n:r + 2 * n, hu + m:hu + 2 * m] = B
    G[r + 2 * n:r + 3 * n, he + n:he + 2 * n] = -sw * np.eye(n)
    G[r + 2 * n:r + 3 * n, he + 2 * n:he + 3 * n] = A - cw * np.eye(n)
    G[r + 2 * n:r + 3 * n, hu + 2 * m:hu + 3 * m] = B
    return G, G.shape[0]


def _soc_cone_rows(E, F, LBy, UBy, n, m):
    """C_aux rows + d for the shifted-SOC harmonic constraints: per output
    j, a (UB, LB) pair of 3-row cones (compute_HMPC_ADMM_ingredients.m
    use_soc branch)."""
    n_y = E.shape[0]
    rows = []
    dsoc = []
    for j in range(n_y):
        Ej, Fj = E[j:j + 1], F[j:j + 1]
        Eub = linalg.blkdiag(Ej, -Ej, -Ej)
        Elb = linalg.blkdiag(-Ej, -Ej, -Ej)
        Fub = linalg.blkdiag(Fj, -Fj, -Fj)
        Flb = linalg.blkdiag(-Fj, -Fj, -Fj)
        rows.append(np.hstack([Eub, Fub]))
        rows.append(np.hstack([Elb, Flb]))
        dsoc.extend([UBy[j], 0.0, 0.0, -LBy[j], 0.0, 0.0])
    return np.vstack(rows), np.asarray(dsoc), 2 * n_y


def _diamond_cone_rows(E, F, n, m):
    """C_aux for the D-set (diamond) harmonic constraints: per output j,
    kron(I_3, -E_j) | kron(I_3, -F_j)."""
    n_y = E.shape[0]
    rows = []
    for j in range(n_y):
        rows.append(np.hstack([linalg.blkdiag(*([-E[j:j + 1]] * 3)),
                               linalg.blkdiag(*([-F[j:j + 1]] * 3))]))
    return np.vstack(rows), np.zeros(3 * n_y), n_y


def hmpc_common_ingredients(sys: dict, param: dict, opt: Options,
                            split: bool) -> dict:
    """Offline math shared by the single and split HMPC solvers, fp64
    numpy (the keys of the JAX package's `hmpc_common_ingredients`)."""
    A, B, n, m = get_sys_matrices(sys)
    N = int(param["N"])
    w = float(param["w"])
    Q = np.asarray(param["Q"], dtype=float)
    R = np.asarray(param["R"], dtype=float)
    Te = np.asarray(param["Te"], dtype=float)
    Th = np.asarray(param["Th"], dtype=float)
    Se = np.asarray(param["Se"], dtype=float)
    Sh = np.asarray(param["Sh"], dtype=float)
    ns = (N - 1) * (n + m) + m     # stage part of z
    dim = ns + 3 * (n + m)

    if opt.solver.get("sparse", False):
        # The reference's sparse mode is a permuted LDL of the KKT
        # (compute_HMPC_ADMM_ingredients.m:241-250,
        # code_HMPC_ADMM_split_C.c:192-211), a CPU-cache optimization. The
        # dense M1/M2 maps here are algebraically identical (the
        # reference's own NON_SPARSE path); accepting sparse=True silently
        # would misrepresent what runs.
        raise ValueError(
            "HMPC sparse=True (permuted-LDL KKT) is not supported: the "
            "engine always uses the dense M1/M2 KKT maps, which are "
            "algebraically identical (reference NON_SPARSE path). "
            "Use sparse=False (default).")
    box_constraints = opt.solver.get("box_constraints", None)
    if box_constraints is None or box_constraints == []:
        # auto-detect (cons_HMPC_ADMM_C.m:57-63)
        box_constraints = "E" not in sys
    use_soc = bool(opt.solver.get("use_soc", False))

    if box_constraints:
        E = np.vstack([np.eye(n), np.zeros((m, n))])
        F = np.vstack([np.zeros((n, m)), np.eye(m)])
        LBx, UBx, LBu, UBu = get_bounds(sys, n, m, opt.inf_value)
        LBy = np.concatenate([LBx, LBu])
        UBy = np.concatenate([UBx, UBu])
    else:
        E = np.asarray(sys["E"], dtype=float)
        F = np.asarray(sys["F"], dtype=float)
        LBy = np.asarray(sys["LBy"], dtype=float).ravel()
        UBy = np.asarray(sys["UBy"], dtype=float).ravel()
    n_y = E.shape[0]

    H = harmonic_hessian(Q, R, Te, Th, Se, Sh, w, N, n, m)
    G, n_eq = harmonic_equality_matrix(A, B, w, N)

    if use_soc:
        C_aux, dsoc, n_soc = _soc_cone_rows(E, F, LBy, UBy, n, m)
    else:
        C_aux, dsoc, n_soc = _diamond_cone_rows(E, F, n, m)

    if box_constraints:
        # (u_0, (x, u) x N-1)
        stage_LB = np.concatenate([LBy[n:]] + [LBy] * (N - 1))
        stage_UB = np.concatenate([UBy[n:]] + [UBy] * (N - 1))
        if split:
            C = np.hstack([np.zeros((C_aux.shape[0], dim - 3 * (n + m))),
                           C_aux])
            d = dsoc
            n_box = 0
        else:
            C = linalg.blkdiag(-np.eye(m),
                               *([-np.eye(n + m)] * (N - 1)), C_aux)
            d = np.concatenate([np.zeros(ns), dsoc])
            n_box = ns
        box_LB, box_UB = stage_LB, stage_UB
    else:
        Cstage = linalg.blkdiag(-F, *([np.hstack([-E, -F])] * (N - 1)))
        C = linalg.blkdiag(Cstage, C_aux)
        d = np.concatenate([np.zeros(N * n_y), dsoc])
        n_box = N * n_y
        box_LB = np.tile(LBy, N)
        box_UB = np.tile(UBy, N)
        stage_LB = stage_UB = None
    n_s = C.shape[0]

    return dict(
        n=n, m=m, N=N, n_y=n_y, ns=ns, dim=dim, n_eq=n_eq, n_s=n_s,
        n_box=n_box, n_soc=n_soc, A=A, B=B, Q=Q, Te=Te, Se=Se, Th=Th,
        Sh=Sh,
        H=H, G=G, C=C, d=d,
        box_constraints=box_constraints, use_soc=use_soc,
        box_LB=box_LB, box_UB=box_UB,
        stage_LB=stage_LB, stage_UB=stage_UB,
        LBy=LBy, UBy=UBy,
    )


def single_split_kkt(ing, rho_f: float):
    """Dense KKT maps (M1, M2[:, :n]) of the single-split solvers, fp64
    (compute_HMPC_ADMM_ingredients.m:252-257)."""
    Hh = ing["H"] + rho_f * (ing["C"].T @ ing["C"])
    Hhi = np.linalg.inv(Hh)
    G = ing["G"]
    W = G @ Hhi @ G.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ G.T @ Winv @ G @ Hhi - Hhi
    M2 = (Hhi @ G.T @ Winv)[:, :ing["n"]]
    return M1, M2


def split_kkt(ing, rho_f: float, sigma_f: float):
    """Dense KKT maps (M1, M2) over (z, s) of the split solvers, fp64
    (compute_HMPC_ADMM_split_ingredients.m:219-240)."""
    dim, n_s, n_eq = ing["dim"], ing["n_s"], ing["n_eq"]
    Hh = linalg.blkdiag(ing["H"] + sigma_f * np.eye(dim),
                        rho_f * np.eye(n_s))
    Gh = np.block([[ing["G"], np.zeros((n_eq, n_s))],
                   [ing["C"], np.eye(n_s)]])
    Hhi = np.linalg.inv(Hh)
    W = Gh @ Hhi @ Gh.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ Gh.T @ Winv @ Gh @ Hhi - Hhi
    M2 = Hhi @ Gh.T @ Winv
    return M1, M2


def hmpc_q_maker(ing, dtype, device):
    """make_q(x0, xr, ur) -> q = -[0...; Te xr + Q x0; 0_n; Q x0; Se ur;
    0_{2m}].

    The Q x0 terms on the xe and xc blocks are the linear part of the fixed
    j=0 stage cost ||x_0 - (xe + cos(0) xc)||_Q^2, present in the
    authoritative generated C (code_HMPC_ADMM_C.c:92-101,
    code_HMPC_ADMM_split_C.c:117-122, consistent with H22's N*Q term) but
    missing from the reference's MATLAB mirror solvers
    (spcies_HMPC_ADMM_solver.m:116), an upstream mirror bug not
    reproduced here."""
    n, m, ns = ing["n"], ing["m"], ing["ns"]
    Q, Te, Se = (torch.as_tensor(ing[key], dtype=dtype, device=device)
                 for key in ("Q", "Te", "Se"))

    def make_q(x0, xr, ur):
        B = xr.shape[0]
        qx0 = x0 @ Q.T
        zeros = dict(dtype=dtype, device=device)
        return torch.cat(
            [torch.zeros((B, ns), **zeros), -(xr @ Te.T) - qx0,
             torch.zeros((B, n), **zeros), -qx0, -(ur @ Se.T),
             torch.zeros((B, 2 * m), **zeros)], dim=-1)
    return make_q


def elliphmpc_q_maker(ing, dtype, device):
    """make_q(x0, xre, xrs, xrc, ure, urs, urc) for ellipHMPC's decomposed
    harmonic references (code_ellipHMPC_ADMM_C.c:100-130)."""
    ns = ing["ns"]
    Q, Te, Th, Se, Sh = (torch.as_tensor(ing[key], dtype=dtype,
                                         device=device)
                         for key in ("Q", "Te", "Th", "Se", "Sh"))

    def make_q(x0, xre, xrs, xrc, ure, urs, urc):
        qx0 = x0 @ Q.T
        return torch.cat(
            [torch.zeros((x0.shape[0], ns), dtype=dtype, device=device),
             -(xre @ Te.T) - qx0, -(xrs @ Th.T), -(xrc @ Th.T) - qx0,
             -(ure @ Se.T), -(urs @ Sh.T), -(urc @ Sh.T)], dim=-1)
    return make_q


def _make_cone_proj(ing, dtype, device, LBy=None, UBy=None):
    """Batched projection of the cone tail of s: [B, n_cones*3] -> same,
    SOC (proj_SOC3 snippet) or diamond (proj_D) per cone; LBy/UBy override
    the D-set bounds."""
    if ing["use_soc"]:
        n_cones = ing["n_soc"]

        def cone_proj(tail):
            return proj_soc(tail.reshape(-1, n_cones, 3)).reshape(tail.shape)
        return cone_proj
    n_y = ing["n_y"]
    lby, uby = (torch.as_tensor(ing[key] if v is None else v, dtype=dtype,
                                device=device)[None, :]
                for key, v in (("LBy", LBy), ("UBy", UBy)))

    def cone_proj(tail):
        return proj_diamond(tail.reshape(-1, n_y, 3), lby,
                            uby).reshape(tail.shape)
    return cone_proj


def _dense_single_kkt(ing, dtype, device, M1_np, M2_np):
    """The single-split dense KKT maps: (kkt_full(q_hat, x0),
    kkt_lin(dq)) through M1 and M2[:, :n] (the beq = -A x0 rows)."""
    M1, M2, A = (torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (M1_np, M2_np, ing["A"]))

    def kkt_full(q_hat, x0):
        return q_hat @ M1.T + (-(x0 @ A.T)) @ M2.T

    def kkt_lin(dq):
        return delta_dot(dq, M1.T)
    return kkt_full, kkt_lin


def _single_split_solve(ing, opt, dtype, device, kkt_full, kkt_lin, make_q,
                        LBy=None, UBy=None):
    """The single-split engine of HMPC-ADMM and ellipHMPC-ADMM on the
    masked loop, over the KKT maps of either backend (dense:
    `_dense_single_kkt`; banded: `_make_hmpc_split_structured_kkt` with
    split=False): `(*inputs, init, fixed_iters) -> SolveResult`, with x0
    the first input. init is (z, s, lam)."""
    n_s, n_box = ing["n_s"], ing["n_box"]
    m = ing["m"]
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    rho_f = float(opt.solver["rho"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rho, rho_i = dev(rho_f), dev(1.0 / rho_f)
    C, d, LB, UB = (dev(a) for a in (ing["C"], ing["d"], ing["box_LB"],
                                     ing["box_UB"]))
    cone_proj = _make_cone_proj(ing, dtype, device, LBy, UBy)

    def proj_s(y):
        return torch.cat([proj_box(y[:, :n_box], LB, UB),
                          cone_proj(y[:, n_box:])], dim=-1)

    def _solve(*args):
        *inputs, init, fixed_iters = args
        x0 = inputs[0]
        Bsz = x0.shape[0]
        q = make_q(*inputs)
        if init is None:
            s0 = torch.zeros((Bsz, n_s), dtype=dtype, device=device)
            lam0 = torch.zeros_like(s0)
        else:
            s0, lam0 = (dev(a) for a in init[1:])
        # the first z-solve through the full affine map
        z1 = kkt_full(q + (rho * (s0 - d) + lam0) @ C, x0)
        rinf = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
        state0 = dict(z=z1, z_next=z1, s=s0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            z = state["z_next"]
            s_old = state["s"]
            lam = state["lam"]
            Czd = z @ C.T - d
            s = proj_s(-Czd - rho_i * lam)
            resid = Czd + s
            lam_new = lam + rho * resid
            r_p = inf_norm(resid)
            r_d = inf_norm(s - s_old)
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            # delta form: dq_hat = C'(rho ds + dlam); both terms -> 0
            dq = delta_dot(rho * (s - s_old) + rho * resid, C)
            z_next = z + delta_dot_op(kkt_lin, dq)
            return (dict(z=z, z_next=z_next, s=s, lam=lam_new, r_p=r_p,
                         r_d=r_d), conv)

        if opt.debug:
            state, k, e_flag, hist = run_masked_loop(
                body, state0, k_max, Bsz, fixed_iters=fixed_iters,
                history_keys=("r_p", "r_d")
                + (("z", "s", "lam") if int(opt.debug) >= 2 else ()))
        else:
            state, k, e_flag = run_masked_loop(body, state0, k_max, Bsz,
                                               fixed_iters=fixed_iters)
            hist = None
        z = state["z"]
        return SolveResult(u=z[:, :m], k=k, e_flag=e_flag,
                           sol=dict(z=z, s=state["s"], lam=state["lam"],
                                    r_p=state["r_p"], r_d=state["r_d"],
                                    **hist_sol_entries(hist)))
    return _solve


def _make_hmpc_split_structured_kkt(ing, sigma_f, rho_f, dtype, device,
                                    split: bool = True,
                                    parallel_scan: bool = False):
    """O(N)-memory KKT maps of the HMPC solvers, the harmonic analogue of
    MPCT-semiband's two-level structure (mpct._make_semiband_structured_
    z_step). Port of spcies_tpu/formulations/hmpc.py
    `_make_hmpc_split_structured_kkt`.

    split=True: the two-block split KKT over (z, s), Hz = H + sigma I,
    Gh = [G 0; C I] (code_HMPC_ADMM_split_C.c); returns
    (kkt_full(qz, qs, x0), kkt_lin(dqz, dqs)), each giving (aux_z, aux_s).
    split=False: the single-split ("reduced") KKT, Hz = H + rho C'C,
    Gh = G (code_HMPC_ADMM_C.c); in box mode C'C = blkdiag(I_ns,
    Caux'Caux), so the arrowhead is the same: the stage blocks shift by
    rho I and the harmonic block by rho Caux'Caux. Returns
    (kkt_full(q_hat, x0), kkt_lin(dq)).

    Hz is an arrowhead: Hz = Gamma + Us Vs' with Gamma block-diagonal
    (the stage cost blocks and the small harmonic block Hc) and Us Vs' the
    rank-2r stage <-> harmonic coupling (r = 3(n+m), the H12/H13 border of
    harmonic_hessian). With the level-1 Woodbury Hz^-1 = Gamma^-1 -
    Gu K1 Gv', the dual system Gt = Gh Gamma^-1 Gh' is block-tridiagonal
    over the N dynamics rows plus a dense O(1) tail (the 3n equilibrium
    rows, and the n_s cone rows when split, which touch only the harmonic
    block), so W = Gt - Ut K1 Vt' solves as band solve + tail Schur
    complement + level-2 Woodbury. Offline, once a build, in fp64 numpy
    (the dense Gamma^-1 and Gt are offline temporaries); online every
    operation is stage-local and nothing O(N^2) is on the device. The
    maps compute aux = Hh^-1 Gh' W^-1 (Gh Hh^-1 q + bh) - Hh^-1 q, the
    dense path's (M1, M2) action. The band solve is
    kernels/band_chol.py `BandSolve` (the scan with parallel_scan), whose
    products of the fixed blocks are formed once, here. Box constraints
    only, and N >= 3 (ValueError otherwise, as the JAX package)."""
    from spcies_tpu_torch.kernels.band_chol import BandSolve
    n, m, N = ing["n"], ing["m"], ing["N"]
    ns, dim, n_eq, n_s = ing["ns"], ing["dim"], ing["n_eq"], ing["n_s"]
    if not ing["box_constraints"]:
        raise ValueError(
            "the banded HMPC split backend supports box constraints only "
            "(coupled-output cone rows are stage-local and keep the dense "
            "backend); use backend='dense'")
    if N < 3:
        raise ValueError("the banded HMPC backend requires N >= 3")
    nm = n + m
    r = 3 * nm
    H, G, C = (np.asarray(ing[key], dtype=float) for key in ("H", "G", "C"))

    # --- offline: level-1 arrowhead Woodbury ---------------------------
    if split:
        # Hz = H + sigma I
        D0 = H[:m, :m] + sigma_f * np.eye(m)
        Dj = H[m:m + nm, m:m + nm] + sigma_f * np.eye(nm)  # stages 1..N-1
        Hc = H[ns:, ns:] + sigma_f * np.eye(r)
    else:
        # Hz = H + rho C'C, box mode: C'C = blkdiag(I_ns, Caux'Caux)
        Caux_np = C[ing["n_box"]:, ns:]
        D0 = H[:m, :m] + rho_f * np.eye(m)
        Dj = H[m:m + nm, m:m + nm] + rho_f * np.eye(nm)
        Hc = H[ns:, ns:] + rho_f * (Caux_np.T @ Caux_np)
    D0i = np.linalg.inv(D0)
    Dji = np.linalg.inv(Dj)
    Hci = np.linalg.inv(Hc)
    Uc = H[:ns, ns:]                            # the stage<->harmonic border
    Us = np.zeros((dim, 2 * r))
    Us[:ns, r:] = Uc
    Us[ns:, :r] = np.eye(r)
    Vs = np.zeros((dim, 2 * r))
    Vs[:ns, :r] = Uc
    Vs[ns:, r:] = np.eye(r)
    Gzi = linalg.blkdiag(D0i, *([Dji] * (N - 1)), Hci)  # offline temporary
    Gu_np = Gzi @ Us
    Gv_np = Gzi @ Vs
    K1_np = np.linalg.inv(np.eye(2 * r) + Vs.T @ Gu_np)

    # --- offline: banded + tail dual system ----------------------------
    Ghz = np.vstack([G, C]) if split else G
    Gt = Ghz @ Gzi @ Ghz.T
    if split:
        Gt[n_eq:, n_eq:] += (1.0 / rho_f) * np.eye(n_s)
    Nn = N * n
    nt = Ghz.shape[0] - Nn                  # 3n (+ n_s cone rows if split)
    Wb = Gt[:Nn, :Nn]
    Pfull = Gt[:Nn, Nn:]
    Wt = Gt[Nn:, Nn:]
    # the structure the solve relies on: the tail couples to the band only
    # through the last dynamics row
    if np.abs(Pfull[:Nn - n]).max() >= 1e-9 * max(1.0, np.abs(Gt).max()):
        raise ValueError("the HMPC dual system's tail couples to more than "
                         "the last dynamics row; use backend='dense'")
    Wd = np.stack([Wb[k * n:(k + 1) * n, k * n:(k + 1) * n]
                   for k in range(N)])
    Wu = np.stack([Wb[k * n:(k + 1) * n, (k + 1) * n:(k + 2) * n]
                   for k in range(N - 1)])
    Alpha_np, BetaInv_np = linalg.band_chol_blocks_tridiag(Wd, Wu)
    Fp_np = np.linalg.solve(Wb, Pfull)                 # [Nn, nt], O(N) memory
    Sti_np = np.linalg.inv(Wt - Pfull.T @ Fp_np)
    # level-2 Woodbury: W = Gt - Ut K1 Vt'
    Ut_np = Ghz @ Gu_np
    Vt_np = Ghz @ Gv_np
    Pu_np = np.linalg.solve(Gt, Ut_np)
    K2_np = np.linalg.inv(np.linalg.inv(K1_np) - Vt_np.T @ Pu_np)

    # --- online constants ----------------------------------------------
    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    band_solve = BandSolve(torch.as_tensor(Alpha_np),
                           torch.as_tensor(BetaInv_np), scan=parallel_scan,
                           dtype=dtype, device=device)
    D0i_t, Dji_t, Hci_t, Gu, A_, B_ = (dev(a) for a in (
        D0i, Dji, Hci, Gu_np, ing["A"], ing["B"]))
    GvK1t = dev(Gv_np @ K1_np.T)                        # K1 folded into Gv
    Th_ = dev(G[(N - 1) * n:Nn, ns:])          # terminal harmonic coefs
    Eqh = dev(G[Nn:, ns:])                              # equilibrium rows
    Caux = dev(C[:, dim - r:])                          # cone rows (harmonic)
    d_t, Fp, Sti, Vt = (dev(a) for a in (ing["d"], Fp_np, Sti_np, Vt_np))
    # row-vector form: (g @ Vt) @ (Pu K2).T = g Vt K2' Pu', the operator
    # Gt^-1 Ut K2 Vt' Gt^-1 (K2 is not symmetric: Pu @ K2.T would be wrong)
    PuK2t = dev(Pu_np @ K2_np)
    rho_i = 1.0 / rho_f

    def hz_inv(qz):
        """Hz^-1 qz: stage-local Gamma^-1 and the rank-2r correction."""
        u0 = qz[:, :m] @ D0i_t
        st = torch.einsum("bls,ts->blt",
                          qz[:, m:ns].reshape(-1, N - 1, nm), Dji_t)
        hm = qz[:, ns:] @ Hci_t
        g = torch.cat([u0, st.reshape(qz.shape[0], -1), hm], dim=-1)
        return g - (qz @ GvK1t) @ Gu.T

    def gh_apply(hz, hs):
        """Gh (hz[, hs]) -> (band rows [B, N, n], tail [B, nt]); split:
        Gh = [G 0; C I], single: Gh = G (hs is None)."""
        u0 = hz[:, :m]
        st = hz[:, m:ns].reshape(-1, N - 1, nm)
        hm = hz[:, ns:]
        x, u = st[..., :n], st[..., n:]
        r0 = u0 @ B_.T - x[:, 0]
        rl = x[:, :N - 2] @ A_.T + u[:, :N - 2] @ B_.T - x[:, 1:]
        rN1 = x[:, N - 2] @ A_.T + u[:, N - 2] @ B_.T + hm @ Th_.T
        rb = torch.cat([r0[:, None], rl, rN1[:, None]], dim=1)
        if split:
            rt = torch.cat([hm @ Eqh.T, hm @ Caux.T + hs], dim=-1)
        else:
            rt = hm @ Eqh.T
        return rb, rt

    def ght_apply(wb, wt):
        """Gh' (wb, wt) -> z rows [B, dim] (and s rows [B, n_s] if
        split)."""
        weq = wt[:, :3 * n]
        u0 = wb[:, 0] @ B_
        xj = torch.einsum("blj,ji->bli", wb[:, 1:], A_) - wb[:, :N - 1]
        uj = torch.einsum("blj,ji->bli", wb[:, 1:], B_)
        hm = wb[:, N - 1] @ Th_ + weq @ Eqh
        if split:
            wcone = wt[:, 3 * n:]
            hm = hm + wcone @ Caux
        st = torch.cat([xj, uj], dim=-1).reshape(wb.shape[0], -1)
        gz = torch.cat([u0, st, hm], dim=-1)
        return (gz, wcone) if split else gz

    def w_solve(rb, rt):
        """W^-1 over (band, tail): band solve, tail Schur, level 2."""
        Bsz = rb.shape[0]
        u1 = band_solve(rb).reshape(Bsz, Nn)
        bt = (rt - rb.reshape(Bsz, Nn) @ Fp) @ Sti.T
        g = torch.cat([u1 - bt @ Fp.T, bt], dim=-1)
        g = g + (g @ Vt) @ PuK2t.T
        return g[:, :Nn].reshape(Bsz, N, n), g[:, Nn:]

    def add_beq(rb, x0):
        """rb with beq[:n] = -A x0 added to its first row, out of place:
        the delta-form maps pass their inputs on."""
        return torch.cat([rb[:, :1] - (x0 @ A_.T)[:, None], rb[:, 1:]],
                         dim=1)

    if split:
        def kkt(qz, qs, x0=None):
            hz = hz_inv(qz)
            hs = qs * rho_i
            rb, rt = gh_apply(hz, hs)
            if x0 is not None:
                rb = add_beq(rb, x0)
                rt = torch.cat([rt[:, :3 * n], rt[:, 3 * n:] + d_t], dim=-1)
            gz, gs = ght_apply(*w_solve(rb, rt))
            return hz_inv(gz) - hz, gs * rho_i - hs

        return kkt, lambda dqz, dqs: kkt(dqz, dqs)

    # single split: the cone offset d enters through q_hat outside
    # (code_HMPC_ADMM_C.c builds q_hat = q + C'(rho(s - d) + lam))
    def kkt(q_hat, x0=None):
        hz = hz_inv(q_hat)
        rb, rt = gh_apply(hz, None)
        if x0 is not None:
            rb = add_beq(rb, x0)
        return hz_inv(ght_apply(*w_solve(rb, rt))) - hz

    return kkt, lambda dq: kkt(dq)


def _check_backend(backend):
    if backend not in ("dense", "fused", "banded"):
        raise ValueError(f"unknown backend {backend!r}: HMPC has dense, "
                         "fused and banded backends")


@register_builder("HMPC", "ADMM")
def build_hmpc_admm(sys: dict, param: dict, opt: Options,
                    backend: str = "dense", device="cuda",
                    ingredients: dict | None = None) -> BatchedSolver:
    """Single-split ("reduced") HMPC ADMM (spcies_HMPC_ADMM_solver.m:125-198,
    code_HMPC_ADMM_C.c) on `device`. `ingredients` replaces the offline
    computation (same keys as hmpc_common_ingredients, whatever the
    backend). backend='banded' is the O(N)-memory structured KKT (box
    constraints, N >= 3). The warm start is init=(z, s, lam)."""
    _check_backend(backend)
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else hmpc_common_ingredients(sys, param, opt, split=False))
    dtype = _DTYPES[opt.precision]
    rho_f = float(opt.solver["rho"])
    if backend == "banded":
        # sigma unused: the single-split KKT shifts by rho C'C
        solve = _single_split_solve(
            ing, opt, dtype, device,
            *_make_hmpc_split_structured_kkt(
                ing, 0.0, rho_f, dtype, device, split=False,
                parallel_scan=bool(opt.solver.get("band_parallel_scan",
                                                  False))),
            hmpc_q_maker(ing, dtype, device))
    else:
        M1_np, M2_np = single_split_kkt(ing, rho_f)
        if backend == "fused":
            from spcies_tpu_torch.solvers.fused_backend import (
                build_fused_hmpc_solve)
            solve = build_fused_hmpc_solve(
                ing, opt, dtype, device, M1_np, M2_np,
                make_q=hmpc_q_maker(ing, torch.float32, device))
        else:
            solve = _single_split_solve(
                ing, opt, dtype, device,
                *_dense_single_kkt(ing, dtype, device, M1_np, M2_np),
                hmpc_q_maker(ing, dtype, device))
    return BatchedSolver(solve, ing, opt, n=ing["n"], m=ing["m"],
                         N=ing["N"], nz=ing["dim"], dtype=dtype,
                         device=device)


def _build_hmpc_split(sys, param, opt, symmetric: bool, backend: str,
                      device, ingredients):
    """Two-block split HMPC solver, plain (ADMM) or symmetric (SADMM)
    (spcies_HMPC_{ADMM,SADMM}_split_solver.m, code_HMPC_ADMM_split_C.c;
    IS_SYMMETRIC define = `symmetric`). backend='banded' is the
    O(N)-memory structured KKT over [z | s] (box constraints, N >= 3). The
    warm start is init=(z, s, lam, mu)."""
    _check_backend(backend)
    device = resolve_device(device)
    ing = (ingredients if ingredients is not None
           else hmpc_common_ingredients(sys, param, opt, split=True))
    dtype = _DTYPES[opt.precision]
    n, m, N = ing["n"], ing["m"], ing["N"]
    dim, n_s, ns, n_eq = ing["dim"], ing["n_s"], ing["ns"], ing["n_eq"]
    rho_f = float(opt.solver["rho"])
    sigma_f = float(opt.solver["sigma"])

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if backend == "banded":
        kkt_full, kkt_lin = _make_hmpc_split_structured_kkt(
            ing, sigma_f, rho_f, dtype, device,
            parallel_scan=bool(opt.solver.get("band_parallel_scan", False)))

        def kkt_init(q_hat, x0):
            return torch.cat(kkt_full(q_hat[:, :dim], q_hat[:, dim:], x0),
                             dim=-1)

        def kkt_delta(dq):
            return torch.cat(kkt_lin(dq[:, :dim], dq[:, dim:]), dim=-1)
    else:
        M1_np, M2_np = split_kkt(ing, rho_f, sigma_f)
        if backend == "fused":
            from spcies_tpu_torch.solvers.fused_backend import (
                build_fused_split_solve)
            solve = build_fused_split_solve(
                ing, opt, dtype, device, M1_np, M2_np, symmetric=symmetric,
                make_q=hmpc_q_maker(ing, torch.float32, device))
            return BatchedSolver(solve, ing, opt, n=n, m=m, N=N, nz=dim,
                                 dtype=dtype, device=device)
        M1, M2_b0, aux_d, A = (dev(a) for a in (
            M1_np, M2_np[:, :n], M2_np[:, n_eq:] @ ing["d"], ing["A"]))

        def kkt_init(q_hat, x0):
            return q_hat @ M1.T + (-(x0 @ A.T)) @ M2_b0.T + aux_d

        def kkt_delta(dq):
            return delta_dot(dq, M1.T)

    box_mode = ing["box_constraints"]
    tol_p = float(opt.solver["tol_p"])
    tol_d = float(opt.solver["tol_d"])
    k_max = int(opt.solver["k_max"])
    rho, sigma = dev(rho_f), dev(sigma_f)
    rho_i, sigma_i = dev(1.0 / rho_f), dev(1.0 / sigma_f)
    alpha = dev(float(opt.solver["alpha"]) if symmetric else 1.0)
    LB, UB = dev(ing["box_LB"]), dev(ing["box_UB"])
    make_q = hmpc_q_maker(ing, dtype, device)
    cone_proj = _make_cone_proj(ing, dtype, device)
    n_box = ing["n_box"]

    if box_mode:
        def proj_z(z):
            return torch.cat([proj_box(z[:, :ns], LB, UB), z[:, ns:]],
                             dim=-1)

        def proj_s(y):
            return cone_proj(y)
    else:
        def proj_z(z):
            return z

        def proj_s(y):
            return torch.cat([proj_box(y[:, :n_box], LB, UB),
                              cone_proj(y[:, n_box:])], dim=-1)

    def _solve(x0, xr, ur, init, fixed_iters):
        Bsz = x0.shape[0]
        q = make_q(x0, xr, ur)
        if init is None:
            z0 = torch.zeros((Bsz, dim), dtype=dtype, device=device)
            s0 = torch.zeros((Bsz, n_s), dtype=dtype, device=device)
            lam0, mu0 = torch.zeros_like(z0), torch.zeros_like(s0)
        else:
            z0, s0, lam0, mu0 = (dev(a) for a in init)
        q_hat0 = torch.cat([q - sigma * z0 + lam0, mu0 - rho * s0], dim=-1)
        aux1 = kkt_init(q_hat0, x0)
        rinf = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
        state0 = dict(aux=aux1, aux_next=aux1, z=z0, s=s0, lam=lam0, mu=mu0,
                      r_p=rinf, r_d=rinf)

        def body(state, _it):
            aux = state["aux_next"]
            z_hat, s_hat = aux[:, :dim], aux[:, dim:]
            z_old, s_old = state["z"], state["s"]
            lam, mu = state["lam"], state["mu"]
            # the carried duals that built the current aux (delta form)
            lam_at_aux, mu_at_aux = lam, mu
            if symmetric:
                # half-step duals with the previous (z, s)
                # (code_HMPC_ADMM_split_C.c:215-225)
                lam = lam + alpha * sigma * (z_hat - z_old)
                mu = mu + alpha * rho * (s_hat - s_old)
            z = proj_z(z_hat + sigma_i * lam)
            s = proj_s(s_hat + rho_i * mu)
            lam_new = lam + alpha * sigma * (z_hat - z)
            mu_new = mu + alpha * rho * (s_hat - s)
            r_p = torch.maximum(inf_norm(z_hat - z), inf_norm(s_hat - s))
            r_d = torch.maximum(inf_norm(z - z_old), inf_norm(s - s_old))
            conv = (r_p <= tol_p) & (r_d <= tol_d)
            # delta form: the next q_hat differs by
            # [-sigma dz + dlam; dmu - rho ds], each difference -> 0
            dq = torch.cat([-sigma * (z - z_old) + (lam_new - lam_at_aux),
                            (mu_new - mu_at_aux) - rho * (s - s_old)],
                           dim=-1)
            aux_next = aux + delta_dot_op(kkt_delta, dq)
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
                         dtype=dtype, device=device)


@register_builder("HMPC", "ADMM", "split")
def build_hmpc_admm_split(sys, param, opt, backend: str = "dense",
                          device="cuda", ingredients=None):
    return _build_hmpc_split(sys, param, opt, False, backend, device,
                             ingredients)


@register_builder("HMPC", "SADMM", "split")
def build_hmpc_sadmm_split(sys, param, opt, backend: str = "dense",
                           device="cuda", ingredients=None):
    return _build_hmpc_split(sys, param, opt, True, backend, device,
                             ingredients)


# ---------------------------------------------------------------------------
# ellipHMPC — harmonic MPC with coupled-output constraints
# ---------------------------------------------------------------------------

@register_builder("ellipHMPC", "ADMM")
def build_elliphmpc_admm(sys: dict, param: dict, opt: Options,
                         backend: str = "dense", device="cuda",
                         ingredients: dict | None = None) -> BatchedSolver:
    """Harmonic MPC with coupled-output constraints
    (compute_ellipHMPC_ADMM_ingredients.m, code_ellipHMPC_ADMM_C.c) on
    `device`.

    The single-split ADMM engine of HMPC-ADMM in output-constraint mode,
    with two differences: (1) the reference comes DECOMPOSED into harmonic
    components, so the solver takes the 7 inputs (x0, xre, xrs, xrc, ure,
    urs, urc) of the generated MEX (struct_ellipHMPC_ADMM_C_Matlab.c:27);
    (2) the D-set projections use sigma-tightened output bounds
    (compute_ellipHMPC_ADMM_ingredients.m:230-231). The warm start is
    init=(z, s, lam).

    The JAX package writes box_constraints=False into the caller's Options;
    this builder copies the options first and writes it into the copy,
    which the solver keeps."""
    if backend not in ("dense", "fused"):
        raise ValueError("ellipHMPC/ADMM has dense and fused backends")
    device = resolve_device(device)
    if "E" not in sys:
        raise ValueError("ellipHMPC requires coupled-output matrices "
                         "sys['E'], sys['F'] and bounds LBy/UBy")
    opt = dataclasses.replace(opt, solver=dict(opt.solver,
                                               box_constraints=False))
    ing = (ingredients if ingredients is not None
           else hmpc_common_ingredients(sys, param, opt, split=False))
    dtype = _DTYPES[opt.precision]
    sigma = float(opt.solver.get("sigma", 0.0))
    # sigma-tightened D-set bounds for the harmonic cone projections
    lby, uby = ing["LBy"] + sigma, ing["UBy"] - sigma
    M1_np, M2_np = single_split_kkt(ing, float(opt.solver["rho"]))
    if backend == "fused":
        from spcies_tpu_torch.solvers.fused_backend import (
            build_fused_hmpc_solve)
        solve = build_fused_hmpc_solve(
            ing, opt, dtype, device, M1_np, M2_np,
            make_q=elliphmpc_q_maker(ing, torch.float32, device),
            lby=lby, uby=uby)
    else:
        solve = _single_split_solve(
            ing, opt, dtype, device,
            *_dense_single_kkt(ing, dtype, device, M1_np, M2_np),
            elliphmpc_q_maker(ing, dtype, device), LBy=lby, UBy=uby)
    return BatchedSolver(solve, ing, opt, n=ing["n"], m=ing["m"],
                         N=ing["N"], nz=ing["dim"], dtype=dtype,
                         device=device, input_names=ELLIP_INPUTS)
