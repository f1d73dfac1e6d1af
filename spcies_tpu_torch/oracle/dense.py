"""Dense fp64 numpy reference solvers — the in-repo test oracle.

These mirror the reference's non-sparse MATLAB solvers
(platforms/Matlab/spcies_*_solver.m) and their dense helpers
solve_eqQP.m / solve_boxQP.m: readable, per-problem, no batching, numpy
only (the port of spcies_tpu/oracle/dense.py). The differential tests
require the batched solvers' fp64 dense engines to agree with these
to ~1e-9 class tolerances in fp64 (the reference's sparse-vs-oracle contract
is 1e-10, tests/spcies_tester.m:260).
"""

from __future__ import annotations

import numpy as np

from spcies_tpu_torch.utils import linalg


def solve_eq_qp(Hinv, G, W, q, b):
    """Equality-constrained QP: min 0.5 z'H z + q'z s.t. G z = b, given
    Hinv and W = G Hinv G' (platforms/Matlab/solve_eqQP.m:16-27)."""
    mu = np.linalg.solve(W, -G @ (Hinv @ q) - b)
    return -Hinv @ (q + G.T @ mu)


def solve_box_qp(y, lb, ub):
    """Box projection (platforms/Matlab/solve_boxQP.m:44-63)."""
    return np.clip(y, lb, ub)


def laxmpc_admm_oracle(sys, param, x0, xr, ur, *, rho=1e-2, tol=1e-4,
                       k_max=1000):
    """Reference-faithful dense ADMM for laxMPC
    (platforms/Matlab/spcies_laxMPC_ADMM_solver.m:242-321).

    Returns (u, k, e_flag, sol) with sol = dict(z, v, lam, r_p, r_d).
    """
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    T = np.asarray(param["T"], float)
    nz = N * (n + m)

    rho_vec = np.full(nz, float(rho)) if np.isscalar(rho) else np.asarray(rho)
    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T)
    Hhat = H + np.diag(rho_vec)
    Hinv = np.linalg.inv(Hhat)
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T

    LB = np.concatenate([sys["LBu"]]
                        + [np.concatenate([sys["LBx"], sys["LBu"]])] * (N - 1)
                        + [sys["LBx"]])
    UB = np.concatenate([sys["UBu"]]
                        + [np.concatenate([sys["UBx"], sys["UBu"]])] * (N - 1)
                        + [sys["UBx"]])

    Qd, Rd = np.diag(Q), np.diag(R)
    q_ref = np.concatenate([-Rd * ur]
                           + [np.concatenate([-Qd * xr, -Rd * ur])] * (N - 1)
                           + [-(T @ xr)])
    beq = np.zeros(N * n)
    beq[:n] = -A @ x0

    z = np.zeros(nz)
    v = np.zeros(nz)
    lam = np.zeros(nz)
    k = 0
    e_flag = 0
    r_p = r_d = np.inf
    while e_flag == 0:
        k += 1
        v_prev = v
        q_hat = q_ref + lam - rho_vec * v
        z = solve_eq_qp(Hinv, G, W, q_hat, beq)
        v = solve_box_qp(z + lam / rho_vec, LB, UB)
        lam = lam + rho_vec * (z - v)
        r_p = np.max(np.abs(z - v))
        r_d = np.max(np.abs(v - v_prev))
        if r_p <= tol and r_d <= tol:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    u = v[:m].copy()
    return u, k, e_flag, dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d)


def equmpc_admm_oracle(sys, param, x0, xr, ur, *, rho=1e-2, tol=1e-4,
                       k_max=1000):
    """Reference-faithful dense ADMM for equMPC
    (platforms/Matlab/spcies_equMPC_ADMM_solver.m:244-298): decision vector
    without x_N, terminal equality x_N = xr via the last RHS block."""
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    nz = N * (n + m) - n

    rho_vec = np.full(nz, float(rho)) if np.isscalar(rho) else np.asarray(rho)
    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)))
    Hinv = np.linalg.inv(H + np.diag(rho_vec))
    G = linalg.mpc_equality_matrix(A, B, N, drop_terminal=True)
    W = G @ Hinv @ G.T

    LB = np.concatenate([sys["LBu"]]
                        + [np.concatenate([sys["LBx"], sys["LBu"]])] * (N - 1))
    UB = np.concatenate([sys["UBu"]]
                        + [np.concatenate([sys["UBx"], sys["UBu"]])] * (N - 1))

    Qd, Rd = np.diag(Q), np.diag(R)
    q_ref = np.concatenate([-Rd * ur]
                           + [np.concatenate([-Qd * xr, -Rd * ur])] * (N - 1))
    beq = np.zeros(N * n)
    beq[:n] = -A @ x0
    beq[-n:] = xr

    z = np.zeros(nz)
    v = np.zeros(nz)
    lam = np.zeros(nz)
    k = 0
    e_flag = 0
    r_p = r_d = np.inf
    while e_flag == 0:
        k += 1
        v_prev = v
        q_hat = q_ref + lam - rho_vec * v
        z = solve_eq_qp(Hinv, G, W, q_hat, beq)
        v = solve_box_qp(z + lam / rho_vec, LB, UB)
        lam = lam + rho_vec * (z - v)
        r_p = np.max(np.abs(z - v))
        r_d = np.max(np.abs(v - v_prev))
        if r_p <= tol and r_d <= tol:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    u = v[:m].copy()
    return u, k, e_flag, dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d)


def mpct_eadmm_oracle(sys, param, x0, xr, ur, *, rho_base=3.0, rho_mult=20.0,
                      epsilon_x=1e-6, epsilon_u=1e-6, tol=1e-4, k_max=1000,
                      inf_value=1e30):
    """Reference-faithful dense 3-block EADMM for MPCT
    (platforms/Matlab/spcies_MPCT_EADMM_solver.m:143-247): materializes
    A1/A2/A3 and iterates P1 (clip) -> P2 (dense W2) -> P3 (equality QP) ->
    dual update with the structured rho vector."""
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    T = np.asarray(param["T"], float)
    S = np.asarray(param["S"], float)
    nm = n + m
    nz1 = (N + 1) * nm
    nrow = nz1 + n + nm

    rho = np.full(nrow, rho_base)
    rho[:2 * n] = rho_mult * rho_base
    rho[nrow - 2 * nm:] = rho_mult * rho_base

    # coupling matrices (compute_MPCT_EADMM_ingredients.m:95-105)
    A1 = -np.vstack([
        np.hstack([-np.eye(n), np.zeros((n, nz1 - n))]),
        np.eye(nz1),
        np.hstack([np.zeros((nm, N * nm)), np.eye(nm)]),
    ])
    A2 = np.vstack([np.zeros((n, nm))] + [np.eye(nm)] * (N + 2))
    A3 = np.vstack([np.zeros((n, nz1)),
                    np.eye(nz1),
                    np.zeros((nm, nz1))])

    H1i = 1.0 / np.diag((rho[:, None] * A1).T @ A1)
    H2 = linalg.blkdiag(T, S) + (rho[:, None] * A2).T @ A2
    H2i = np.linalg.inv(H2)
    Az2 = np.hstack([A - np.eye(n), B])
    W2 = H2i @ Az2.T @ np.linalg.inv(Az2 @ H2i @ Az2.T) @ Az2 @ H2i - H2i
    H3 = (linalg.blkdiag(*([linalg.blkdiag(Q, R)] * (N + 1)))
          + (rho[:, None] * A3).T @ A3)
    H3inv = np.linalg.inv(H3)
    Az3 = np.zeros((N * n, nz1))
    for i in range(N):
        Az3[i * n:(i + 1) * n, i * nm:i * nm + n] = A
        Az3[i * n:(i + 1) * n, i * nm + n:(i + 1) * nm] = B
        Az3[i * n:(i + 1) * n, (i + 1) * nm:(i + 1) * nm + n] = -np.eye(n)
    W3 = Az3 @ H3inv @ Az3.T

    LBx = np.asarray(sys["LBx"], float)
    UBx = np.asarray(sys["UBx"], float)
    LBu = np.asarray(sys["LBu"], float)
    UBu = np.asarray(sys["UBu"], float)
    LB = np.concatenate([np.concatenate([-inf_value * np.ones(n), LBu])]
                        + [np.concatenate([LBx, LBu])] * (N - 1)
                        + [np.concatenate([LBx + epsilon_x, LBu + epsilon_u])])
    UB = np.concatenate([np.concatenate([inf_value * np.ones(n), UBu])]
                        + [np.concatenate([UBx, UBu])] * (N - 1)
                        + [np.concatenate([UBx - epsilon_x, UBu - epsilon_u])])

    b = np.zeros(nrow)
    b[:n] = x0

    z1 = np.zeros(nz1)
    z2 = np.zeros(nm)
    z3 = np.zeros(nz1)
    z2_prev, z3_prev = z2, z3
    lam = np.zeros(nrow)
    k = 0
    e_flag = 0
    res = {}
    while e_flag == 0:
        k += 1
        q1 = ((rho[:, None] * A1).T @ (A2 @ z2 + A3 @ z3 - b) + A1.T @ lam)
        z1 = np.clip(-q1 * H1i, LB, UB)
        q2 = (-np.concatenate([T @ xr, S @ ur])
              + (rho[:, None] * A2).T @ (A1 @ z1 + A3 @ z3) + A2.T @ lam)
        z2 = W2 @ q2
        q3 = (rho[:, None] * A3).T @ (A1 @ z1 + A2 @ z2) + A3.T @ lam
        mu = np.linalg.solve(W3, -Az3 @ (H3inv @ q3))
        z3 = -H3inv @ (Az3.T @ mu + q3)
        res_pf = A1 @ z1 + A2 @ z2 + A3 @ z3 - b
        n_pf = np.max(np.abs(res_pf))
        n_z2 = np.max(np.abs(z2 - z2_prev))
        n_z3 = np.max(np.abs(z3 - z3_prev))
        lam = lam + rho * res_pf
        if n_pf <= tol and n_z2 <= tol and n_z3 <= tol:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
        z2_prev, z3_prev = z2, z3
        res = dict(r_pf=n_pf, r_z2=n_z2, r_z3=n_z3)
    u = z1[n:n + m].copy()
    return u, k, e_flag, dict(z1=z1, z2=z2, z3=z3, lam=lam, **res)


def _fista_oracle(hinv_diag, G, W, LB, UB, q, b, m, *, tol, k_max,
                  lam_init=None):
    """Dense dual-FISTA core, reference-faithful to
    spcies_laxMPC_FISTA_solver.m:231-345 (warm-start gradient step, momentum
    t-update, exit on ||b - G z||_inf <= tol)."""
    nlam = G.shape[0]
    lam = np.zeros(nlam) if lam_init is None else np.asarray(lam_init, float)

    def z_of(y):
        return np.clip(-hinv_diag * (q - G.T @ y), LB, UB)

    # k = 0: one plain gradient step
    z = z_of(lam)
    r = b - G @ z
    y = lam + np.linalg.solve(W, r)
    lam = y
    t = 1.0

    k = 0
    e_flag = 0
    res = np.inf
    while e_flag == 0:
        k += 1
        t_prev, lam_prev = t, lam
        z = z_of(y)
        r = b - G @ z
        res = np.max(np.abs(r))
        if res <= tol:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
        else:
            lam = y + np.linalg.solve(W, r)
            t = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t_prev ** 2))
            y = lam + ((t_prev - 1.0) / t) * (lam - lam_prev)
    return z[:m].copy(), k, e_flag, dict(z=z, lam=y, res=res)


def ellipmpc_admm_oracle(sys, param, x0, xr, ur, *, rho=1e-2, tol=1e-4,
                         k_max=1000):
    """Reference-faithful dense ADMM for ellipMPC
    (platforms/Matlab/spcies_ellipMPC_ADMM_solver.m:129-224): terminal
    penalty rho*P, P-norm ellipsoid projection on the terminal block.
    rho may be a scalar or a length-N(n+m) vector whose terminal n entries
    are equal (the only well-formed vector layout; see
    formulations/ellipmpc.py)."""
    import scipy.linalg as sla
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    T = np.asarray(param["T"], float)
    P = np.asarray(param["P"], float)
    c = np.asarray(param.get("c", np.zeros(n)), float).ravel()
    r = float(param.get("r", 1.0))
    nz = N * (n + m)
    ns = nz - n
    rho_vec = np.asarray(rho, float)
    if rho_vec.ndim == 0:
        rho_vec = np.full(nz, float(rho))
    rho_T = float(rho_vec[-1])
    rho_s = rho_vec[:ns]
    rho = rho_s  # stage-entry layout used elementwise below

    w, V = np.linalg.eigh(P)
    P_half = (V * np.sqrt(np.maximum(w, 0))) @ V.T
    Pinv_half = np.linalg.inv(P) @ P_half

    Hz = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T)
    Hhat = Hz + linalg.blkdiag(np.diag(rho_s), rho_T * P)
    Hinv = np.linalg.inv(Hhat)
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T

    LB = np.concatenate([sys["LBu"]]
                        + [np.concatenate([sys["LBx"], sys["LBu"]])] * (N - 1))
    UB = np.concatenate([sys["UBu"]]
                        + [np.concatenate([sys["UBx"], sys["UBu"]])] * (N - 1))

    Qd, Rd = np.diag(Q), np.diag(R)
    q = np.concatenate([-Rd * ur]
                       + [np.concatenate([-Qd * xr, -Rd * ur])] * (N - 1)
                       + [-(T @ xr)])
    beq = np.zeros(N * n)
    beq[:n] = -A @ x0

    z = np.zeros(nz)
    v = np.zeros(nz)
    v1 = np.zeros(nz)
    lam = np.zeros(nz)
    k = 0
    e_flag = 0
    r_p = r_d = np.inf
    while e_flag == 0:
        k += 1
        q_hat = np.empty(nz)
        q_hat[:ns] = q[:ns] + lam[:ns] - rho * v[:ns]
        q_hat[ns:] = q[ns:] + P_half @ lam[ns:] - rho_T * (P @ v[ns:])
        z = solve_eq_qp(Hinv, G, W, q_hat, beq)
        v = np.empty(nz)
        v[:ns] = np.clip(z[:ns] + lam[:ns] / rho, LB, UB)
        vT = z[ns:] + Pinv_half @ lam[ns:] / rho_T
        d = vT - c
        vPv = d @ (P @ d)
        if vPv > r * r:
            vT = r * d / np.sqrt(vPv) + c
        v[ns:] = vT
        lam = lam.copy()
        lam[:ns] += rho * (z[:ns] - v[:ns])
        lam[ns:] += rho_T * (P_half @ (z[ns:] - v[ns:]))
        r_p = np.max(np.abs(z - v))
        r_d = np.max(np.abs(v - v1))
        if r_p <= tol and r_d <= tol:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
        v1 = v
    return v[:m].copy(), k, e_flag, dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d)


def ellipmpc_admm_soc_oracle(sys, param, x0, xr, ur, r_ellip=None, *,
                             rho=5.0, sigma=5.0, tol_p=1e-4, tol_d=1e-4,
                             k_max=1000):
    """Reference-faithful dense ADMM-soc for ellipMPC
    (platforms/Matlab/spcies_ellipMPC_ADMM_soc_solver.m:139-245, using its
    commented dense M1/M2 path at :198)."""
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    T = np.asarray(param["T"], float)
    P = np.asarray(param["P"], float)
    if r_ellip is None:
        r_ellip = float(param.get("r", 1.0))
    dim = N * (n + m) + 1
    n_s = n + 1
    nbox = (N - 1) * (n + m) + m

    w, V = np.linalg.eigh(P)
    P_half = (V * np.sqrt(np.maximum(w, 0))) @ V.T
    PhiP = np.linalg.solve(P_half, P)

    H = linalg.blkdiag(R, *([linalg.blkdiag(Q, R)] * (N - 1)), T,
                       np.zeros((1, 1)))
    G = linalg.mpc_equality_matrix(A, B, N)
    G = linalg.blkdiag(G, np.ones((1, 1)))
    n_eq = G.shape[0]
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

    LB = np.concatenate([sys["LBu"]]
                        + [np.concatenate([sys["LBx"], sys["LBu"]])] * (N - 1))
    UB = np.concatenate([sys["UBu"]]
                        + [np.concatenate([sys["UBx"], sys["UBu"]])] * (N - 1))

    Qd, Rd = np.diag(Q), np.diag(R)
    q = np.concatenate([-Rd * ur]
                       + [np.concatenate([-Qd * xr, -Rd * ur])] * (N - 1)
                       + [-(T @ xr), [0.0]])
    bh = np.zeros(n_eq + n_s)
    bh[:n] = -A @ x0
    bh[n_eq - 1] = r_ellip
    bh[n_eq + 1:] = -PhiP @ xr

    z = np.zeros(dim)
    s = np.zeros(n_s)
    lam = np.zeros(dim)
    mu = np.zeros(n_s)
    z_ant, s_ant = z, s
    k = 0
    e_flag = 0
    rp = rd = np.inf
    while e_flag == 0:
        k += 1
        q_hat = np.concatenate([q - sigma * z + lam, mu - rho * s])
        aux = M1 @ q_hat + M2 @ bh
        z_hat, s_hat = aux[:dim], aux[dim:]
        z = z_hat + lam / sigma
        z[:nbox] = np.clip(z[:nbox], LB, UB)
        sp = s_hat + mu / rho
        s0, s1 = sp[0], sp[1:]
        ns1 = np.linalg.norm(s1)
        if ns1 <= s0:
            s = sp
        elif ns1 <= -s0:
            s = np.zeros(n_s)
        else:
            s = (s0 + ns1) / (2 * ns1) * np.concatenate([[ns1], s1])
        lam = lam + sigma * (z_hat - z)
        mu = mu + rho * (s_hat - s)
        rp = max(np.max(np.abs(z_hat - z)), np.max(np.abs(s_hat - s)))
        rd = max(np.max(np.abs(z - z_ant)), np.max(np.abs(s - s_ant)))
        z_ant, s_ant = z, s
        if rp <= tol_p and rd <= tol_d:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    return z[:m].copy(), k, e_flag, dict(
        z=z, s=s, z_hat=z_hat, s_hat=s_hat, lam=lam, mu=mu, r_p=rp, r_d=rd)


def laxmpc_fista_oracle(sys, param, x0, xr, ur, *, tol=1e-4, k_max=1000):
    """Dense FISTA for laxMPC (spcies_laxMPC_FISTA_solver.m)."""
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Qd = np.diag(np.asarray(param["Q"], float))
    Rd = np.diag(np.asarray(param["R"], float))
    Td = np.diag(np.asarray(param["T"], float))

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1) + [Td])
    G = linalg.mpc_equality_matrix(A, B, N)
    W = G @ ((1.0 / h_diag)[:, None] * G.T)
    LB = np.concatenate([sys["LBu"]]
                        + [np.concatenate([sys["LBx"], sys["LBu"]])] * (N - 1)
                        + [sys["LBx"]])
    UB = np.concatenate([sys["UBu"]]
                        + [np.concatenate([sys["UBx"], sys["UBu"]])] * (N - 1)
                        + [sys["UBx"]])
    q = np.concatenate([-Rd * ur]
                       + [np.concatenate([-Qd * xr, -Rd * ur])] * (N - 1)
                       + [-Td * xr])
    b = np.zeros(N * n)
    b[:n] = -A @ x0
    return _fista_oracle(1.0 / h_diag, G, W, LB, UB, q, b, m,
                         tol=tol, k_max=k_max)


def equmpc_fista_oracle(sys, param, x0, xr, ur, *, tol=1e-4, k_max=1000):
    """Dense FISTA for equMPC (spcies_equMPC_FISTA_solver.m)."""
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Qd = np.diag(np.asarray(param["Q"], float))
    Rd = np.diag(np.asarray(param["R"], float))

    h_diag = np.concatenate([Rd] + [np.concatenate([Qd, Rd])] * (N - 1))
    G = linalg.mpc_equality_matrix(A, B, N, drop_terminal=True)
    W = G @ ((1.0 / h_diag)[:, None] * G.T)
    LB = np.concatenate([sys["LBu"]]
                        + [np.concatenate([sys["LBx"], sys["LBu"]])] * (N - 1))
    UB = np.concatenate([sys["UBu"]]
                        + [np.concatenate([sys["UBx"], sys["UBu"]])] * (N - 1))
    q = np.concatenate([-Rd * ur]
                       + [np.concatenate([-Qd * xr, -Rd * ur])] * (N - 1))
    b = np.zeros(N * n)
    b[:n] = -A @ x0
    b[-n:] = xr
    return _fista_oracle(1.0 / h_diag, G, W, LB, UB, q, b, m,
                         tol=tol, k_max=k_max)


def mpct_admm_cs_oracle(sys, param, x0, xr, ur, *, rho=1e-2, tol=1e-4,
                        k_max=1000, epsilon_x=1e-6, epsilon_u=1e-6):
    """Reference-faithful dense ADMM for MPCT on the extended state space
    (platforms/Matlab/spcies_MPCT_ADMM_cs_solver.m:139-226)."""
    from spcies_tpu_torch.formulations.mpct import mpct_cs_equality_matrix
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    T = np.asarray(param["T"], float)
    S = np.asarray(param["S"], float)
    sd = 2 * (n + m)
    nz = N * sd

    rho_vec = np.full(nz, float(rho)) if np.isscalar(rho) else np.asarray(rho)
    Qz = np.block([[Q, -Q], [-Q, Q + T / N]])
    Rz = np.block([[R, -R], [-R, R + S / N]])
    H = linalg.blkdiag(*([linalg.blkdiag(Qz, Rz)] * N))
    Hinv = np.linalg.inv(H + np.diag(rho_vec))
    G = mpct_cs_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T

    LBx = np.asarray(sys["LBx"], float)
    UBx = np.asarray(sys["UBx"], float)
    LBu = np.asarray(sys["LBu"], float)
    UBu = np.asarray(sys["UBu"], float)
    LB = np.tile(np.concatenate([LBx, LBx + epsilon_x,
                                 LBu, LBu + epsilon_u]), N)
    UB = np.tile(np.concatenate([UBx, UBx - epsilon_x,
                                 UBu, UBu - epsilon_u]), N)

    q = np.tile(np.concatenate([np.zeros(n), -(T @ xr) / N,
                                np.zeros(m), -(S @ ur) / N]), N)
    beq = np.zeros(G.shape[0])
    beq[:n] = x0

    z = np.zeros(nz)
    v = np.zeros(nz)
    lam = np.zeros(nz)
    k = 0
    e_flag = 0
    r_p = r_d = np.inf
    while e_flag == 0:
        k += 1
        v_prev = v
        q_hat = q + lam - rho_vec * v
        z = solve_eq_qp(Hinv, G, W, q_hat, beq)
        v = solve_box_qp(z + lam / rho_vec, LB, UB)
        lam = lam + rho_vec * (z - v)
        r_p = np.max(np.abs(z - v))
        r_d = np.max(np.abs(v - v_prev))
        if r_p <= tol and r_d <= tol:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    u = v[2 * n:2 * n + m].copy()
    return u, k, e_flag, dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d)


def mpct_admm_semiband_oracle(sys, param, x0, xr, ur, *, rho=1e-2,
                              tol_p=1e-4, tol_d=1e-4, k_max=1000,
                              epsilon_x=1e-6, epsilon_u=1e-6, epsilon_y=1e-6,
                              soft_constraints=False,
                              constrained_output=False, beta=1.0,
                              inf_value=1e30):
    """Reference-faithful dense ADMM for MPCT-semiband
    (platforms/Matlab/spcies_MPCT_ADMM_semiband_solver.m:163-560). The
    mirror's two-level Woodbury z-update equals the direct equality-QP
    solve used here (Alg. 2 is an exact inverse application)."""
    from spcies_tpu_torch.formulations.mpct import (
        mpct_semiband_equality_matrix)
    A = np.asarray(sys["A"], float)
    B = np.asarray(sys["B"], float)
    n, m = A.shape[0], B.shape[1]
    N = int(param["N"])
    Q = np.asarray(param["Q"], float)
    R = np.asarray(param["R"], float)
    T = np.asarray(param["T"], float)
    S = np.asarray(param["S"], float)
    nm = n + m
    nz = (N + 1) * nm

    if constrained_output:
        C = np.asarray(sys["C"], float)
        D = np.asarray(sys.get("D", np.zeros((C.shape[0], m))), float)
        p = C.shape[0]
        stage_map = np.vstack([np.hstack([np.eye(n), np.zeros((n, m))]),
                               np.hstack([np.zeros((m, n)), np.eye(m)]),
                               np.hstack([C, D])])
        Ct = linalg.blkdiag(*([stage_map] * (N + 1)))
    else:
        p = 0
        Ct = np.eye(nz)
    sv = nm + p
    nv = (N + 1) * sv

    QR = linalg.blkdiag(Q, R)
    H = linalg.blkdiag(*([QR] * N), linalg.blkdiag(N * Q + T, N * R + S))
    H[:N * nm, -nm:] = np.tile(-QR, (N, 1))
    H[-nm:, :N * nm] = np.tile(-QR, (1, N))
    Hhat = H + rho * (Ct.T @ Ct)
    Hinv = np.linalg.inv(Hhat)
    G = mpct_semiband_equality_matrix(A, B, N)
    W = G @ Hinv @ G.T

    LBx = np.asarray(sys.get("LBx", -inf_value * np.ones(n)), float)
    UBx = np.asarray(sys.get("UBx", inf_value * np.ones(n)), float)
    LBu = np.asarray(sys.get("LBu", -inf_value * np.ones(m)), float)
    UBu = np.asarray(sys.get("UBu", inf_value * np.ones(m)), float)
    if constrained_output:
        LBy = np.asarray(sys.get("LBy", -inf_value * np.ones(p)), float)
        UBy = np.asarray(sys.get("UBy", inf_value * np.ones(p)), float)
        st_lb = np.concatenate([LBx, LBu, LBy])
        st_ub = np.concatenate([UBx, UBu, UBy])
        eps = np.concatenate([np.full(n, epsilon_x), np.full(m, epsilon_u),
                              np.full(p, epsilon_y)])
    else:
        st_lb = np.concatenate([LBx, LBu])
        st_ub = np.concatenate([UBx, UBu])
        eps = np.concatenate([np.full(n, epsilon_x), np.full(m, epsilon_u)])
    lb0 = st_lb.copy(); ub0 = st_ub.copy()
    lb0[:n] = -inf_value; ub0[:n] = inf_value
    if soft_constraints:
        lbT, ubT = st_lb, st_ub
    else:
        lbT, ubT = st_lb + eps, st_ub - eps
    LB = np.concatenate([lb0] + [st_lb] * (N - 1) + [lbT])
    UB = np.concatenate([ub0] + [st_ub] * (N - 1) + [ubT])
    soft_mask = np.ones(nv, dtype=bool)
    soft_mask[:nm] = False

    q = np.zeros(nz)
    q[-nm:-m] = -(T @ xr)
    q[-m:] = -(S @ ur)
    beq = np.zeros((N + 2) * n)
    beq[:n] = x0
    br = beta / rho

    z = np.zeros(nz)
    v = np.zeros(nv)
    v_old = np.zeros(nv)
    lam = np.zeros(nv)
    k = 0
    e_flag = 0
    r_p = r_d = np.inf
    while e_flag == 0:
        k += 1
        pvec = q + Ct.T @ (lam - rho * v)
        z = solve_eq_qp(Hinv, G, W, pvec, beq)
        y = Ct @ z + lam / rho
        hard = np.clip(y, LB, UB)
        if soft_constraints:
            v1 = y + br
            v3 = y - br
            softv = np.where(v1 <= LB, v1,
                             np.where((y >= LB) & (y <= UB), y,
                                      np.where(v3 >= UB, v3,
                                               np.clip(y, LB, UB))))
            v = np.where(soft_mask, softv, hard)
        else:
            v = hard
        lam = lam + rho * (Ct @ z - v)
        r_p = np.max(np.abs(Ct @ z - v))
        r_d = np.max(np.abs(v - v_old))
        if r_p <= tol_p and r_d <= tol_d:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
        v_old = v
    u = v[n:n + m].copy()
    return u, k, e_flag, dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d)


def _proj_soc_np(y):
    """+sp_utils/proj_SOC.m three-case form."""
    y0, y1 = y[0], y[1:]
    ny1 = np.linalg.norm(y1)
    if ny1 <= y0:
        return y.copy()
    if ny1 <= -y0:
        return np.zeros_like(y)
    step = (y0 + ny1) / (2 * ny1)
    return step * np.concatenate([[ny1], y1])


def _proj_ssoc_np(y, alpha, dd):
    """+sp_utils/proj_SSOC.m: shifted SOC ||y1|| <= alpha*(y0 - d)."""
    y0, y1 = y[0], y[1:]
    ny1 = np.linalg.norm(y1)
    corr = alpha * (y0 - dd)
    if ny1 <= corr:
        return y.copy()
    if ny1 <= -corr:
        return np.concatenate([[dd], np.zeros_like(y1)])
    step = (corr + ny1) / (2 * ny1)
    return np.concatenate([[step * ny1 * alpha + dd], step * y1])


def _proj_d_np(y, lb, ub):
    """+sp_utils/proj_D.m: diamond = two shifted-SOC projections."""
    return _proj_ssoc_np(_proj_ssoc_np(y, 1.0, lb), -1.0, ub)


def _hmpc_cone_proj_np(ing, tail):
    if ing["use_soc"]:
        out = tail.copy()
        for j in range(ing["n_soc"]):
            out[3 * j:3 * j + 3] = _proj_soc_np(tail[3 * j:3 * j + 3])
        return out
    out = tail.copy()
    for j in range(ing["n_y"]):
        out[3 * j:3 * j + 3] = _proj_d_np(tail[3 * j:3 * j + 3],
                                          ing["LBy"][j], ing["UBy"][j])
    return out


def hmpc_admm_oracle(sys, param, x0, xr, ur, *, rho=1e-2, tol_p=1e-4,
                     tol_d=1e-4, k_max=1000, use_soc=False,
                     box_constraints=None, **_ignored):
    """Reference-faithful dense single-split HMPC ADMM
    (platforms/Matlab/spcies_HMPC_ADMM_solver.m:125-198)."""
    from spcies_tpu_torch.formulations.hmpc import hmpc_common_ingredients
    from spcies_tpu_torch.config import Options
    opt = Options(formulation="HMPC", method="ADMM",
                  solver=dict(rho=rho, use_soc=use_soc,
                              box_constraints=box_constraints))
    ing = hmpc_common_ingredients(sys, param, opt, split=False)
    n, m = ing["n"], ing["m"]
    n_box, n_s = ing["n_box"], ing["n_s"]

    Hh = ing["H"] + rho * (ing["C"].T @ ing["C"])
    Hhi = np.linalg.inv(Hh)
    G = ing["G"]
    W = G @ Hhi @ G.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ G.T @ Winv @ G @ Hhi - Hhi
    M2 = (Hhi @ G.T @ Winv)[:, :n]
    C, d = ing["C"], ing["d"]
    A = ing["A"]
    Te, Se, Q = ing["Te"], ing["Se"], ing["Q"]
    ns = ing["ns"]
    # Q x0 terms per the authoritative generated C (code_HMPC_ADMM_C.c:
    # 92-101); the reference's MATLAB mirror omits them (upstream bug)
    q = -np.concatenate([np.zeros(ns), Te @ xr + Q @ x0, np.zeros(n),
                         Q @ x0, Se @ ur, np.zeros(2 * m)])
    b = -A @ x0

    s = np.zeros(n_s)
    lam = np.zeros(n_s)
    s_ant = s
    k = 0
    e_flag = 0
    rp = rd = np.inf
    z = None
    while e_flag == 0:
        k += 1
        q_hat = q + C.T @ (rho * (s - d) + lam)
        z = M1 @ q_hat + M2 @ b
        Czd = C @ z - d
        s_proj = -Czd - lam / rho
        s = s_proj.copy()
        s[:n_box] = np.clip(s_proj[:n_box], ing["box_LB"], ing["box_UB"])
        s[n_box:] = _hmpc_cone_proj_np(ing, s_proj[n_box:])
        resid = Czd + s
        lam = lam + rho * resid
        rp = np.max(np.abs(resid))
        rd = np.max(np.abs(s - s_ant))
        s_ant = s
        if rp <= tol_p and rd <= tol_d:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    return z[:m].copy(), k, e_flag, dict(z=z, s=s, lam=lam, r_p=rp, r_d=rd)


def hmpc_split_oracle(sys, param, x0, xr, ur, *, rho=1e-2, sigma=1e-2,
                      tol_p=1e-4, tol_d=1e-4, k_max=1000, use_soc=False,
                      box_constraints=None, symmetric=False, alpha=0.95,
                      **_ignored):
    """Reference-faithful dense two-block split HMPC (S)ADMM
    (platforms/Matlab/spcies_HMPC_{ADMM,SADMM}_split_solver.m)."""
    from spcies_tpu_torch.formulations.hmpc import hmpc_common_ingredients
    from spcies_tpu_torch.config import Options
    opt = Options(formulation="HMPC", method="ADMM",
                  solver=dict(rho=rho, use_soc=use_soc,
                              box_constraints=box_constraints))
    ing = hmpc_common_ingredients(sys, param, opt, split=True)
    n, m = ing["n"], ing["m"]
    dim, n_s, ns, n_eq = ing["dim"], ing["n_s"], ing["ns"], ing["n_eq"]
    n_box = ing["n_box"]
    box_mode = ing["box_constraints"]
    if not symmetric:
        alpha = 1.0

    Hh = linalg.blkdiag(ing["H"] + sigma * np.eye(dim), rho * np.eye(n_s))
    Gh = np.block([[ing["G"], np.zeros((n_eq, n_s))],
                   [ing["C"], np.eye(n_s)]])
    Hhi = np.linalg.inv(Hh)
    W = Gh @ Hhi @ Gh.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ Gh.T @ Winv @ Gh @ Hhi - Hhi
    M2 = Hhi @ Gh.T @ Winv
    A = ing["A"]
    Te, Se, Q = ing["Te"], ing["Se"], ing["Q"]
    q = -np.concatenate([np.zeros(ns), Te @ xr + Q @ x0, np.zeros(n),
                         Q @ x0, Se @ ur, np.zeros(2 * m)])
    bh = np.concatenate([-A @ x0, np.zeros(n_eq - n), ing["d"]])

    z = np.zeros(dim)
    s = np.zeros(n_s)
    lam = np.zeros(dim)
    mu = np.zeros(n_s)
    z_ant, s_ant = z, s
    k = 0
    e_flag = 0
    rp = rd = np.inf
    while e_flag == 0:
        k += 1
        q_hat = np.concatenate([q - sigma * z + lam, mu - rho * s])
        rhs = M1 @ q_hat + M2 @ bh
        z_hat, s_hat = rhs[:dim], rhs[dim:]
        if symmetric:
            lam = lam + alpha * sigma * (z_hat - z)
            mu = mu + alpha * rho * (s_hat - s)
        z = z_hat + lam / sigma
        if box_mode:
            z[:ns] = np.clip(z[:ns], ing["box_LB"], ing["box_UB"])
        s_proj = s_hat + mu / rho
        if box_mode:
            s = _hmpc_cone_proj_np(ing, s_proj)
        else:
            s = s_proj.copy()
            s[:n_box] = np.clip(s_proj[:n_box], ing["box_LB"],
                                ing["box_UB"])
            s[n_box:] = _hmpc_cone_proj_np(ing, s_proj[n_box:])
        lam = lam + alpha * sigma * (z_hat - z)
        mu = mu + alpha * rho * (s_hat - s)
        rp = max(np.max(np.abs(z_hat - z)), np.max(np.abs(s_hat - s)))
        rd = max(np.max(np.abs(z - z_ant)), np.max(np.abs(s - s_ant)))
        z_ant, s_ant = z, s
        if rp <= tol_p and rd <= tol_d:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    return z[:m].copy(), k, e_flag, dict(
        z=z, s=s, z_hat=z_hat, s_hat=s_hat, lam=lam, mu=mu, r_p=rp, r_d=rd)


def elliphmpc_admm_oracle(sys, param, x0, xre, xrs, xrc, ure, urs, urc, *,
                          rho=1e-2, sigma=0.0, tol_p=1e-4, tol_d=1e-4,
                          k_max=1000, use_soc=False, **_ignored):
    """Dense mirror of the generated ellipHMPC C solver
    (formulations/+HMPC/code_ellipHMPC_ADMM_C.c; the reference ships no
    MATLAB mirror for this solver): single-split ADMM with decomposed
    harmonic references and sigma-tightened D-set bounds."""
    from spcies_tpu_torch.formulations.hmpc import hmpc_common_ingredients
    from spcies_tpu_torch.config import Options
    opt = Options(formulation="HMPC", method="ADMM",
                  solver=dict(rho=rho, use_soc=use_soc,
                              box_constraints=False))
    ing = hmpc_common_ingredients(sys, param, opt, split=False)
    n, m = ing["n"], ing["m"]
    n_box, n_s, ns = ing["n_box"], ing["n_s"], ing["ns"]
    ing_t = dict(ing, LBy=ing["LBy"] + sigma, UBy=ing["UBy"] - sigma)

    Hh = ing["H"] + rho * (ing["C"].T @ ing["C"])
    Hhi = np.linalg.inv(Hh)
    G = ing["G"]
    W = G @ Hhi @ G.T
    Winv = np.linalg.inv(W)
    M1 = Hhi @ G.T @ Winv @ G @ Hhi - Hhi
    M2 = (Hhi @ G.T @ Winv)[:, :n]
    C, d = ing["C"], ing["d"]
    Q, Te, Th = ing["Q"], ing["Te"], ing["Th"]
    Se, Sh = ing["Se"], ing["Sh"]
    qx0 = Q @ x0
    q = -np.concatenate([np.zeros(ns), Te @ xre + qx0, Th @ xrs,
                         Th @ xrc + qx0, Se @ ure, Sh @ urs, Sh @ urc])
    b = -ing["A"] @ x0

    s = np.zeros(n_s)
    lam = np.zeros(n_s)
    s_ant = s
    k = 0
    e_flag = 0
    rp = rd = np.inf
    z = None
    while e_flag == 0:
        k += 1
        q_hat = q + C.T @ (rho * (s - d) + lam)
        z = M1 @ q_hat + M2 @ b
        Czd = C @ z - d
        s_proj = -Czd - lam / rho
        s = s_proj.copy()
        s[:n_box] = np.clip(s_proj[:n_box], ing["box_LB"], ing["box_UB"])
        s[n_box:] = _hmpc_cone_proj_np(ing_t, s_proj[n_box:])
        resid = Czd + s
        lam = lam + rho * resid
        rp = np.max(np.abs(resid))
        rd = np.max(np.abs(s - s_ant))
        s_ant = s
        if rp <= tol_p and rd <= tol_d:
            e_flag = 1
        elif k >= k_max:
            e_flag = -1
    return z[:m].copy(), k, e_flag, dict(z=z, s=s, lam=lam, r_p=rp, r_d=rd)
