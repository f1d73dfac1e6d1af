"""Plain reference of HMPC-ADMM-split: harmonic MPC (Krupa, Limon,
Alamo, arXiv:2202.06629) solved by the two-block split ADMM of Spcies
(spcies_HMPC_ADMM_split_solver.m, code_HMPC_ADMM_split_C.c), with the
diamond sets of its box-constrained form.

The terminal artificial reference is a harmonic signal of base frequency
w: x_h(t) = xe + xs sin(wt) + xc cos(wt), u_h(t) = ue + us sin(wt) +
uc cos(wt). Over z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, xe, xs, xc,
ue, us, uc):

    min  sum_{j<N} 1/2 ||x_j - x_h(j)||_Q^2 + 1/2 ||u_j - u_h(j)||_R^2
         + 1/2 ||xe - xr||_Te^2 + 1/2 ||xs||_Th^2 + 1/2 ||xc||_Th^2
         + 1/2 ||ue - ur||_Se^2 + 1/2 ||us||_Sh^2 + 1/2 ||uc||_Sh^2
    s.t. x_{j+1} = A x_j + B u_j (j < N-1),  x_0 given,
         A x_{N-1} + B u_{N-1} = x_h(N),
         the harmonic is a trajectory of the plant:
         xe = A xe + B ue,  A xs + B us = cos(w) xs - sin(w) xc,
         A xc + B uc = sin(w) xs + cos(w) xc,
         LB <= (x_j, u_j) <= UB on the stages,
         for each output y (every state and input), s_y = (y_e, y_s, y_c)
         in the diamond D_y = {|(y_s, y_c)| <= y_e - LB_y} and
         {|(y_s, y_c)| <= UB_y - y_e}.

The split ADMM keeps (z_hat, s_hat) in the affine set and (z, s) in the
box and the diamonds, with steps sigma (on z) and rho (on s):

    (z_hat, s_hat) = argmin 1/2 z'(H + sigma I)z + (q + lam - sigma z)'z
                     + 1/2 rho |s|^2 + (mu - rho s)'s
                     s.t. the equalities and s = C z
    z+   = box(z_hat + lam / sigma)           (the harmonic part free)
    s+   = diamonds(s_hat + mu / rho)
    lam += sigma (z_hat - z+),  mu += rho (s_hat - s+)
    stop at the first iteration with max(|z_hat - z+|, |s_hat - s+|) <=
    tol_p and max(|z+ - z|, |s+ - s|) <= tol_d; u = z+[u_0].

The diamond projection is Spcies's own (+sp_utils/proj_D.m): the
projection onto the first cone, then onto the second. The KKT inverse is
computed here, from the configuration, in float64, and applied to the
whole linear term every iteration (the direct form).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.common import Arith, masked_loop, plant_matrices


class Problem:
    """The QP data of one configuration, float64 NumPy."""

    def __init__(self, config: dict):
        A, B = plant_matrices(config)
        n, m, N = A.shape[0], B.shape[1], int(config["N"])
        wts = config["weights"]
        Q, R = np.diag(wts["Q"]), np.diag(wts["R"])
        Te, Th = np.diag(wts["Te"]), np.diag(wts["Th"])
        Se, Sh = np.diag(wts["Se"]), np.diag(wts["Sh"])
        w = float(config["w"])
        s = config["solver"]
        self.sigma, self.rho = float(s["sigma"]), float(s["rho"])
        self.tol_p, self.tol_d = float(s["tol_p"]), float(s["tol_d"])
        self.k_max = int(s["k_max"])
        ns = m + (N - 1) * (n + m)
        dim = ns + 3 * (n + m)
        ny = n + m
        self.n, self.m, self.N, self.ns, self.dim = n, m, N, ns, dim
        self.A, self.B = A, B

        def u_at(j):
            return 0 if j == 0 else m + (j - 1) * (n + m) + n

        def x_at(j):                # j >= 1
            return m + (j - 1) * (n + m)

        xe, xs, xc = ns, ns + n, ns + 2 * n
        ue, us, uc = ns + 3 * n, ns + 3 * n + m, ns + 3 * n + 2 * m
        self.xe, self.xc, self.ue = xe, xc, ue

        # the cost as a sum of weighted residuals 1/2 |L z - c|_W^2: H is
        # the sum of L'WL; the parts of c that depend on the lane's inputs
        # are added per lane in linear_cost
        H = np.zeros((dim, dim))

        def add(L, W):
            nonlocal H
            H += L.T @ W @ L

        def sel(col, size):
            L = np.zeros((size, dim))
            L[:, col:col + size] = np.eye(size)
            return L

        for j in range(N):
            sj, cj = np.sin(w * j), np.cos(w * j)
            Lu = sel(u_at(j), m) - sel(ue, m) - sj * sel(us, m) \
                - cj * sel(uc, m)
            add(Lu, R)
            if j == 0:
                # x_0 is given: 1/2 |x_0 - xe - xc|_Q^2
                add(-sel(xe, n) - sel(xc, n), Q)
            else:
                add(sel(x_at(j), n) - sel(xe, n) - sj * sel(xs, n)
                    - cj * sel(xc, n), Q)
        add(sel(xe, n), Te)
        add(sel(xs, n), Th)
        add(sel(xc, n), Th)
        add(sel(ue, m), Se)
        add(sel(us, m), Sh)
        add(sel(uc, m), Sh)
        self.Q, self.Te, self.Se = Q, Te, Se

        # equalities E z = b, b = (A x_0, 0, ...)
        rows = []

        def eq(blocks):
            r = np.zeros((n, dim))
            for col, M in blocks:
                r[:, col:col + M.shape[1]] += M
            rows.append(r)

        I = np.eye(n)
        eq([(x_at(1), I), (u_at(0), -B)])
        for j in range(1, N - 1):
            eq([(x_at(j + 1), I), (x_at(j), -A), (u_at(j), -B)])
        eq([(x_at(N - 1), A), (u_at(N - 1), B), (xe, -I),
            (xs, -np.sin(w * N) * I), (xc, -np.cos(w * N) * I)])
        cw, sw = np.cos(w), np.sin(w)
        eq([(xe, A - I), (ue, B)])
        eq([(xs, A - cw * I), (xc, sw * I), (us, B)])
        eq([(xs, -sw * I), (xc, A - cw * I), (uc, B)])
        E = np.vstack(rows)
        n_eq = E.shape[0]
        # s = C z: output y's (e, s, c) components, outputs in the order
        # of the state, then the input
        C = np.zeros((3 * ny, dim))
        for y in range(ny):
            for part, (xcol, ucol) in enumerate(((xe, ue), (xs, us),
                                                 (xc, uc))):
                if y < n:
                    C[3 * y + part, xcol + y] = 1.0
                else:
                    C[3 * y + part, ucol + y - n] = 1.0
        n_s = C.shape[0]
        self.n_s = n_s
        # KKT of (z, s, eq multipliers, s-multipliers)
        sz = dim + n_s
        kkt = np.zeros((sz + n_eq + n_s, sz + n_eq + n_s))
        kkt[:dim, :dim] = H + self.sigma * np.eye(dim)
        kkt[dim:sz, dim:sz] = self.rho * np.eye(n_s)
        kkt[sz:sz + n_eq, :dim] = E
        kkt[sz + n_eq:, :dim] = C
        kkt[sz + n_eq:, dim:sz] = -np.eye(n_s)
        kkt[:, sz:] = kkt[sz:, :].T
        kinv = np.linalg.inv(kkt)
        # (z, s) = -Kinv[zs, zs] (qz, qs) + Kinv[zs, eq][:, :n] A x_0
        self.P_q = -kinv[:sz, :sz]
        self.P_x0 = kinv[:sz, sz:sz + n] @ A

        plant = config["plant"]
        LBx, UBx = np.asarray(plant["LBx"], float), np.asarray(plant["UBx"],
                                                               float)
        LBu, UBu = np.asarray(plant["LBu"], float), np.asarray(plant["UBu"],
                                                               float)
        self.box_lb = np.concatenate([LBu] + [np.concatenate([LBx, LBu])]
                                     * (N - 1))
        self.box_ub = np.concatenate([UBu] + [np.concatenate([UBx, UBu])]
                                     * (N - 1))
        self.lby = np.concatenate([LBx, LBu])
        self.uby = np.concatenate([UBx, UBu])

    def linear_cost(self, x0, xr, ur):
        """q [B, dim] of each lane (float64 NumPy): the linear terms of
        |x_0 - xe - xc|_Q^2, |xe - xr|_Te^2 and |ue - ur|_Se^2."""
        n, m = self.n, self.m
        q = np.zeros((x0.shape[0], self.dim))
        qx0 = x0 @ self.Q.T
        q[:, self.xe:self.xe + n] = -qx0 - xr @ self.Te.T
        q[:, self.xc:self.xc + n] = -qx0
        q[:, self.ue:self.ue + m] = -ur @ self.Se.T
        return q


def proj_shifted_cone(y, sign: float, bound):
    """Projection of y [..., 3] onto {|(y1, y2)| <= sign (y0 - bound)}
    (Spcies +sp_utils/proj_SSOC.m)."""
    y0, y1 = y[..., 0], y[..., 1:]
    r = torch.linalg.vector_norm(y1, dim=-1)
    room = sign * (y0 - bound)
    inside = r <= room
    apex = r <= -room
    t = (room + r) / 2.0
    safe = torch.where(r > 0, r, torch.ones_like(r))
    on0 = bound + sign * t
    on1 = y1 * (t / safe)[..., None]
    p0 = torch.where(inside, y0, torch.where(apex, bound + 0.0 * y0, on0))
    p1 = torch.where(inside[..., None], y1,
                     torch.where(apex[..., None], torch.zeros_like(y1), on1))
    return torch.cat([p0[..., None], p1], dim=-1)


def proj_diamond(y, lb, ub):
    """Spcies's diamond step (+sp_utils/proj_D.m): onto {|y_12| <= y0 -
    lb}, then onto {|y_12| <= ub - y0}."""
    return proj_shifted_cone(proj_shifted_cone(y, 1.0, lb), -1.0, ub)


def solve(prob: Problem, x0, xr, ur, arith: Arith, k_max=None):
    """Run the split ADMM on every lane of (x0, xr, ur) [B, .] from zero
    iterates. Returns tensors on arith's device: u [B, m], k, e_flag."""
    t = arith.tensor
    x0n = np.asarray(x0, float)
    q = t(prob.linear_cost(x0n, np.asarray(xr, float),
                           np.asarray(ur, float)))
    P_q, P_x0 = t(prob.P_q.T), t(prob.P_x0.T)
    zs_x0 = arith.mm(t(x0n), P_x0)
    box_lb, box_ub = t(prob.box_lb), t(prob.box_ub)
    lby, uby = t(prob.lby), t(prob.uby)
    Bsz, dim, ns = q.shape[0], prob.dim, prob.ns
    sigma, rho = prob.sigma, prob.rho
    zeros = torch.zeros((Bsz, dim), dtype=arith.dtype, device=arith.device)
    zeros_s = torch.zeros((Bsz, prob.n_s), dtype=arith.dtype,
                          device=arith.device)

    def step(st, c):
        z, s, lam, mu = st["z"], st["s"], st["lam"], st["mu"]
        q_hat = torch.cat([c["q"] + lam - sigma * z, mu - rho * s], dim=1)
        zs = arith.mm(q_hat, P_q) + c["zs_x0"]
        z_hat, s_hat = zs[:, :dim], zs[:, dim:]
        w = z_hat + lam / sigma
        z_new = torch.cat([torch.minimum(torch.maximum(w[:, :ns], box_lb),
                                         box_ub), w[:, ns:]], dim=1)
        s_new = proj_diamond((s_hat + mu / rho).reshape(len(s), -1, 3),
                             lby, uby).reshape(len(s), -1)
        lam_new = lam + sigma * (z_hat - z_new)
        mu_new = mu + rho * (s_hat - s_new)
        r_p = torch.maximum(torch.amax(torch.abs(z_hat - z_new), dim=1),
                            torch.amax(torch.abs(s_hat - s_new), dim=1))
        r_d = torch.maximum(torch.amax(torch.abs(z_new - z), dim=1),
                            torch.amax(torch.abs(s_new - s), dim=1))
        conv = (r_p <= prob.tol_p) & (r_d <= prob.tol_d)
        return dict(z=z_new, s=s_new, lam=lam_new, mu=mu_new), conv

    with arith.products():
        st, k, e_flag = masked_loop(
            step, dict(z=zeros, s=zeros_s, lam=zeros.clone(),
                       mu=zeros_s.clone()),
            dict(q=q, zs_x0=zs_x0), k_max or prob.k_max)
    return dict(u=st["z"][:, :prob.m], k=k, e_flag=e_flag)


def answers(prob: Problem, traffic: dict, batch, arith: Arith) -> dict:
    """The reference's answer to one pool batch: (u, k, e_flag) of one
    solve."""
    if traffic["driver"] != "requests":
        raise ValueError("the HMPC-ADMM-split reference answers single "
                         "solves")
    out = solve(prob, *batch, arith)
    return dict(u=out["u"], k=out["k"], e_flag=out["e_flag"])
