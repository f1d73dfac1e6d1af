"""Plain reference of laxMPC-ADMM: MPC with a terminal cost, solved by
box ADMM as Spcies defines it (code_laxMPC_ADMM_C.c; Krupa et al., IEEE
TCST 2020, eq. (9)).

    min  sum_{i<N} 1/2 ||x_i - xr||_Q^2 + 1/2 ||u_i - ur||_R^2
         + 1/2 ||x_N - xr||_T^2
    s.t. x_{i+1} = A x_i + B u_i,   LB <= (x_i, u_i) <= UB,   x_0 given

over z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}, x_N). ADMM on
z in the affine set, v in the box, with the scaled step rho and the
relaxation alpha:

    z     = argmin 1/2 z'(H + rho I)z + (q + lam - rho v)'z  s.t.  G z = b
    zr    = alpha z + (1 - alpha) v
    v+    = clip(zr + lam / rho, LB, UB)
    lam+  = lam + rho (zr - v+)
    stop at the first iteration with ||z - v+||_inf <= tol and
    ||v+ - v||_inf <= tol; u = v+[u_0].

The z-step is the plain direct form: each iteration applies the KKT
inverse to the whole linear term. The KKT inverse is computed here, from
the configuration, in float64.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from reference.common import Arith, masked_loop, plant_matrices


class Problem:
    """The QP data of one configuration, float64 NumPy."""

    def __init__(self, config: dict, T=None):
        A, B = plant_matrices(config)
        n, m, N = A.shape[0], B.shape[1], int(config["N"])
        w = config["weights"]
        Q, R = np.diag(w["Q"]), np.diag(w["R"])
        if T is None:
            T = scipy.linalg.solve_discrete_are(A, B, Q, R)
        nz = N * (n + m)
        s = config["solver"]
        self.rho = float(s["rho"])
        self.alpha = float(s.get("relax_alpha", 1.0))
        self.tol = float(s["tol"])
        self.k_max = int(s["k_max"])
        self.n, self.m, self.N, self.nz = n, m, N, nz
        self.A, self.B, self.Q, self.R, self.T = A, B, Q, R, T

        def u_at(i):                # column of u_i
            return i * (n + m) if i == 0 else m + (i - 1) * (n + m) + n

        def x_at(i):                # column of x_i, i >= 1
            return m + (i - 1) * (n + m)

        H = np.zeros((nz, nz))
        for i in range(N):
            H[u_at(i):u_at(i) + m, u_at(i):u_at(i) + m] = R
        for i in range(1, N):
            H[x_at(i):x_at(i) + n, x_at(i):x_at(i) + n] = Q
        H[x_at(N):x_at(N) + n, x_at(N):x_at(N) + n] = T
        # the dynamics, one block row a stage: x_{i+1} - A x_i - B u_i = 0,
        # the first with A x_0 on the right
        G = np.zeros((N * n, nz))
        for i in range(N):
            r = i * n
            G[r:r + n, x_at(i + 1):x_at(i + 1) + n] = np.eye(n)
            G[r:r + n, u_at(i):u_at(i) + m] = -B
            if i > 0:
                G[r:r + n, x_at(i):x_at(i) + n] = -A
        kkt = np.block([[H + self.rho * np.eye(nz), G.T],
                        [G, np.zeros((N * n, N * n))]])
        kinv = np.linalg.inv(kkt)
        # z = -Kinv[z, z] q_hat + Kinv[z, eq] b,  b = (A x_0, 0, ...)
        self.P_q = -kinv[:nz, :nz]
        self.P_x0 = kinv[:nz, nz:nz + n] @ A
        lb = [plant_bound(config, "LBu")]
        ub = [plant_bound(config, "UBu")]
        for _ in range(1, N):
            lb += [plant_bound(config, "LBx"), plant_bound(config, "LBu")]
            ub += [plant_bound(config, "UBx"), plant_bound(config, "UBu")]
        lb.append(plant_bound(config, "LBx"))
        ub.append(plant_bound(config, "UBx"))
        self.lb, self.ub = np.concatenate(lb), np.concatenate(ub)
        self.u_cols = slice(0, m)
        self.x_at, self.u_at = x_at, u_at

    def linear_cost(self, xr, ur):
        """q [B, nz] of each lane's set point (float64 NumPy)."""
        Bsz, n, m, N = xr.shape[0], self.n, self.m, self.N
        q = np.zeros((Bsz, self.nz))
        for i in range(N):
            q[:, self.u_at(i):self.u_at(i) + m] = -ur @ self.R.T
        for i in range(1, N):
            q[:, self.x_at(i):self.x_at(i) + n] = -xr @ self.Q.T
        q[:, self.x_at(N):self.x_at(N) + n] = -xr @ self.T.T
        return q


def plant_bound(config: dict, key: str):
    return np.asarray(config["plant"][key], float)


def solve(prob: Problem, x0, xr, ur, arith: Arith, init=None,
          k_max=None):
    """Run the ADMM on every lane of (x0, xr, ur) [B, .] (NumPy) from
    init = (v, lam) (zeros when None). Returns tensors on arith's device:
    u [B, m], k, e_flag [B] and the exit state v, lam [B, nz]."""
    t = arith.tensor
    P_q, P_x0, lb, ub = t(prob.P_q.T), t(prob.P_x0.T), t(prob.lb), t(prob.ub)
    q = t(prob.linear_cost(np.asarray(xr, float), np.asarray(ur, float)))
    zx0 = arith.mm(t(x0), P_x0)
    rho, alpha = prob.rho, prob.alpha
    if init is None:
        v, lam = torch.zeros_like(q), torch.zeros_like(q)
    else:
        v, lam = (a.to(arith.dtype) for a in init)

    def step(st, c):
        v, lam = st["v"], st["lam"]
        z = arith.mm(c["q"] + lam - rho * v, P_q) + c["zx0"]
        zr = alpha * z + (1.0 - alpha) * v
        v_new = torch.minimum(torch.maximum(zr + lam / rho, lb), ub)
        lam_new = lam + rho * (zr - v_new)
        r_p = torch.amax(torch.abs(z - v_new), dim=1)
        r_d = torch.amax(torch.abs(v_new - v), dim=1)
        conv = (r_p <= prob.tol) & (r_d <= prob.tol)
        return dict(v=v_new, lam=lam_new), conv

    with arith.products():
        st, k, e_flag = masked_loop(step, dict(v=v, lam=lam),
                                    dict(q=q, zx0=zx0), k_max or prob.k_max)
    return dict(u=st["v"][:, prob.u_cols], k=k, e_flag=e_flag,
                v=st["v"], lam=st["lam"])


def shift(prob: Problem, a):
    """The receding-horizon shift of a stagewise iterate [B, nz]: every
    stage moves one forward, the last input is kept, and the terminal
    state fills both the last stage's state and the terminal slot."""
    n, m, N = prob.n, prob.m, prob.N
    u1 = a[:, prob.u_at(1):prob.u_at(1) + m]
    mid = a[:, prob.x_at(2):prob.x_at(N)]          # stages 2..N-1
    uN1 = a[:, prob.u_at(N - 1):prob.u_at(N - 1) + m]
    xN = a[:, prob.x_at(N):prob.x_at(N) + n]
    return torch.cat([u1, mid, xN, uN1, xN], dim=1)


def closed_loop(prob: Problem, x0, xr, ur, steps: int, arith: Arith,
                warm_start: str = "shift"):
    """`steps` closed-loop steps of every lane: solve, apply u_0 to the
    plant x+ = A x + B u, carry (v, lam) shifted one stage into the next
    solve (cold when warm_start is not "shift"). Returns xs [steps+1, B,
    n], us [steps, B, m], ks and e_flags [steps, B], on arith's device."""
    A, B = arith.tensor(prob.A), arith.tensor(prob.B)
    x = arith.tensor(x0)
    xs, us, ks, es = [x], [], [], []
    init = None
    for _ in range(steps):
        out = solve(prob, x, xr, ur, arith, init=init)
        u = out["u"]
        with arith.products():
            x = arith.mm(x, A.T) + arith.mm(u, B.T)
        xs.append(x)
        us.append(u)
        ks.append(out["k"])
        es.append(out["e_flag"])
        if warm_start == "shift":
            init = (shift(prob, out["v"]), shift(prob, out["lam"]))
    return dict(xs=torch.stack(xs), us=torch.stack(us), ks=torch.stack(ks),
                e_flags=torch.stack(es))


def answers(prob: Problem, traffic: dict, batch, arith: Arith) -> dict:
    """The reference's answer to one pool batch, under the names the
    caller reads back: (u, k, e_flag) of one solve, or the closed loop's
    (xs, us, ks, e_flags)."""
    x0, xr, ur = batch
    if traffic["driver"] == "rollout":
        if traffic["warm_start"] not in ("shift", False):
            raise ValueError(f"the reference runs cold or shifted warm "
                             f"starts; got {traffic['warm_start']!r}")
        return closed_loop(prob, x0, xr, ur, int(traffic["steps"]), arith,
                           warm_start=traffic["warm_start"])
    out = solve(prob, x0, xr, ur, arith)
    return dict(u=out["u"], k=out["k"], e_flag=out["e_flag"])
