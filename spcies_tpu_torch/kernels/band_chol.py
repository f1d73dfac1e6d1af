"""Banded block-Cholesky solve, the toolbox's signature KKT solve.

Solves W mu = rhs for block-tridiagonal SPD W given its Cholesky factor's
diagonal blocks Beta and super-diagonal blocks Alpha (W = U^T U). This is
the stagewise forward+backward substitution at the heart of the reference's
laxMPC/equMPC/MPCT/ellipMPC solvers (canonical standalone version:
code_laxMPC_FISTA_C.c:577-652, `solve_W_matrix_form`).

Port of spcies_tpu/kernels/band_chol.py as plain torch operations (no hand
kernel: the file sits under kernels/ because the JAX package puts it
there). Each Beta block's full inverse is precomputed offline, so the
online recursion is 2N dependent small products batched over the B
lanes; on a GPU each is a launch of its own, and the products of the
blocks alone are formed once a W (BandSolve). Row-vector convention
throughout: y_l = (rhs_l - y_{l-1} Alpha_{l-1}) BetaInv_l,
mu_l = (y_l - mu_{l+1} Alpha_l^T) BetaInv_l^T.
"""

from __future__ import annotations

import numpy as np
import torch


def beta_inverses(Alpha: np.ndarray, Beta: np.ndarray):
    """Offline: convert reference-style (Alpha, Beta-with-inverted-diagonal)
    blocks (utils.linalg.band_chol_blocks output) into (Alpha, BetaInv)
    with full upper-triangular inverses, the form the solves consume."""
    N, n, _ = Beta.shape
    BetaInv = np.zeros_like(Beta)
    for i in range(N):
        U = Beta[i].copy()
        d = 1.0 / np.diag(U)  # undo the reference's diagonal inversion
        U[np.arange(n), np.arange(n)] = d
        BetaInv[i] = np.linalg.inv(U)
    return Alpha, BetaInv


class BandSolve:
    """W mu = rhs from W's band-Cholesky blocks (W = U^T U; Alpha the
    super-diagonal blocks of U, BetaInv the inverses of its diagonal
    blocks), with every product that does not depend on rhs formed once,
    here rather than in each solve: a solver's ADMM or FISTA iteration
    solves with the same W many times.

    Both substitutions are affine recursions over the stages,

        y_l  = rhs_l BetaInv_l - y_{l-1} P_l,        P_l = Alpha_{l-1} BetaInv_l
        mu_l = y_l BetaInv_l^T - mu_{l+1} Q_l,       Q_l = Alpha_l^T BetaInv_l^T

    run sequentially (one fused multiply-add a stage: 2N - 2 dependent
    products a solve) or, with scan=True, by Hillis-Steele doubling in
    ceil(log2 N) rounds a sweep, whose composed matrices are formed here
    too. Alpha [N-1, n, n] and BetaInv [N, n, n] are shared by the lanes;
    [B, N-1, n, n] and [B, N, n, n] give each lane its own (the
    time-varying mode). The products are formed in the blocks' dtype and
    device, then moved to `dtype` and `device` where given (a builder
    forms them from the fp64 offline blocks on the host)."""

    def __init__(self, Alpha, BetaInv, scan=False, dtype=None, device=None):
        self.batched = Alpha.ndim == 4
        self.scan = scan
        AlT = Alpha.transpose(-1, -2)
        BiT = BetaInv.transpose(-1, -2)
        stage = 1 if self.batched else 0
        P = Alpha @ BetaInv.narrow(stage, 1, BetaInv.shape[stage] - 1)
        Q = AlT @ BiT.narrow(stage, 0, BetaInv.shape[stage] - 1)

        def to(t):
            return t.to(dtype=dtype or t.dtype, device=device or t.device)

        self.BetaInv = to(BetaInv)
        if scan:
            zero = torch.zeros_like(P.narrow(stage, 0, 1))
            self.fwd_levels = [to(M) for M in _scan_levels(
                torch.cat([zero, -P], dim=stage))]
            self.bwd_levels = [to(M) for M in _scan_levels(
                torch.cat([zero, -Q.flip(stage)], dim=stage))]
        else:
            # one block a stage, stage-major and contiguous
            self.P = to(P.transpose(0, 1) if self.batched else P
                        ).contiguous().unbind(0)
            self.Q = to(Q.transpose(0, 1) if self.batched else Q
                        ).contiguous().unbind(0)

    def __call__(self, rhs):
        """rhs [B, N, n] -> mu [B, N, n]."""
        if self.scan:
            return self._solve_scan(rhs)
        N = rhs.shape[1]
        if self.batched:
            # per-lane blocks: rows kept as [B, 1, n] for baddbmm
            Rb = torch.einsum("bli,blij->lbj", rhs, self.BetaInv)
            r = Rb.unsqueeze(2).unbind(0)
            y = [r[0]]
            for l in range(1, N):
                y.append(torch.baddbmm(r[l], y[l - 1], self.P[l - 1],
                                       alpha=-1))
            Yb = torch.einsum("lbi,blji->lbj", torch.cat(y, dim=1)
                              .transpose(0, 1), self.BetaInv)
            g = Yb.unsqueeze(2).unbind(0)
            mu = [None] * N
            mu[N - 1] = g[N - 1]
            for l in range(N - 2, -1, -1):
                mu[l] = torch.baddbmm(g[l], mu[l + 1], self.Q[l], alpha=-1)
            return torch.cat(mu, dim=1)
        r = torch.einsum("bli,lij->lbj", rhs, self.BetaInv).unbind(0)
        y = [r[0]]
        for l in range(1, N):
            y.append(torch.addmm(r[l], y[l - 1], self.P[l - 1], alpha=-1))
        g = torch.einsum("lbi,lji->lbj", torch.stack(y),
                         self.BetaInv).unbind(0)
        mu = [None] * N
        mu[N - 1] = g[N - 1]
        for l in range(N - 2, -1, -1):
            mu[l] = torch.addmm(g[l], mu[l + 1], self.Q[l], alpha=-1)
        return torch.stack(mu, dim=1)

    def _solve_scan(self, rhs):
        if self.batched:
            c = torch.einsum("bli,blij->blj", rhs, self.BetaInv)
            y = _scan_apply(self.fwd_levels, c)
            g = torch.einsum("bli,blji->blj", y, self.BetaInv)
        else:
            c = torch.einsum("bli,lij->blj", rhs, self.BetaInv)
            y = _scan_apply(self.fwd_levels, c)
            g = torch.einsum("bli,lji->blj", y, self.BetaInv)
        return _scan_apply(self.bwd_levels, g.flip(1)).flip(1)


def _scan_levels(M):
    """The composed matrices of the Hillis-Steele scan of y_l = y_{l-1}
    M_l + c_l (M_0 = 0): round r at distance d = 2^r composes every stage
    l >= d with stage l - d, (M, c)_l <- (M_{l-d} M_l, c_{l-d} M_l + c_l).
    M [N, n, n] or [B, N, n, n]; returns, a round each, the M_l (l >= d)
    that round's c-update multiplies by."""
    stage = M.ndim - 3
    N = M.shape[stage]
    levels = []
    d = 1
    while d < N:
        Md = M.narrow(stage, d, N - d)
        levels.append(Md)
        if 2 * d < N:       # the last round needs no composed M
            M = torch.cat([M.narrow(stage, 0, d),
                           M.narrow(stage, 0, N - d) @ Md], dim=stage)
        d *= 2
    return levels


def _scan_apply(levels, c):
    """The inclusive scan's c-updates over c [B, N, n] (y_0 = c_0)."""
    d = 1
    for Md in levels:
        eq = "bli,blij->blj" if Md.ndim == 4 else "bli,lij->blj"
        c = torch.cat([c[:, :d], torch.einsum(eq, c[:, :-d], Md)
                       + c[:, d:]], dim=1)
        d *= 2
    return c


def band_chol_solve(rhs, Alpha, BetaInv):
    """Solve W mu = rhs with W = U^T U block-bidiagonal Cholesky structure.

    rhs:     [B, N, n]  stacked per-stage right-hand sides
    Alpha:   [N-1, n, n] super-diagonal blocks of U (or per lane
             [B, N-1, n, n], the time-varying mode's factors)
    BetaInv: [N, n, n]   inverses of the diagonal blocks of U (or
             [B, N, n, n])
    returns  [B, N, n]
    A solver that solves with the same W again builds BandSolve once.
    """
    return BandSolve(Alpha, BetaInv)(rhs)


def band_chol_solve_scan(rhs, Alpha, BetaInv):
    """Parallel-over-the-horizon variant of band_chol_solve: both
    substitutions compose as affine (M, c) pairs in O(log N) depth
    (BandSolve with scan=True) instead of 2N dependent steps.

    Same signature and result as band_chol_solve (fp64 agreement to
    roundoff; the composition order differs from the sequential solve's
    and from the JAX package's associative_scan). The composed matrices,
    O(N log N) small products (once, not per lane, for shared blocks),
    depend on W alone; a solve applies about 4 launches a round.
    """
    return BandSolve(Alpha, BetaInv, scan=True)(rhs)
