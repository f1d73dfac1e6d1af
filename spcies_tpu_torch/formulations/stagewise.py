"""Structured stagewise operators shared by the banded backends.

The decision vector of the laxMPC/equMPC family is stage-ordered
z = (u_0, x_1, u_1, ..., x_{N-1}, u_{N-1}[, x_N]) and the equality matrix G
is block-banded (reference Aeq construction,
compute_laxMPC_ADMM_ingredients.m:80-86 /
compute_equMPC_ADMM_ingredients.m:85). Instead of materializing G, these
helpers apply G and G^T blockwise, each block a small batched product, and
memory stays O(N n (n+m)) like the reference's banded C loops
(code_laxMPC_ADMM_C.c:355-381, :453-485).

Layout convention: z splits into z0 [B, m] (u_0), zm [B, N-1, n+m]
(stages 1..N-1), and optionally zN [B, n] (x_N, `terminal=True`).
Multiplier blocks mu are [B, N, n].

Port of spcies_tpu/formulations/stagewise.py.
"""

from __future__ import annotations

import torch


def split_z(z, n, m, N, terminal):
    B = z.shape[0]
    z0 = z[:, :m]
    zm = z[:, m:m + (N - 1) * (n + m)].reshape(B, N - 1, n + m)
    zN = z[:, -n:] if terminal else None
    return z0, zm, zN


def join_z(z0, zm, zN):
    B = z0.shape[0]
    parts = [z0, zm.reshape(B, -1)]
    if zN is not None:
        parts.append(zN)
    return torch.cat(parts, dim=-1)


def g_apply(z0, zm, zN, A_, B_, AB):
    """G z -> [B, N, n]. Row 0: B u0 - x1; row l: [A B](x_l,u_l) - x_{l+1}
    (x_N present only when terminal). A_/B_/AB may carry a leading batch
    dim (per-lane model matrices, time-varying mode)."""
    n = A_.shape[-2]
    if AB.ndim == 3:
        r0 = torch.einsum("bj,bij->bi", z0, B_) - zm[:, 0, :n]
        r_mid = (torch.einsum("blj,bij->bli", zm[:, :-1], AB)
                 - zm[:, 1:, :n])
        r_last = torch.einsum("bj,bij->bi", zm[:, -1], AB)
    else:
        r0 = z0 @ B_.T - zm[:, 0, :n]
        r_mid = zm[:, :-1] @ AB.T - zm[:, 1:, :n]
        r_last = zm[:, -1] @ AB.T
    if zN is not None:
        r_last = r_last - zN
    return torch.cat([r0[:, None], r_mid, r_last[:, None]], dim=1)


def gt_apply(mu, n, m, B_, AB, terminal):
    """G^T mu -> flat [B, nz]. u_0 gets B^T mu_0; stage block l (=(x_l,u_l),
    l=1..N-1) gets [A B]^T mu_l - (mu_{l-1} on the x part); x_N (terminal)
    gets -mu_{N-1}. B_/AB may carry a leading batch dim."""
    if AB.ndim == 3:
        g0 = torch.einsum("bi,bij->bj", mu[:, 0], B_)
        gm = torch.einsum("bli,bij->blj", mu[:, 1:], AB)
    else:
        g0 = mu[:, 0] @ B_
        gm = mu[:, 1:] @ AB
    gm = torch.cat([gm[..., :n] - mu[:, :-1], gm[..., n:]], dim=-1)
    gN = -mu[:, -1] if terminal else None
    return join_z(g0, gm, gN)


def make_banded_eq_qp(ing, dtype, terminal, parallel_scan=False,
                      device="cpu"):
    """Build the banded equality-QP solve shared by laxMPC / equMPC /
    ellipMPC ADMM backends:

        z = argmin 0.5 z'Hhat z + q_hat'z  s.t.  G z = beq
          = -Hinv (q_hat + G' mu),   W mu = -G Hinv q_hat - beq

    with W's offline Alpha/Beta band-Cholesky blocks (the reference hot
    loop, code_laxMPC_ADMM_C.c:355-485). `ing` must provide n, m, N, A, B,
    AB, Hi_0 [m], Hi_mid [N-1, n+m] (diagonal Hinv blocks), Hi_N [n, n]
    (dense terminal block, terminal=True only), Alpha, Beta. Its tensors
    live on `device`.

    Returns z_step(q_hat [B, nz], rhs_extra [B, N, n] | None) where
    rhs_extra = -beq stacked per stage (None for the pure linear map used
    by the delta-form iteration).

    parallel_scan=True routes the band solve through the O(log N)-depth
    scan (kernels.band_chol.BandSolve, band_chol_solve_scan's) for long
    horizons. The products of the fixed blocks are formed once, here, in
    fp64 on the host.
    """
    from spcies_tpu_torch.kernels.band_chol import BandSolve, beta_inverses
    n, m, N = ing["n"], ing["m"], ing["N"]

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    band_solve = BandSolve(
        *(torch.as_tensor(a) for a in beta_inverses(ing["Alpha"],
                                                    ing["Beta"])),
        scan=parallel_scan, dtype=dtype, device=device)
    AB, A_, B_, Hi_0, Hi_mid = (dev(ing[key]) for key in
                                ("AB", "A", "B", "Hi_0", "Hi_mid"))
    Hi_N = dev(ing["Hi_N"]) if terminal else None

    def hinv_apply(q):
        q0, qm, qN = split_z(q, n, m, N, terminal)
        return (Hi_0 * q0, Hi_mid * qm,
                qN @ Hi_N.T if terminal else None)

    def z_step(q_hat, rhs_extra=None):
        h0, hm, hN = hinv_apply(q_hat)
        rhs = -g_apply(h0, hm, hN, A_, B_, AB)
        if rhs_extra is not None:
            rhs = rhs + rhs_extra
        mu = band_solve(rhs)
        g0, gm, gN = split_z(gt_apply(mu, n, m, B_, AB, terminal),
                             n, m, N, terminal)
        z0 = -(h0 + Hi_0 * g0)
        zm = -(hm + Hi_mid * gm)
        zN = -(hN + gN @ Hi_N.T) if terminal else None
        return join_z(z0, zm, zN)

    return z_step
