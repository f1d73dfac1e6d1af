"""Online (per call, batched) blocked Cholesky of the band KKT matrix W,
the time-varying mode's per-call ingredient recomputation.

The reference recomputes Alpha/Beta inside the generated C when
TIME_VARYING=1 via a scalar in-place blocked Cholesky recursion
(code_laxMPC_ADMM_C.c:150-279). Here the same recursion runs batched over
lanes as a loop of small-matrix operations over the stages: per stage,

    D_0     = B Rhat^-1 B' + diag(Qhat^-1)
    D_l     = A Qhat^-1 A' + B Rhat^-1 B' + diag(Qhat^-1)
              - Alpha_{l-1}' Alpha_{l-1}
    D_{N-1} = A Qhat^-1 A' + B Rhat^-1 B' + T_rho_i - Alpha' Alpha
    U_l     = chol(D_l) (upper),  Alpha_l = U_l^-T W_{l,l+1},
    W_{l,l+1} = -Qhat^-1 A'

returning per-lane (Alpha [B, N-1, n, n], BetaInv [B, N, n, n]) in the form
kernels.band_chol.band_chol_solve consumes (per-lane blocks). The equMPC
variant drops the terminal T block (its last stage uses the plain
diagonal D form, compute_equMPC_ADMM_ingredients.m truncation).

Port of spcies_tpu/kernels/online_band_chol.py as plain torch operations.
The factorization never reads its status on the host: torch.linalg.cholesky
would, and on a GPU that synchronises once a stage. A block that is not
positive definite gives NaN factors, as the JAX package's Cholesky does.
"""

from __future__ import annotations

import torch


def _chol_upper_inv(D):
    """Per-lane: U = chol(D) upper, returns (U^-T, U^-1) via one lower
    Cholesky + a triangular solve against I. Lanes whose block is not
    positive definite get NaN."""
    L, info = torch.linalg.cholesky_ex(D, check_errors=False)
    L = torch.where((info == 0)[:, None, None], L, float("nan"))
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(D), upper=False)
    # U = L^T  =>  U^-T = L^-1,  U^-1 = (L^-1)^T
    return Linv, Linv.transpose(-1, -2)


def online_band_chol_fn(N: int, terminal: bool):
    """Build the batched online factorization for a fixed horizon N.

    The returned fn(A, B, Qhat_inv, Rhat_inv, T_rho_i=None) takes per-lane
    A [Bz, n, n], B [Bz, n, m], diagonals Qhat_inv [Bz, n] /
    Rhat_inv [Bz, m] of (Q + rho I)^-1 etc., and (laxMPC, terminal=True)
    the dense (T + rho I)^-1 terminal block; equMPC (terminal=False) has no
    x_N variable, so its last diagonal block is [A B] Hhat^-1 [A B]' with
    no extra term. Returns (Alpha [Bz, N-1, n, n], BetaInv [Bz, N, n, n])
    in the per-lane form band_chol_solve consumes."""

    def fn(A, B, Qhat_inv, Rhat_inv, T_rho_i=None):
        AQiAt = torch.einsum("bik,bk,bjk->bij", A, Qhat_inv, A)
        BRiBt = torch.einsum("bik,bk,bjk->bij", B, Rhat_inv, B)
        diagQ = torch.diag_embed(Qhat_inv)
        # W_{l,l+1} = -Qhat^-1 A^T
        W_off = -Qhat_inv[:, :, None] * A.transpose(-1, -2)

        D0 = BRiBt + diagQ
        Uinv_T0, Uinv0 = _chol_upper_inv(D0)
        alphas = [Uinv_T0 @ W_off]
        uinvs = [Uinv0]

        D_mid = AQiAt + BRiBt + diagQ
        # stages 1 .. N-2 produce (Alpha_l, BetaInv_l)
        for _ in range(N - 2):
            a = alphas[-1]
            D = D_mid - a.transpose(-1, -2) @ a
            Uinv_T, Uinv = _chol_upper_inv(D)
            alphas.append(Uinv_T @ W_off)
            uinvs.append(Uinv)
        # terminal block
        a = alphas[-1]
        DN = AQiAt + BRiBt - a.transpose(-1, -2) @ a
        if terminal:
            DN = DN + T_rho_i
        _, UinvN = _chol_upper_inv(DN)
        uinvs.append(UinvN)
        return torch.stack(alphas, dim=1), torch.stack(uinvs, dim=1)

    return fn


def online_band_chol_tridiag(Wd, Wu):
    """Batched online block-tridiagonal Cholesky, the per-call mirror of
    utils.linalg.band_chol_blocks_tridiag for PER-LANE W blocks (the
    time-varying long-horizon path: every lane carries its own model, so
    the factorization happens inside the solve).

    Wd [B, Nb, b, b] diagonal blocks, Wu [B, Nb-1, b, b] super-diagonal
    blocks. Returns (Alpha [B, Nb-1, b, b], BetaInv [B, Nb, b, b]) in the
    per-lane form kernels.band_chol.band_chol_solve consumes. A loop over
    the Nb stages of small [B, b, b] operations, the recursion the
    reference's TIME_VARYING C runs per problem (code_laxMPC_ADMM_C.c:
    150-279), batched over lanes.
    """
    Nb = Wd.shape[1]
    alpha = torch.zeros_like(Wd[:, 0])
    alphas, uinvs = [], []
    for i in range(Nb):
        S = Wd[:, i] - alpha.transpose(-1, -2) @ alpha
        Uinv_T, Uinv = _chol_upper_inv(S)
        uinvs.append(Uinv)
        if i < Nb - 1:
            alpha = Uinv_T @ Wu[:, i]
            alphas.append(alpha)
    return torch.stack(alphas, dim=1), torch.stack(uinvs, dim=1)
