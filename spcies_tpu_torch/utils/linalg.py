"""Offline (host-side, fp64 numpy/scipy) linear-algebra helpers.

These run once at solver-construction time, playing the role of the
reference's MATLAB ingredient computations (e.g.
formulations/+laxMPC/compute_laxMPC_ADMM_ingredients.m). Outputs are plain
numpy arrays packed into ingredient dicts; the builders move what the
online loop needs onto the solver's device.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def c2d_zoh(A: np.ndarray, B: np.ndarray, Ts: float):
    """Zero-order-hold discretization of a continuous LTI system, the
    equivalent of MATLAB's c2d used by the reference fixtures
    (tests/spcies_tester.m:101, +sp_utils/example_OscMass.m:30)."""
    n = A.shape[0]
    m = B.shape[1]
    M = np.zeros((n + m, n + m))
    M[:n, :n] = A
    M[:n, n:] = B
    E = scipy.linalg.expm(M * Ts)
    return E[:n, :n], E[:n, n:]


def dlqr_P(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray):
    """Solution P of the discrete algebraic Riccati equation — the `[~, T] =
    dlqr(A, B, Q, R)` cost-to-go used as terminal cost by the reference
    examples (+sp_utils/example_OscMass.m:52, tests/test_laxMPC_ADMM.m:14)."""
    return scipy.linalg.solve_discrete_are(A, B, Q, R)


def blkdiag(*mats: np.ndarray) -> np.ndarray:
    return scipy.linalg.block_diag(*mats)


def mpc_equality_matrix(A: np.ndarray, B: np.ndarray, N: int,
                        drop_terminal: bool = False) -> np.ndarray:
    """Banded equality matrix G for the stacked prediction-model constraints
    over decision vector z = (u0, x1, u1, ..., x_{N-1}, u_{N-1}, x_N).

    Row block 0:      B u0 - x1            = -A x0
    Row block l>=1:   A x_l + B u_l - x_{l+1} = 0

    Equivalent to the Aeq construction in
    compute_laxMPC_ADMM_ingredients.m:80-86 (kron + (-I) insertion). With
    drop_terminal=True the x_N columns are removed (equMPC,
    compute_equMPC_ADMM_ingredients.m:85) and the last row block's RHS
    becomes A x_{N-1} + B u_{N-1} = x_r.
    """
    n, m = A.shape[0], B.shape[1]
    nz = N * (n + m) - (n if drop_terminal else 0)
    G = np.zeros((N * n, nz))
    # row block 0: [B, -I, 0 ...]
    G[:n, :m] = B
    if not drop_terminal or N > 1:
        G[:n, m:m + n] = -np.eye(n)
    # row blocks l = 1..N-1 over stage variables (x_l, u_l) at column offset
    for l in range(1, N):
        r = l * n
        c = m + (l - 1) * (n + m)
        G[r:r + n, c:c + n] = A
        G[r:r + n, c + n:c + n + m] = B
        c_next = m + l * (n + m)
        if l < N - 1 or not drop_terminal:
            G[r:r + n, c_next:c_next + n] = -np.eye(n)
    return G


def band_chol_blocks(W: np.ndarray, n: int, N: int):
    """Extract the Alpha/Beta block representation of chol(W) for a
    block-tridiagonal SPD matrix W of size (N*n, N*n).

    Beta[i]  = n x n upper-triangular diagonal block of chol(W), with its
               diagonal entries stored *inverted* (the reference does this
               offline so the online substitutions only multiply:
               compute_laxMPC_ADMM_ingredients.m:170-183).
    Alpha[i] = n x n super-diagonal block i of chol(W), i = 0..N-2.
    """
    Wc = np.linalg.cholesky(W).T  # upper-triangular factor, MATLAB chol()
    Beta = np.zeros((N, n, n))
    Alpha = np.zeros((N - 1, n, n))
    for i in range(N):
        blk = Wc[i * n:(i + 1) * n, i * n:(i + 1) * n].copy()
        d = np.diag(blk).copy()
        blk[np.arange(n), np.arange(n)] = 1.0 / d
        Beta[i] = blk
    for i in range(N - 1):
        Alpha[i] = Wc[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n]
    return Alpha, Beta


def band_chol_blocks_tridiag(Wd: np.ndarray, Wu: np.ndarray):
    """Alpha/BetaInv directly from the block-tridiagonal BLOCKS of W,
    never forming dense W (the O(N)-memory long-horizon path; contrast
    band_chol_blocks, which slices a dense W).

    Wd [Nb, b, b] diagonal blocks, Wu [Nb-1, b, b] super-diagonal blocks;
    W = U'U with U block-bidiagonal. Returns (Alpha [Nb-1, b, b] =
    U_{i,i+1}, BetaInv [Nb, b, b] = inv(U_ii)) in the form
    kernels.band_chol.band_chol_solve consumes. O(Nb b^3) offline."""
    Nb, b, _ = Wd.shape
    Alpha = np.zeros((Nb - 1, b, b))
    BetaInv = np.zeros((Nb, b, b))
    prev = np.zeros((b, b))
    eye = np.eye(b)
    for i in range(Nb):
        S = Wd[i] - prev.T @ prev
        U = scipy.linalg.cholesky(S, lower=False)
        BetaInv[i] = scipy.linalg.solve_triangular(U, eye, lower=False)
        if i < Nb - 1:
            Alpha[i] = scipy.linalg.solve_triangular(U.T, Wu[i], lower=True)
            prev = Alpha[i]
    return Alpha, BetaInv


def full2csr(M: np.ndarray, tol: float = 1e-14):
    """Dense -> CSR triplet (val, col, row_ptr), the host-side analogue of
    +sp_utils/full2CSR.m. Only used offline; the online solvers use
    structured dense forms instead of generic sparsity."""
    nr, nc = M.shape
    val, col, row_ptr = [], [], [0]
    for i in range(nr):
        for j in range(nc):
            if abs(M[i, j]) > tol:
                val.append(M[i, j])
                col.append(j)
        row_ptr.append(len(val))
    return np.asarray(val), np.asarray(col, dtype=np.int32), \
        np.asarray(row_ptr, dtype=np.int32)


def ldl_factor(W: np.ndarray):
    """LDL^T factorization via Cholesky (reference +sp_utils/full2LDL.m:16-34):
    W = L D L^T with unit-lower-triangular L. Returns (L, d)."""
    C = np.linalg.cholesky(W)
    d = np.diag(C) ** 2
    L = C / np.diag(C)[None, :]
    return L, d


def full2csc(M: np.ndarray, tol: float = 1e-14):
    """Dense -> CSC triplet (val, row, col_ptr), the host-side analogue of
    +sp_utils/full2CSC.m:25-44 (computed as CSR of the transpose)."""
    val, row, col_ptr = full2csr(np.asarray(M).T, tol)
    return val, row, col_ptr


def csr_matvec(val, col, row_ptr, x):
    """CSR sparse mat-vec (+sp_utils/smv.m:23-35). Host-side reference; the
    online solvers use structured dense forms instead of generic sparsity
    (SURVEY.md §7)."""
    nr = len(row_ptr) - 1
    y = np.zeros(nr)
    for i in range(nr):
        for j in range(row_ptr[i], row_ptr[i + 1]):
            y[i] += val[j] * x[col[j]]
    return y


def ldl_solve(L, d, b):
    """Solve (L D L') x = b given unit-lower L and diagonal d — the dense
    analogue of the reference's QDLDL-style sparse LDL solve
    (+sp_utils/LDLsolve.m:22-48: forward sub -> D^-1 scale -> backward
    sub)."""
    y = scipy.linalg.solve_triangular(L, np.asarray(b, float), lower=True,
                                      unit_diagonal=True)
    y = y / d
    return scipy.linalg.solve_triangular(L.T, y, lower=False,
                                         unit_diagonal=True)
