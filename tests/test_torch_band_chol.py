"""The band-Cholesky layer of the PyTorch port against the JAX package:
kernels/band_chol.py (beta_inverses, band_chol_solve and
band_chol_solve_scan, with blocks shared by the lanes and one set a lane),
kernels/online_band_chol.py (online_band_chol_fn for laxMPC and equMPC,
online_band_chol_tridiag) and utils/linalg.py band_chol_blocks_tridiag, on
random SPD block-tridiagonal systems made from a seed, in fp64 on the
CPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from spcies_tpu.kernels import band_chol as jbc
from spcies_tpu.kernels import online_band_chol as jobc
from spcies_tpu.utils import linalg as jlinalg

from spcies_tpu_torch.kernels import band_chol as tbc
from spcies_tpu_torch.kernels import online_band_chol as tobc
from spcies_tpu_torch.utils import linalg as tlinalg

torch.set_num_threads(2)

SOLVE_TOL = 1e-12     # solves and factors against the JAX functions
OFFLINE_TOL = 1e-14   # the offline numpy helpers


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs (numpy's OpenBLAS threads
    spin-wait for each other under the suite's workers)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _tridiag_blocks(rng, Nb, b, lanes=None):
    """Random SPD block-tridiagonal W as (Wd [.., Nb, b, b], Wu [.., Nb-1,
    b, b]): diagonally dominant, so every leading block is SPD."""
    lead = () if lanes is None else (lanes,)
    Wu = 0.3 * rng.standard_normal(lead + (Nb - 1, b, b))
    G = rng.standard_normal(lead + (Nb, b, b))
    Wd = G @ np.swapaxes(G, -1, -2) + 3.0 * b * np.eye(b)
    return Wd, Wu


def _dense(Wd, Wu):
    Nb, b, _ = Wd.shape
    W = np.zeros((Nb * b, Nb * b))
    for i in range(Nb):
        W[i * b:(i + 1) * b, i * b:(i + 1) * b] = Wd[i]
        if i < Nb - 1:
            W[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = Wu[i]
            W[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = Wu[i].T
    return W


def test_band_chol_blocks_tridiag_matches_jax():
    rng = np.random.default_rng(0)
    Wd, Wu = _tridiag_blocks(rng, 9, 5)
    ref = jlinalg.band_chol_blocks_tridiag(Wd, Wu)
    got = tlinalg.band_chol_blocks_tridiag(Wd, Wu)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=OFFLINE_TOL)


def test_beta_inverses_matches_jax():
    rng = np.random.default_rng(1)
    Wd, Wu = _tridiag_blocks(rng, 7, 4)
    Alpha, Beta = tlinalg.band_chol_blocks(_dense(Wd, Wu), 4, 7)
    ref = jbc.beta_inverses(Alpha, Beta)
    got = tbc.beta_inverses(Alpha, Beta)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=OFFLINE_TOL)


@pytest.mark.parametrize("solve", ["band_chol_solve", "band_chol_solve_scan"])
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("Nb", [2, 3, 13])
def test_band_solves_match_jax(solve, per_lane, Nb):
    """Both solves, both block forms, against the JAX function and the
    dense solve of W (Nb = 2 and 3 take the scan's edge rounds)."""
    rng = np.random.default_rng(10 + Nb)
    B, b = 5, 4
    Wd, Wu = _tridiag_blocks(rng, Nb, b, lanes=B if per_lane else None)
    if per_lane:
        blocks = [tlinalg.band_chol_blocks_tridiag(Wd[i], Wu[i])
                  for i in range(B)]
        Alpha = np.stack([a for a, _ in blocks])
        BetaInv = np.stack([bi for _, bi in blocks])
    else:
        Alpha, BetaInv = tlinalg.band_chol_blocks_tridiag(Wd, Wu)
    rhs = rng.standard_normal((B, Nb, b))
    ref = np.asarray(getattr(jbc, solve)(jnp.asarray(rhs),
                                         jnp.asarray(Alpha),
                                         jnp.asarray(BetaInv)))
    got = getattr(tbc, solve)(torch.as_tensor(rhs), torch.as_tensor(Alpha),
                              torch.as_tensor(BetaInv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SOLVE_TOL)
    for i in range(B):
        W = _dense(Wd[i], Wu[i]) if per_lane else _dense(Wd, Wu)
        np.testing.assert_allclose(W @ got[i].ravel(), rhs[i].ravel(),
                                   rtol=0, atol=1e-10)


def _lane_models(rng, B, n, m):
    A = np.eye(n) + 0.2 * rng.standard_normal((B, n, n))
    Bm = rng.standard_normal((B, n, m))
    Qi = 1.0 / (rng.uniform(0.5, 2.0, (B, n)) + 15.0)
    Ri = 1.0 / (rng.uniform(0.5, 2.0, (B, m)) + 15.0)
    return A, Bm, Qi, Ri


@pytest.mark.parametrize("terminal", [True, False])
def test_online_band_chol_fn_matches_jax(terminal):
    rng = np.random.default_rng(20)
    B, n, m, N = 4, 5, 2, 9
    A, Bm, Qi, Ri = _lane_models(rng, B, n, m)
    T = rng.standard_normal((n, n))
    T_rho_i = np.linalg.inv(T @ T.T + 15.0 * np.eye(n)) if terminal else None
    ref = jobc.online_band_chol_fn(N, terminal)(
        *(jnp.asarray(a) for a in (A, Bm, Qi, Ri)),
        None if T_rho_i is None else jnp.asarray(T_rho_i))
    got = tobc.online_band_chol_fn(N, terminal)(
        *(torch.as_tensor(a) for a in (A, Bm, Qi, Ri)),
        None if T_rho_i is None else torch.as_tensor(T_rho_i))
    for r, g in zip(ref, got):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=SOLVE_TOL)


def test_online_band_chol_tridiag_matches_jax_and_offline():
    rng = np.random.default_rng(30)
    B, Nb, b = 3, 8, 5
    Wd, Wu = _tridiag_blocks(rng, Nb, b, lanes=B)
    ref = jobc.online_band_chol_tridiag(jnp.asarray(Wd), jnp.asarray(Wu))
    got = tobc.online_band_chol_tridiag(torch.as_tensor(Wd),
                                        torch.as_tensor(Wu))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=SOLVE_TOL)
    for i in range(B):
        off = tlinalg.band_chol_blocks_tridiag(Wd[i], Wu[i])
        for o, g in zip(off, got):
            np.testing.assert_allclose(g[i].numpy(), o, rtol=0,
                                       atol=SOLVE_TOL)


def test_online_factor_of_indefinite_block_is_nan():
    """A lane whose block is not positive definite gets NaN factors, as
    the JAX package's Cholesky gives, and the other lanes are unharmed;
    nothing raises (on the card a raise would read the status on the
    host once a stage)."""
    rng = np.random.default_rng(40)
    Wd, Wu = _tridiag_blocks(rng, 4, 3, lanes=2)
    Wd[1, 2] = -np.eye(3)
    Alpha, BetaInv = tobc.online_band_chol_tridiag(torch.as_tensor(Wd),
                                                   torch.as_tensor(Wu))
    assert bool(torch.isnan(BetaInv[1, 2]).all())
    assert bool(torch.isfinite(BetaInv[0]).all())
    jref = jobc.online_band_chol_tridiag(jnp.asarray(Wd), jnp.asarray(Wu))
    assert bool(np.isnan(np.asarray(jref[1])[1, 2]).all())
