"""Oscillating-masses benchmark plant.

Chain of p masses connected by springs between two walls; state
x = (positions, velocities), input = forces on a subset of masses.
Reference: +sp_utils/gen_oscillating_masses.m:28-59 and the canonical
instance +sp_utils/example_OscMass.m:14-57 / tests/spcies_tester.m:88-116.
"""

from __future__ import annotations

import numpy as np

from spcies_tpu_torch.utils.linalg import c2d_zoh, dlqr_P, blkdiag


def gen_oscillating_masses(M, K, F):
    """Continuous-time (A, B) for the chain of oscillating masses.

    M: masses (length p); K: spring constants (length p+1); F: boolean mask
    of masses with an external force input. The acceleration of mass i is
    (K_i x_{i-1} - (K_i + K_{i+1}) x_i + K_{i+1} x_{i+1} + f_i) / M_i.
    """
    M = np.asarray(M, dtype=float).ravel()
    K = np.asarray(K, dtype=float).ravel()
    F = np.asarray(F).ravel().astype(bool)
    p = M.size
    Av = np.zeros((p, p))
    for i in range(p):
        if i > 0:
            Av[i, i - 1] = K[i]
        Av[i, i] = -(K[i] + K[i + 1])
        if i < p - 1:
            Av[i, i + 1] = K[i + 1]
        Av[i, :] /= M[i]
    A = np.block([[np.zeros((p, p)), np.eye(p)],
                  [Av, np.zeros((p, p))]])
    B_full = np.vstack([np.zeros((p, p)), np.diag(1.0 / M)])
    B = B_full[:, F]
    return A, B


def example_oscmass(Ts: float = 0.2, N: int = 10):
    """The canonical 3-mass example: returns (sys, param) dicts in the same
    shape the reference's spcies_gen_controller consumes
    (+sp_utils/example_OscMass.m:14-57)."""
    p = 3
    M = np.array([1.0, 0.5, 1.0])
    K = 2.0 * np.ones(p + 1)
    F = np.array([1, 0, 1], dtype=bool)
    Ac, Bc = gen_oscillating_masses(M, K, F)
    n, m = Ac.shape[0], Bc.shape[1]
    A, B = c2d_zoh(Ac, Bc, Ts)
    LBx = -np.concatenate([np.ones(p), 1000.0 * np.ones(p)])
    UBx = np.concatenate([0.3 * np.ones(p), 1000.0 * np.ones(p)])
    LBu = -0.8 * np.ones(m)
    UBu = 0.8 * np.ones(m)
    sys = dict(A=A, B=B, LBx=LBx, UBx=UBx, LBu=LBu, UBu=UBu,
               x0=np.zeros(n), u0=np.zeros(m),
               Nx=np.ones(n), Nu=np.ones(m), p=p, n=n, m=m)
    Q = blkdiag(15.0 * np.eye(p), np.eye(p))
    R = 0.1 * np.eye(m)
    T = dlqr_P(A, B, Q, R)
    param = dict(Q=Q, R=R, T=T, N=N)
    return sys, param


def tester_fixture():
    """The exact fixture + scenario used by the reference test harness
    (tests/spcies_tester.m:88-116): the 3-mass plant, plus the state
    x = 0.02*1, input reference ur = 0.5*1 and the consistent steady-state
    xr = (A - I) \\ (-B ur). Per-solver param differences (e.g. the
    diagonalized terminal T of tests/test_laxMPC_ADMM.m:15) are applied by
    the individual tests."""
    sys, param = example_oscmass()
    n, m = sys["n"], sys["m"]
    x = 0.02 * np.ones(n)
    ur = 0.5 * np.ones(m)
    xr = np.linalg.solve(sys["A"] - np.eye(n), -sys["B"] @ ur)
    return sys, param, dict(x=x, xr=xr, ur=ur)
