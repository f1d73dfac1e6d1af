"""The port's plants and scaling (spcies_tpu_torch/systems/duffing.py and
scale_ss.py) against the JAX package's, on seeded inputs; the engineering
units of api.BatchedSolver against scale_ss; and a port of
tests/test_baseline_configs.py::test_equmpc_fista_duffing on the port's
equMPC-FISTA and -ADMM, whose per-lane k also equals the JAX package's."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.utils import linalg as jlinalg

import spcies_tpu_torch as tsp
from spcies_tpu_torch.utils import linalg as tlinalg

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs. Both packages' offline
    layers factor small matrices with numpy, whose OpenBLAS threads
    spin-wait for each other: with the suite's workers on every core, such
    a call waits for all its threads to be scheduled (a test of 0.03 s
    took 10 s)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _duffing_coeffs(rng):
    return dict(alpha=float(rng.uniform(-2, 2)), beta=float(rng.uniform(0, 2)),
                delta=float(rng.uniform(0, 1)), gamma=float(rng.uniform(0.5, 2)))


def test_systems_export_the_jax_names():
    assert set(jsp.systems.__all__) == set(tsp.systems.__all__)
    for name in ("duffing_ode", "duffing_to_ss", "scale_ss"):
        assert callable(getattr(tsp.systems, name))


@pytest.mark.parametrize("seed", range(4))
def test_duffing_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = _duffing_coeffs(rng)
    x = rng.standard_normal(2)
    u = float(rng.standard_normal())
    t = float(rng.uniform(0, 10))
    np.testing.assert_array_equal(tsp.systems.duffing_ode(t, x, u, **kw),
                                  jsp.systems.duffing_ode(t, x, u, **kw))
    A_t, B_t = tsp.systems.duffing_to_ss(x, np.array([u]), **kw)
    A_j, B_j = jsp.systems.duffing_to_ss(x, np.array([u]), **kw)
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_array_equal(B_t, B_j)
    # the linearization is the ODE's Jacobian in x and u
    eps = 1e-6
    for i in range(2):
        dx = np.zeros(2)
        dx[i] = eps
        col = (tsp.systems.duffing_ode(t, x + dx, u, **kw)
               - tsp.systems.duffing_ode(t, x - dx, u, **kw)) / (2 * eps)
        np.testing.assert_allclose(col, A_t[:, i], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,m,seed", [(2, 1, 0), (6, 2, 1), (5, 3, 2)])
def test_scale_ss_matches_jax(n, m, seed):
    rng = np.random.default_rng(seed)
    A, B = rng.standard_normal((n, n)), rng.standard_normal((n, m))
    UBx, LBx = rng.uniform(1, 3, n), -rng.uniform(1, 3, n)
    UBu, LBu = rng.uniform(1, 3, m), -rng.uniform(1, 3, m)
    x0, u0 = rng.standard_normal(n), rng.standard_normal(m)
    Nx, Nu = rng.uniform(0.5, 4, n), rng.uniform(0.5, 4, m)
    args = (A, B, UBx, LBx, UBu, LBu, x0, u0, Nx, Nu)
    out_t, out_j = tsp.systems.scale_ss(*args), jsp.systems.scale_ss(*args)
    assert set(out_t) == set(out_j)
    for key in out_j:
        np.testing.assert_array_equal(out_t[key], out_j[key])


def test_engineering_units_agree_with_scale_ss():
    """The solver's input scaling in engineering units
    (BatchedSolver._to_incremental) is scale_ss's arithmetic: a state and
    an input taken to incremental units give, bit for bit, what scale_ss
    makes of the same vectors given as bounds."""
    rng = np.random.default_rng(3)
    sys, param, st = tsp.systems.tester_fixture()
    n, m = np.asarray(sys["A"]).shape[0], np.asarray(sys["B"]).shape[1]
    Nx, Nu = rng.uniform(0.5, 4, n), rng.uniform(0.5, 4, m)
    xo, uo = rng.standard_normal(n), rng.standard_normal(m)
    eng = dict(sys, Nx=Nx, Nu=Nu, x0=xo, u0=uo)
    o = tsp.default_options("laxMPC", "ADMM")
    o.in_engineering = True
    s = tsp.make_solver(eng, param, formulation="laxMPC", method="ADMM",
                        options=o, device="cpu")
    np.testing.assert_array_equal(s._Nx, Nx)
    x_eng, u_eng = rng.standard_normal((4, n)), rng.standard_normal((4, m))
    x_inc, xr_inc, u_inc = s._to_incremental((x_eng, x_eng, u_eng))
    sc = tsp.systems.scale_ss(sys["A"], sys["B"], x_eng, x_eng, u_eng, u_eng,
                              xo, uo, Nx, Nu)
    np.testing.assert_array_equal(x_inc, sc["UBx"])
    np.testing.assert_array_equal(xr_inc, sc["LBx"])
    np.testing.assert_array_equal(u_inc, sc["UBu"])


def _duffing_problem(pkg, linalg):
    x_op = np.array([0.0, 1.0])
    u_op = np.array([0.3 * 0.0 + -1.0 * 1.0 + 1.0 * 1.0])
    Ac, Bc = pkg.systems.duffing_to_ss(x_op, u_op, alpha=-1.0, beta=1.0,
                                       delta=0.3, gamma=1.0)
    A, B = linalg.c2d_zoh(Ac, Bc, 0.1)
    sys = dict(A=A, B=B, LBx=-0.5 * np.ones(2), UBx=0.5 * np.ones(2),
               LBu=-1.0 * np.ones(1), UBu=1.0 * np.ones(1))
    param = dict(Q=np.diag([1.0, 10.0]), R=np.eye(1), N=15)
    return sys, param


def test_equmpc_fista_duffing():
    """Port of tests/test_baseline_configs.py::test_equmpc_fista_duffing:
    the port's equMPC-FISTA drives the linearized Duffing oscillator to the
    terminal-equality reference, with the ADMM engine's optimum on the same
    QP; both give the JAX package's k and u (fp64)."""
    sys, param = _duffing_problem(tsp, tlinalg)
    sys_j, _ = _duffing_problem(jsp, jlinalg)
    np.testing.assert_array_equal(sys["A"], sys_j["A"])
    np.testing.assert_array_equal(sys["B"], sys_j["B"])
    x0 = np.array([0.1, -0.2])
    xr = np.zeros(2)
    ur = np.zeros(1)
    res = {}
    for pkg, extra in ((tsp, dict(device="cpu")), (jsp, {})):
        s_f = pkg.make_solver(sys, param, formulation="equMPC",
                              method="FISTA", tol=1e-8, k_max=20000, **extra)
        s_a = pkg.make_solver(sys, param, formulation="equMPC",
                              method="ADMM", rho=1.0, tol=1e-8, k_max=20000,
                              **extra)
        res[pkg] = (s_f(x0, xr, ur), s_a(x0, xr, ur))
    rf, ra = res[tsp]
    assert int(rf.e_flag[0]) == int(ra.e_flag[0]) == 1
    assert np.max(np.abs(np.asarray(rf.u[0]) - np.asarray(ra.u[0]))) < 1e-5
    z = np.asarray(rf.sol["z"][0])
    A, B = sys["A"], sys["B"]
    n, m, N = 2, 1, 15
    x = A @ x0 + B @ z[:m]
    for l in range(N - 1):
        blk = z[m + l * (n + m): m + (l + 1) * (n + m)]
        x = A @ blk[:n] + B @ blk[n:]
    assert np.max(np.abs(x - xr)) < 1e-5
    for r_t, r_j in zip(res[tsp], res[jsp]):
        assert int(r_t.k[0]) == int(r_j.k[0])
        assert int(r_t.e_flag[0]) == int(r_j.e_flag[0])
        np.testing.assert_allclose(np.asarray(r_t.u[0]),
                                   np.asarray(r_j.u[0]), rtol=0, atol=1e-9)
