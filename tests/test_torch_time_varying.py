"""The time-varying mode of the PyTorch port (opt.time_varying: the
nine-input signature (x0, xr, ur, A, B, Q, R, LB, UB), every lane's band
factors computed per call): ports of every test of
tests/test_time_varying.py (laxMPC and equMPC, ADMM and FISTA, the
tv_dense_w and band_parallel_scan variants, MPCT-ADMM-cs at N=30 and 120),
each also held against the JAX package's time-varying solver on the same
inputs (equal per-lane k and e_flag, iterates within 1e-9), and the
engineering units of the stacked bounds ('xu'). fp64 on the CPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import (equmpc_admm_oracle, laxmpc_admm_oracle,
                               laxmpc_fista_oracle)

import spcies_tpu_torch as tsp

torch.set_num_threads(2)

OPTS = dict(rho=15.0, tol=1e-7, k_max=5000)
ITER_TOL = 1e-9     # port against the JAX package


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs (numpy's OpenBLAS threads
    spin-wait for each other under the suite's workers)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    return sys, param, status


def _on_cpu(pkg):
    return dict(device="cpu") if pkg is tsp else {}


def _p(param, formulation):
    p = dict(param)
    if formulation == "equMPC":
        p.pop("T")
    return p


def _tv(pkg, sys, p, formulation, method="ADMM", submethod="", **kw):
    opt = pkg.default_options(formulation, method, submethod, **kw)
    opt.time_varying = True
    return pkg.make_solver(sys, p, formulation=formulation, method=method,
                           submethod=submethod, options=opt, **_on_cpu(pkg))


def _tv_inputs(sys, param, st, scale_A=1.0):
    A = scale_A * np.asarray(sys["A"])
    B = np.asarray(sys["B"])
    Qd = np.diag(np.asarray(param["Q"]))
    Rd = np.diag(np.asarray(param["R"]))
    LB = np.concatenate([sys["LBx"], sys["LBu"]])
    UB = np.concatenate([sys["UBx"], sys["UBu"]])
    return (st["x"], st["xr"], st["ur"], A, B, Qd, Rd, LB, UB)


def _assert_vs_jax(rt, rj, keys, tol=ITER_TOL):
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    for key in keys:
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_tv_matches_static_at_nominal(fixture, formulation):
    """With the nominal (A, B, Q, R, LB, UB), the time-varying solver
    reproduces the static solver's iterates, and the JAX package's
    time-varying solver's."""
    sys, param, st = fixture
    p = _p(param, formulation)
    s_tv = _tv(tsp, sys, p, formulation, **OPTS)
    s_st = tsp.make_solver(sys, p, formulation=formulation, method="ADMM",
                           **OPTS, device="cpu")
    inputs = _tv_inputs(sys, param, st)
    res_tv = s_tv(*inputs)
    res_st = s_st(st["x"], st["xr"], st["ur"])
    assert int(res_tv.e_flag[0]) == int(res_st.e_flag[0]) == 1
    assert int(res_tv.k[0]) == int(res_st.k[0])
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res_tv.sol[key][0].numpy()
                             - res_st.sol[key][0].numpy())) < 1e-9
    _assert_vs_jax(res_tv, _tv(jsp, sys, p, formulation, **OPTS)(*inputs),
                   ("z", "v", "lam"))


@pytest.mark.parametrize("formulation,oracle",
                         [("laxMPC", laxmpc_admm_oracle),
                          ("equMPC", equmpc_admm_oracle)])
def test_tv_perturbed_model_vs_oracle(fixture, formulation, oracle):
    """With a perturbed A, the time-varying solver matches the oracle
    rebuilt with the perturbed model, and the JAX solver."""
    sys, param, st = fixture
    p = _p(param, formulation)
    s_tv = _tv(tsp, sys, p, formulation, **OPTS)
    scale = 0.97
    inputs = _tv_inputs(sys, param, st, scale_A=scale)
    res = s_tv(*inputs)
    sys_pert = dict(sys, A=scale * np.asarray(sys["A"]))
    u_o, k_o, e_o, sol_o = oracle(sys_pert, p, st["x"], st["xr"], st["ur"],
                                  **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-8
    _assert_vs_jax(res, _tv(jsp, sys, p, formulation, **OPTS)(*inputs),
                   ("z", "v", "lam"))


def _lanes(base, scales):
    """The base inputs tiled over len(scales) lanes, lane i's A scaled by
    scales[i]."""
    Bz = len(scales)
    return (np.tile(base[0], (Bz, 1)), np.tile(base[1], (Bz, 1)),
            np.tile(base[2], (Bz, 1)),
            np.stack([s_ * base[3] for s_ in scales]),
            np.tile(base[4], (Bz, 1, 1)), np.tile(base[5], (Bz, 1)),
            np.tile(base[6], (Bz, 1)), np.tile(base[7], (Bz, 1)),
            np.tile(base[8], (Bz, 1)))


def test_tv_heterogeneous_models_per_lane(fixture):
    """Every lane may carry a different model; each lane matches its own
    solo solve, and the batch matches the JAX solver's."""
    sys, param, st = fixture
    s = _tv(tsp, sys, param, "laxMPC", **OPTS)
    scales = [1.0, 0.95, 1.02]
    base = _tv_inputs(sys, param, st)
    args = _lanes(base, scales)
    batched = s(*args)
    for i, s_ in enumerate(scales):
        solo = s(*_tv_inputs(sys, param, st, scale_A=s_))
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)
    _assert_vs_jax(batched, _tv(jsp, sys, param, "laxMPC", **OPTS)(*args),
                   ("z", "v", "lam"))


def test_tv_receding_horizon_warm_start(fixture):
    """t01-style closed loop: a few steps with a slowly drifting model,
    each solve warm-started from the previous iterates; the JAX solver's
    k at every step."""
    sys, param, st = fixture
    kw = dict(rho=15.0, tol=1e-5, k_max=5000)
    solvers = {pkg: _tv(pkg, sys, param, "laxMPC", **kw)
               for pkg in (tsp, jsp)}
    ks = {}
    for pkg, s in solvers.items():
        x = np.asarray(st["x"], float)
        init = None
        ks[pkg] = []
        for step in range(4):
            scale = 1.0 - 0.01 * step
            args = (x,) + _tv_inputs(sys, param, st, scale_A=scale)[1:]
            res = s(*args, init=init)
            assert int(res.e_flag[0]) == 1
            ks[pkg].append(int(res.k[0]))
            u = np.asarray(res.u[0])
            x = scale * np.asarray(sys["A"]) @ x + np.asarray(sys["B"]) @ u
            init = (res.sol["z"], res.sol["v"], res.sol["lam"])
    assert min(ks[tsp][1:]) < ks[tsp][0]
    assert ks[tsp] == ks[jsp]


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_tv_fista_matches_static(fixture, formulation):
    """Time-varying FISTA at nominal data reproduces the static FISTA,
    and the JAX time-varying FISTA."""
    sys, param, st = fixture
    p = _p(param, formulation)
    kw = dict(tol=1e-7, k_max=5000)
    s_tv = _tv(tsp, sys, p, formulation, "FISTA", **kw)
    s_st = tsp.make_solver(sys, p, formulation=formulation, method="FISTA",
                           **kw, device="cpu")
    inputs = _tv_inputs(sys, param, st)
    res_tv = s_tv(*inputs)
    res_st = s_st(st["x"], st["xr"], st["ur"])
    assert int(res_tv.e_flag[0]) == int(res_st.e_flag[0]) == 1
    assert int(res_tv.k[0]) == int(res_st.k[0])
    for key in ("z", "lam"):
        assert np.max(np.abs(res_tv.sol[key][0].numpy()
                             - res_st.sol[key][0].numpy())) < 1e-9
    _assert_vs_jax(res_tv,
                   _tv(jsp, sys, p, formulation, "FISTA", **kw)(*inputs),
                   ("z", "lam"))


def test_tv_fista_perturbed_vs_oracle(fixture):
    sys, param, st = fixture
    kw = dict(tol=1e-7, k_max=5000)
    s = _tv(tsp, sys, param, "laxMPC", "FISTA", **kw)
    inputs = _tv_inputs(sys, param, st, scale_A=0.96)
    res = s(*inputs)
    sys_pert = dict(sys, A=0.96 * np.asarray(sys["A"]))
    u_o, k_o, e_o, sol_o = laxmpc_fista_oracle(
        sys_pert, param, st["x"], st["xr"], st["ur"], **kw)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-8
    _assert_vs_jax(res, _tv(jsp, sys, param, "laxMPC", "FISTA", **kw)(
        *inputs), ("z", "lam"))


@pytest.mark.parametrize("formulation,extra", [
    ("laxMPC", dict(tv_dense_w=True)),
    ("equMPC", dict(tv_dense_w=True)),
    ("laxMPC", dict(band_parallel_scan=True)),
])
def test_tv_solve_variants_match_banded(fixture, formulation, extra):
    """tv_dense_w (per-lane dense W + batched Cholesky) and
    band_parallel_scan (the scan band solve) reproduce the banded
    time-varying solver, and the JAX package's variant, on two lanes."""
    sys, param, st = fixture
    p = _p(param, formulation)
    s_b = _tv(tsp, sys, p, formulation, **OPTS)
    s_v = _tv(tsp, sys, p, formulation, **OPTS, **extra)
    inputs = _tv_inputs(sys, param, st, scale_A=1.03)
    rb = s_b(*inputs)
    rv = s_v(*inputs)
    assert int(rb.e_flag[0]) == int(rv.e_flag[0]) == 1
    assert int(rb.k[0]) == int(rv.k[0])
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(rb.sol[key][0].numpy()
                             - rv.sol[key][0].numpy())) < 1e-8
    args = _lanes(_tv_inputs(sys, param, st), [1.03, 0.98])
    _assert_vs_jax(s_v(*args),
                   _tv(jsp, sys, p, formulation, **OPTS, **extra)(*args),
                   ("z", "v", "lam"))


def _mpct_param(param, N=None):
    p = dict(param)
    p["T"] = 10.0 * np.asarray(param["Q"])
    p["S"] = np.asarray(param["R"]).copy()
    if N is not None:
        p["N"] = N
    return p


def test_tv_mpct_cs_matches_static_at_nominal(fixture):
    """Per-lane time-varying MPCT-ADMM-cs (beyond the reference, which
    has no MPCT time-varying mode): at the nominal model it reproduces the
    static banded solver's iterates and k, per-lane models match their
    solo solves, and the batch matches the JAX solver's."""
    sys, param, st = fixture
    p = _mpct_param(param)
    kw = dict(rho=2.0, tol=1e-6, k_max=5000)
    s_tv = _tv(tsp, sys, p, "MPCT", "ADMM", "cs", **kw)
    s_st = tsp.make_solver(sys, p, formulation="MPCT", method="ADMM",
                           submethod="cs", backend="banded", **kw,
                           device="cpu")
    res_tv = s_tv(*_tv_inputs(sys, p, st))
    res_st = s_st(st["x"], st["xr"], st["ur"])
    assert int(res_tv.e_flag[0]) == 1
    assert int(res_tv.k[0]) == int(res_st.k[0])
    for key in ("z", "v", "lam"):
        np.testing.assert_allclose(res_tv.sol[key].numpy(),
                                   res_st.sol[key].numpy(), rtol=0,
                                   atol=1e-9)

    scales = np.array([1.0, 0.95, 1.05])
    batch = _lanes(_tv_inputs(sys, p, st), scales)
    rb = s_tv(*batch)
    for i, s_ in enumerate(scales):
        solo = s_tv(*_tv_inputs(sys, p, st, scale_A=s_))
        assert int(rb.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(rb.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-11)
    _assert_vs_jax(rb, _tv(jsp, sys, p, "MPCT", "ADMM", "cs", **kw)(*batch),
                   ("z", "v", "lam"))


def test_tv_mpct_cs_long_horizon_parity(fixture):
    """N=120: the time-varying banded path at a long horizon agrees with
    the static banded solver at the nominal model, and with the JAX
    time-varying solver."""
    sys, param, st = fixture
    p = _mpct_param(param, N=120)
    kw = dict(rho=2.0, tol=1e-5, k_max=5000)
    s_tv = _tv(tsp, sys, p, "MPCT", "ADMM", "cs", **kw)
    s_st = tsp.make_solver(sys, p, formulation="MPCT", method="ADMM",
                           submethod="cs", backend="banded", **kw,
                           device="cpu")
    inputs = _tv_inputs(sys, p, st)
    res_tv = s_tv(*inputs)
    res_st = s_st(st["x"], st["xr"], st["ur"])
    assert int(res_tv.e_flag[0]) == 1
    assert int(res_tv.k[0]) == int(res_st.k[0])
    np.testing.assert_allclose(res_tv.u.numpy(), res_st.u.numpy(), rtol=0,
                               atol=1e-9)
    _assert_vs_jax(res_tv,
                   _tv(jsp, sys, p, "MPCT", "ADMM", "cs", **kw)(*inputs),
                   ("z", "v", "lam"))


def test_tv_engineering_units_scale_bounds(fixture):
    """In engineering units the stacked bounds LB and UB are 'xu' inputs,
    scaled by [Nx; Nu] around [opx; opu] as the JAX package scales them:
    the port gives the JAX solver's k and u for the same engineering
    inputs, and the incremental solve of the scaled inputs."""
    sys, param, st = fixture
    n, m = len(st["x"]), len(st["ur"])
    rng = np.random.default_rng(7)
    sys_e = dict(sys, Nx=rng.uniform(0.5, 2.0, n), Nu=rng.uniform(0.5, 2.0, m),
                 x0=rng.uniform(-0.1, 0.1, n), u0=rng.uniform(-0.1, 0.1, m))
    ops = np.concatenate([sys_e["x0"], sys_e["u0"]])
    scale = np.concatenate([sys_e["Nx"], sys_e["Nu"]])
    inc = _tv_inputs(sys, param, st)
    # engineering inputs whose incremental values are the nominal ones
    eng = (inc[0] / sys_e["Nx"] + sys_e["x0"],
           inc[1] / sys_e["Nx"] + sys_e["x0"],
           inc[2] / sys_e["Nu"] + sys_e["u0"], *inc[3:7],
           inc[7] / scale + ops, inc[8] / scale + ops)
    res = {}
    for pkg in (tsp, jsp):
        opt = pkg.default_options("laxMPC", "ADMM", **OPTS)
        opt.time_varying = True
        opt.in_engineering = True
        s = pkg.make_solver(sys_e, param, formulation="laxMPC",
                            method="ADMM", options=opt, **_on_cpu(pkg))
        assert s.input_kinds[7:] == ("xu", "xu")
        res[pkg] = s(*eng)
    _assert_vs_jax(res[tsp], res[jsp], ("z", "v", "lam"))
    np.testing.assert_allclose(res[tsp].u.numpy(), np.asarray(res[jsp].u),
                               rtol=0, atol=ITER_TOL)
    plain = _tv(tsp, sys, param, "laxMPC", **OPTS)(*inc)
    assert int(plain.k[0]) == int(res[tsp].k[0])
    np.testing.assert_allclose(
        res[tsp].u.numpy(), plain.u.numpy() / sys_e["Nu"] + sys_e["u0"],
        rtol=0, atol=1e-9)
