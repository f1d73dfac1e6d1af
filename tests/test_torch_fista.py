"""The dense dual-FISTA engine of the PyTorch port (solvers/fista.py)
through laxMPC-FISTA and equMPC-FISTA against the JAX package's dense
engine in fp64 — same per-lane k and e_flag, iterates within 1e-9 — plus
ports of tests/test_laxmpc_fista.py (golden optimum, numpy oracle,
batched masking, diagonal-T check, adaptive restart)."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import laxmpc_fista_oracle
from tests.golden.laxmpc_admm_golden import Z_OPT

import spcies_tpu_torch as tsp

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


def _on_cpu(pkg):
    """make_solver's device argument for `pkg`: the port's solvers run on
    the card unless asked for the CPU; the JAX package takes none."""
    return dict(device="cpu") if pkg is tsp else {}

OPTS = dict(tol=1e-7, k_max=5000)  # test_laxMPC_FISTA.m:6-7


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    # FISTA requires diagonal T (tests/test_laxMPC_FISTA.m:15)
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    return sys, param, status


@pytest.fixture(scope="module")
def solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, formulation="laxMPC", method="FISTA",
                           **OPTS, device="cpu")


def _param(param, formulation):
    if formulation == "equMPC":
        param = dict(param)
        param.pop("T", None)
    return param


def _pair(formulation, sys, param, debug=0, **kw):
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options(formulation, "FISTA", **kw)
        o.debug = debug
        out.append(pkg.make_solver(sys, _param(param, formulation),
                                   formulation=formulation, method="FISTA",
                                   options=o, **_on_cpu(pkg)))
    return out


def _batch(st, B, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-scale, scale, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _assert_parity(rj, rt, keys=("z", "lam", "res"), atol=1e-9):
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=atol)
    for key in keys:
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=atol, err_msg=key)


def test_vs_golden(solver, fixture):
    _, _, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_vs_oracle(solver, fixture):
    sys, param, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = laxmpc_fista_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_batched_masking(solver, fixture):
    _, _, st = fixture
    x0s, xr, ur = _batch(st, 4, 2)
    batched = solver(x0s, xr, ur)
    ks = []
    for i in range(4):
        solo = solver(x0s[i], st["xr"], st["ur"])
        ks.append(int(solo.k[0]))
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)
    assert len(set(ks)) > 1, "test should cover heterogeneous exit"


def test_nondiagonal_T_rejected(fixture):
    sys, param, _ = fixture
    param = dict(param)
    T = np.asarray(param["T"]).copy()
    T[0, 1] = T[1, 0] = 0.5
    param["T"] = T
    with pytest.raises(ValueError, match="diagonal"):
        tsp.make_solver(sys, param, formulation="laxMPC", method="FISTA",
                        device="cpu")


def test_adaptive_restart(fixture):
    """restart=True (adaptive momentum restart, opt-in — no reference
    counterpart) converges to the same optimum; never slower on the
    fixture."""
    sys, param, st = fixture
    s_plain = tsp.make_solver(sys, param, formulation="laxMPC",
                              method="FISTA", tol=1e-7, k_max=10000,
                              device="cpu")
    s_rst = tsp.make_solver(sys, param, formulation="laxMPC",
                            method="FISTA", tol=1e-7, k_max=10000,
                            restart=True, device="cpu")
    x0 = np.asarray(st["x"]) * 1.5
    rp = s_plain(x0, st["xr"], st["ur"])
    rr = s_rst(x0, st["xr"], st["ur"])
    assert int(rp.e_flag[0]) == int(rr.e_flag[0]) == 1
    assert int(rr.k[0]) <= int(rp.k[0])
    assert np.max(np.abs(rr.u[0].numpy() - rp.u[0].numpy())) < 1e-5


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
@pytest.mark.parametrize("restart", [False, True])
def test_dense_fp64_parity(fixture, formulation, restart):
    sys, param, st = fixture
    s_j, s_t = _pair(formulation, sys, param, restart=restart, **OPTS)
    x = _batch(st, 8, 0)
    rt = s_t(*x)
    _assert_parity(s_j(*x), rt)
    assert rt.u.dtype == torch.float64 and rt.k.dtype == torch.int32
    assert s_t.stage_layout == ("stagewise", formulation == "laxMPC")


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_warm_start_and_fixed_iters(fixture, formulation):
    """A warm start from the converged duals exits within two iterations;
    fixed_iters runs exactly k iterations; both with the JAX engine's
    iterates."""
    sys, param, st = fixture
    s_j, s_t = _pair(formulation, sys, param, **OPTS)
    x = _batch(st, 4, 1)
    cold_t, cold_j = s_t(*x), s_j(*x)
    warm_t = s_t(*x, init=(cold_t.sol["lam"],))
    assert int(warm_t.k.max()) <= 2
    _assert_parity(s_j(*x, init=(cold_j.sol["lam"],)), warm_t)
    fix_t = s_t(*x, fixed_iters=30)
    assert np.all(fix_t.k.numpy() == 30) and np.all(fix_t.e_flag.numpy() == 1)
    _assert_parity(s_j(*x, fixed_iters=30), fix_t)


def test_unconverged_flag(fixture):
    """k_max exhaustion returns e_flag = -1 with the current iterate."""
    sys, param, st = fixture
    s_j, s_t = _pair("laxMPC", sys, param, tol=1e-14, k_max=10)
    rt = s_t(st["x"], st["xr"], st["ur"])
    assert int(rt.e_flag[0]) == -1 and int(rt.k[0]) == 10
    _assert_parity(s_j(st["x"], st["xr"], st["ur"]), rt)


def test_genhist_residual_trace(fixture):
    """options.debug records the residual per iteration (sol['hRes']),
    frozen at each lane's exit — the JAX trace to 1e-9."""
    sys, param, st = fixture
    s_j, s_t = _pair("equMPC", sys, param, debug=1, tol=1e-5, k_max=300)
    x = _batch(st, 3, 2)
    rt, rj = s_t(*x), s_j(*x)
    assert tuple(rt.sol["hRes"].shape) == (3, 300)
    np.testing.assert_allclose(rt.sol["hRes"].numpy(),
                               np.asarray(rj.sol["hRes"]), rtol=0, atol=1e-9)
    k = int(rt.k[0])
    assert float(rt.sol["hRes"][0, k - 1]) == float(rt.sol["res"][0])


def test_fp32_dense_engine_converges(fixture):
    """The fp32 dense engine (the chip's dense baseline) reaches tol 1e-5
    on every lane, with u within 1e-4 of the fp64 solve."""
    sys, param, st = fixture
    o = tsp.default_options("laxMPC", "FISTA", tol=1e-5, k_max=3000,
                            restart=True)
    o.precision = "float"
    s32 = tsp.make_solver(sys, param, formulation="laxMPC", method="FISTA",
                          options=o, device="cpu")
    s64 = tsp.make_solver(sys, param, formulation="laxMPC", method="FISTA",
                          tol=1e-5, k_max=3000, restart=True, device="cpu")
    x = _batch(st, 16, 3)
    r32, r64 = s32(*x), s64(*x)
    assert r32.u.dtype == torch.float32
    assert np.all(r32.e_flag.numpy() == 1)
    np.testing.assert_allclose(r32.u.numpy(), r64.u.numpy(), rtol=0,
                               atol=1e-4)
