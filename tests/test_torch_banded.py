"""The banded backends of the PyTorch port (formulations/stagewise.py and
kernels/band_chol.py under laxMPC-ADMM/FISTA, equMPC-ADMM/FISTA,
ellipMPC-ADMM and MPCT-ADMM-cs): ports of the banded cases of
tests/test_laxmpc_admm.py (the "banded" parameter of its solver fixture
and test_banded_parallel_scan_matches_sequential),
tests/test_laxmpc_fista.py, tests/test_equmpc.py (both fixtures),
tests/test_ellipmpc.py (admm_solver) and the three banded tests of
tests/test_mpct_admm_cs.py (N=120 included), each also held against the
JAX package's banded solver on the same inputs (equal k and e_flag,
iterates within 1e-9), and the banded ingredient dicts carried across
from the JAX package through convert. fp64 on the CPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import (ellipmpc_admm_oracle, equmpc_admm_oracle,
                               equmpc_fista_oracle, laxmpc_admm_oracle,
                               laxmpc_fista_oracle, mpct_admm_cs_oracle)
from tests.golden import (ellipmpc_golden, equmpc_golden,
                          laxmpc_admm_golden, mpct_admm_cs_golden)

import spcies_tpu_torch as tsp
from spcies_tpu_torch.convert import ingredients_from_jax

torch.set_num_threads(2)

ITER_TOL = 1e-9     # port against the JAX package and the oracles


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs (numpy's OpenBLAS threads
    spin-wait for each other under the suite's workers)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _on_cpu(pkg):
    """make_solver's device argument for `pkg`: the port's solvers run on
    the card unless asked for the CPU; the JAX package takes none."""
    return dict(device="cpu") if pkg is tsp else {}


def _param(name):
    """Each JAX test file's fixture param (tests/test_*.py:13-25)."""
    _, param, st = tsp.systems.tester_fixture()
    p = dict(param)
    if name.startswith("equMPC"):
        p.pop("T", None)
    elif name == "MPCT-ADMM-cs":
        p["T"] = 10.0 * np.asarray(p["Q"])
        p["S"] = np.asarray(p["R"]).copy()
    else:
        p["T"] = np.diag(np.sum(p["T"], axis=1))
    if name == "ellipMPC-ADMM":
        p["P"] = np.eye(len(st["xr"]))
        p["c"] = st["xr"]
        p["r"] = 0.0
    return p


# name -> (formulation, method, submethod, options, oracle, golden, keys)
CASES = {
    "laxMPC-ADMM": ("laxMPC", "ADMM", "", dict(rho=15.0, tol=1e-7,
                                               k_max=5000),
                    laxmpc_admm_oracle, laxmpc_admm_golden.Z_OPT,
                    ("z", "v", "lam")),
    "laxMPC-FISTA": ("laxMPC", "FISTA", "", dict(tol=1e-7, k_max=5000),
                     laxmpc_fista_oracle, laxmpc_admm_golden.Z_OPT,
                     ("z", "lam")),
    "equMPC-ADMM": ("equMPC", "ADMM", "", dict(rho=15.0, tol=1e-7,
                                               k_max=5000),
                    equmpc_admm_oracle, equmpc_golden.Z_OPT,
                    ("z", "v", "lam")),
    "equMPC-FISTA": ("equMPC", "FISTA", "", dict(tol=1e-7, k_max=5000),
                     equmpc_fista_oracle, equmpc_golden.Z_OPT,
                     ("z", "lam")),
    "ellipMPC-ADMM": ("ellipMPC", "ADMM", "", dict(rho=15.0, tol=1e-7,
                                                   k_max=5000),
                      ellipmpc_admm_oracle, ellipmpc_golden.Z_OPT,
                      ("z", "v", "lam")),
    "MPCT-ADMM-cs": ("MPCT", "ADMM", "cs", dict(rho=1e-2, tol=1e-7,
                                                k_max=5000),
                     mpct_admm_cs_oracle, mpct_admm_cs_golden.Z_OPT,
                     ("z", "v", "lam")),
}


def _solver(pkg, name, param=None, **extra):
    formulation, method, submethod, opts, *_ = CASES[name]
    sys, _, _ = tsp.systems.tester_fixture()
    return pkg.make_solver(sys, _param(name) if param is None else param,
                           formulation=formulation, method=method,
                           submethod=submethod, backend="banded",
                           **{**opts, **extra}, **_on_cpu(pkg))


_SOLVERS = {}


def _port(name):
    if name not in _SOLVERS:
        _SOLVERS[name] = _solver(tsp, name)
    return _SOLVERS[name]


def _st():
    return tsp.systems.tester_fixture()[2]


def _batch(B, seed):
    st = _st()
    rng = np.random.default_rng(seed)
    x0 = st["x"][None, :] * rng.uniform(-2.0, 2.0, size=(B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _assert_same(rt, rj, keys, tol=ITER_TOL):
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    for key in keys:
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=tol, err_msg=key)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_vs_golden(name):
    """z* within 1e-4 of the reference's optimum
    (tests/spcies_tester.m:261 tol_opt)."""
    st = _st()
    res = _port(name)(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - CASES[name][5])) <= 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_vs_oracle(name):
    """The banded solver against the dense numpy oracle: same k, iterates
    within 1e-9."""
    sys, _, st = tsp.systems.tester_fixture()
    _, _, _, opts, oracle, _, keys = CASES[name]
    res = _port(name)(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = oracle(sys, _param(name), st["x"], st["xr"],
                                  st["ur"], **opts)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in keys:
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_banded(name):
    """The port's banded solver and the JAX package's on the same batch:
    equal per-lane k and e_flag, iterates within 1e-9."""
    x = _batch(5, 3)
    _assert_same(_port(name)(*x), _solver(jsp, name)(*x), CASES[name][6])


@pytest.mark.parametrize("name", ["laxMPC-ADMM", "laxMPC-FISTA",
                                  "equMPC-ADMM", "ellipMPC-ADMM"])
def test_batched_masking_matches_solo(name):
    """Each lane of a heterogeneous batch matches its solo solve
    (freeze-masked termination preserves per-lane k and iterates)."""
    x0s, xr, ur = _batch(4, 1)
    s = _port(name)
    batched = s(x0s, xr, ur)
    ks = []
    for i in range(4):
        solo = s(x0s[i], xr[i], ur[i])
        ks.append(int(solo.k[0]))
        assert int(batched.k[i]) == int(solo.k[0])
        assert int(batched.e_flag[i]) == int(solo.e_flag[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)
    assert len(set(ks)) > 1, "test should cover heterogeneous exit"


def test_equmpc_terminal_state_reaches_xr():
    """The terminal equality x_N = xr holds at the banded solution."""
    sys, _, st = tsp.systems.tester_fixture()
    s = _port("equMPC-ADMM")
    z = s(st["x"], st["xr"], st["ur"]).sol["z"][0].numpy()
    n, m = s.n, s.m
    xN = sys["A"] @ z[-(n + m):-m] + sys["B"] @ z[-m:]
    assert np.max(np.abs(xN - st["xr"])) < 1e-5


def test_laxmpc_warm_start_reduces_iterations():
    st = _st()
    s = _port("laxMPC-ADMM")
    cold = s(st["x"], st["xr"], st["ur"])
    init = (cold.sol["z"], cold.sol["v"], cold.sol["lam"])
    warm = s(st["x"], st["xr"], st["ur"], init=init)
    assert int(warm.k[0]) < int(cold.k[0])
    assert int(warm.e_flag[0]) == 1


def test_laxmpc_fixed_iters_mode():
    st = _st()
    res = _port("laxMPC-ADMM")(st["x"], st["xr"], st["ur"], fixed_iters=50)
    assert int(res.k[0]) == 50
    ref = _solver(jsp, "laxMPC-ADMM")(st["x"], st["xr"], st["ur"],
                                      fixed_iters=50)
    _assert_same(res, ref, ("z", "v", "lam"))


@pytest.mark.parametrize("name,tol", [("laxMPC-ADMM", 1e-9),
                                      ("MPCT-ADMM-cs", 1e-8)])
def test_banded_parallel_scan_matches_sequential(name, tol):
    """band_parallel_scan=True (the O(log N)-depth scan band solve)
    reproduces the sequential banded backend at N=40, as the JAX tests
    hold it, and the JAX package's scan solver's k."""
    p = _param(name)
    p["N"] = 40
    kw = dict(tol=1e-6) if name == "laxMPC-ADMM" else dict(rho=1e-2,
                                                            tol=1e-6)
    st = _st()
    x = (st["x"], st["xr"], st["ur"])
    rs = _solver(tsp, name, p, **kw)(*x)
    rp = _solver(tsp, name, p, band_parallel_scan=True, **kw)(*x)
    assert int(rs.e_flag[0]) == int(rp.e_flag[0]) == 1
    assert int(rs.k[0]) == int(rp.k[0])
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(rs.sol[key][0].numpy()
                             - rp.sol[key][0].numpy())) < tol
    rj = _solver(jsp, name, p, band_parallel_scan=True, **kw)(*x)
    _assert_same(rp, rj, ("z", "v", "lam"), tol)


def test_mpct_cs_banded_matches_dense():
    """MPCT-cs banded (stage-local G/Hinv operations + block-tridiagonal
    Cholesky, never forming dense M_q) reproduces the dense backend to
    fp64 roundoff."""
    x = _batch(4, 31)
    sys, _, _ = tsp.systems.tester_fixture()
    rd = tsp.make_solver(sys, _param("MPCT-ADMM-cs"), formulation="MPCT",
                         method="ADMM", submethod="cs", rho=1e-2, tol=1e-7,
                         k_max=5000, device="cpu")(*x)
    rb = _port("MPCT-ADMM-cs")(*x)
    np.testing.assert_array_equal(rb.k.numpy(), rd.k.numpy())
    for key in ("z", "v", "lam"):
        np.testing.assert_allclose(rb.sol[key].numpy(), rd.sol[key].numpy(),
                                   rtol=0, atol=1e-9)


def test_mpct_cs_banded_long_horizon_n120():
    """N=120 MPCT-cs through the banded backend: O(N) ingredients, and
    the JAX banded solver's k and iterates on a single problem and on two
    lanes. (tests/test_mpct_admm_cs.py holds the JAX solver to the dense
    fp64 oracle at this horizon, which takes a minute of numpy.)"""
    st = _st()
    p = _param("MPCT-ADMM-cs")
    p["N"] = 120
    kw = dict(rho=1e-2, tol=1e-6, k_max=5000)
    s = _solver(tsp, "MPCT-ADMM-cs", p, **kw)
    nz = 120 * 16
    for key, arr in s.ingredients.items():
        if isinstance(arr, np.ndarray):
            assert arr.size < nz * 40, (key, arr.shape)
    s_j = _solver(jsp, "MPCT-ADMM-cs", p, **kw)
    for x in ((st["x"], st["xr"], st["ur"]), _batch(2, 5)):
        res = s(*x)
        assert bool((res.e_flag == 1).all())
        _assert_same(res, s_j(*x), ("z", "v", "lam"))


@pytest.mark.parametrize("name", list(CASES))
def test_banded_ingredients_from_jax(name):
    """A JAX banded solver's ingredient dict crosses through convert and
    builds the port's banded solver, which gives the JAX solver's k."""
    formulation, method, submethod, opts, *_ = CASES[name]
    s_j = _solver(jsp, name)
    ing = ingredients_from_jax(s_j.ingredients, formulation, method,
                               submethod, backend="banded")
    sys, _, _ = tsp.systems.tester_fixture()
    s_t = tsp.make_solver(sys, _param(name), formulation=formulation,
                          method=method, submethod=submethod,
                          backend="banded", ingredients=ing, **opts,
                          device="cpu")
    x = _batch(5, 3)
    rj, rt = s_j(*x), s_t(*x)
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    with pytest.raises(KeyError, match="ingredients lack.*Alpha"):
        ingredients_from_jax({k: v for k, v in s_j.ingredients.items()
                              if k != "Alpha"}, formulation, method,
                             submethod, backend="banded")
