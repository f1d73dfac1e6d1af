"""Differential fuzzing of the PyTorch port over the random plants of
tests/test_fuzz_differential.py (random stable plants, n 3-8, m 1-3, N
6-13): ports of its laxMPC-ADMM, equMPC-FISTA and MPCT-ADMM-cs cases, the
port's fp64 solvers held to the JAX package's oracles at 1e-9; and each
kernel-served triple's fused plain version at fp32 held to the JAX fused
kernel in interpret mode on a random plant: the same per-lane k and
e_flag, named lanes at the tolerance boundary excepted."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import (equmpc_fista_oracle, laxmpc_admm_oracle,
                               mpct_admm_cs_oracle)
from tests.test_fuzz_differential import DIMS, _random_system

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


def _assert_oracle(r, oracle_out, keys):
    _u_o, k_o, e_o, sol_o = oracle_out
    assert int(r.e_flag[0]) == e_o == 1
    assert int(r.k[0]) == k_o
    for key in keys:
        assert np.max(np.abs(r.sol[key][0].numpy() - sol_o[key])) < 1e-9


@pytest.mark.parametrize("n,m,seed", DIMS)
def test_fuzz_laxmpc_admm(n, m, seed):
    sys, param, x0, xr, ur = _random_system(100 + seed, n, m)
    param = dict(param, T=2.0 * np.asarray(param["Q"]))
    opts = dict(rho=1.0, tol=1e-7, k_max=20000)
    s = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        device="cpu", **opts)
    _assert_oracle(s(x0, xr, ur),
                   laxmpc_admm_oracle(sys, param, x0, xr, ur, **opts),
                   ("z", "v", "lam"))


@pytest.mark.parametrize("n,m,seed", DIMS)
def test_fuzz_equmpc_fista(n, m, seed):
    sys, param, x0, xr, ur = _random_system(200 + seed, n, m)
    opts = dict(tol=1e-7, k_max=20000)
    s = tsp.make_solver(sys, param, formulation="equMPC", method="FISTA",
                        device="cpu", **opts)
    _assert_oracle(s(x0, xr, ur),
                   equmpc_fista_oracle(sys, param, x0, xr, ur, **opts),
                   ("z", "lam"))


@pytest.mark.parametrize("n,m,seed", DIMS)
def test_fuzz_mpct_cs(n, m, seed):
    sys, param, x0, xr, ur = _random_system(300 + seed, n, m)
    param = dict(param, T=5.0 * np.asarray(param["Q"]),
                 S=2.0 * np.asarray(param["R"]))
    opts = dict(rho=0.5, tol=1e-7, k_max=20000)
    s = tsp.make_solver(sys, param, formulation="MPCT", method="ADMM",
                        submethod="cs", device="cpu", **opts)
    _assert_oracle(s(x0, xr, ur),
                   mpct_admm_cs_oracle(sys, param, x0, xr, ur, **opts),
                   ("z", "v", "lam"))


# each kernel-served triple: (formulation, method, submethod, solver
# options, the plant's param additions); fp32, tile_b 8, checked mode
TRIPLES = {
    "laxMPC-ADMM": ("laxMPC", "ADMM", "", dict(rho=1.0, tol=1e-5), "T"),
    "equMPC-ADMM": ("equMPC", "ADMM", "", dict(rho=1.0, tol=1e-5), ""),
    "MPCT-ADMM-cs": ("MPCT", "ADMM", "cs", dict(rho=0.5, tol=1e-5), "TS"),
    "laxMPC-FISTA": ("laxMPC", "FISTA", "", dict(tol=1e-5), "T"),
    "equMPC-FISTA": ("equMPC", "FISTA", "", dict(tol=1e-5), ""),
    "MPCT-EADMM": ("MPCT", "EADMM", "", dict(rho_base=2.0, rho_mult=20.0,
                                              tol=1e-5), "TS"),
    "ellipMPC-ADMM": ("ellipMPC", "ADMM", "", dict(rho=5.0, tol=1e-5),
                      "ellip"),
    "ellipMPC-ADMM-soc": ("ellipMPC", "ADMM", "soc",
                          dict(rho=5.0, sigma=4.0, tol_p=1e-5, tol_d=1e-5),
                          "ellip"),
    "HMPC-ADMM": ("HMPC", "ADMM", "", dict(rho=2.0, tol_p=1e-5, tol_d=1e-5),
                  "hmpc"),
    "ellipHMPC-ADMM": ("ellipHMPC", "ADMM", "",
                       dict(rho=2.0, sigma=0.01, tol_p=1e-5, tol_d=1e-5),
                       "hmpc"),
    "HMPC-ADMM-split": ("HMPC", "ADMM", "split",
                        dict(rho=2.0, sigma=5.0, tol_p=1e-5, tol_d=1e-5),
                        "hmpc"),
    "HMPC-SADMM-split": ("HMPC", "SADMM", "split",
                         dict(rho=2.0, sigma=5.0, alpha=0.95, tol_p=1e-5,
                              tol_d=1e-5), "hmpc"),
}
# the triple's plant: DIMS rotated over the triples, seeds 500 + DIMS' seed
PLANT = {name: DIMS[i % len(DIMS)] for i, name in enumerate(TRIPLES)}
# lanes at the tolerance boundary that end one check apart from the JAX
# kernel's, the frameworks' products summing in different orders (as the
# kernel test modules name them at N=30): SADMM-split's lane 0 exits at k
# 93 here and at 94 in the JAX run
MOVED = {"HMPC-SADMM-split": (0,)}
B = 8


def _plant(name):
    """A random plant of tests/test_fuzz_differential.py with the
    triple's param additions: T = 2 Q (and S = 2 R, T = 5 Q for MPCT, as
    its MPCT test), the ellipMPC terminal ball about the steady state (P =
    I, radius 2: within the state box the ball of radius 0.5 about a
    random plant's steady state may hold no state), HMPC's w, Te, Th, Se,
    Sh as test_fuzz_hmpc_banded_structure sets them, and ellipHMPC's
    outputs (the first two states within +-1.5)."""
    n, m, seed = PLANT[name]
    sys, param, x0, xr, ur = _random_system(500 + seed, n, m)
    add = TRIPLES[name][4]
    param = dict(param)
    if add == "T":
        param["T"] = 2.0 * np.asarray(param["Q"])
    elif add == "TS":
        param["T"] = 5.0 * np.asarray(param["Q"])
        param["S"] = 2.0 * np.asarray(param["R"])
    elif add == "ellip":
        param.update(T=2.0 * np.asarray(param["Q"]), P=np.eye(n),
                     c=np.asarray(xr, float), r=2.0)
    elif add == "hmpc":
        rng = np.random.default_rng(900 + seed)
        param["w"] = float(rng.uniform(0.3, 1.5))
        param["Te"] = 5.0 * param["N"] * np.asarray(param["Q"])
        param["Th"] = param["Te"]
        param["Se"] = np.asarray(param["R"]).copy()
        param["Sh"] = 0.5 * param["Se"]
        if TRIPLES[name][0] == "ellipHMPC":
            sys = dict(sys, E=np.eye(2, n), F=np.zeros((2, m)),
                       LBy=-1.5 * np.ones(2), UBy=1.5 * np.ones(2))
    rng = np.random.default_rng(seed)
    x0s = np.asarray(x0)[None, :] * rng.uniform(-1.0, 1.0, (B, 1))
    inputs = (x0s, np.tile(xr, (B, 1)), np.tile(ur, (B, 1)))
    if TRIPLES[name][0] == "ellipHMPC":
        zx, zu = np.zeros((B, n)), np.zeros((B, m))
        inputs = (inputs[0], inputs[1], zx, zx, inputs[2], zu, zu)
    return sys, param, inputs


@pytest.mark.parametrize("name", sorted(TRIPLES))
def test_fused_plain_version_matches_jax_fused_on_a_random_plant(name):
    formulation, method, submethod, kw, _ = TRIPLES[name]
    sys, param, x = _plant(name)
    out = {}
    for pkg, opt, where in ((jsp, dict(pallas_interpret=True), {}),
                            (tsp, {}, dict(device="cpu"))):
        o = pkg.default_options(formulation, method, submethod, tile_b=8,
                                k_max=5000, **kw, **opt)
        o.precision = "float"
        s = pkg.make_solver(sys, param, formulation=formulation,
                            method=method, submethod=submethod,
                            backend="fused", options=o, **where)
        out[pkg] = s(*x)
    rj, rt = out[jsp], out[tsp]
    kj, kt = np.asarray(rj.k), rt.k.numpy()
    same = np.ones(B, bool)
    same[list(MOVED.get(name, ()))] = False
    np.testing.assert_array_equal(kt[same], kj[same])
    assert np.all(np.abs(kt - kj) <= 1)
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    assert np.all(rt.e_flag.numpy() == 1)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-4)
