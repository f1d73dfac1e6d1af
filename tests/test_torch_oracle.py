"""The port's numpy oracles (spcies_tpu_torch.oracle): each of the 14
equals the JAX package's oracle on the same inputs (the same k and
e_flag, every output within 1e-12), and the port's fp64 dense engines,
on the CPU, are held against the port's own oracles wherever a test of
the JAX package holds its engines against its oracles (test_laxmpc_admm,
test_laxmpc_fista, test_equmpc, test_ellipmpc, test_mpct_eadmm,
test_mpct_admm_cs, test_mpct_semiband, test_hmpc, test_elliphmpc and
test_fuzz_differential): the same k and e_flag, iterates and u within
1e-9 (the JAX tests hold HMPC and ellipHMPC to 1e-8). Where the JAX
tests also run the banded backend at N=10, so does this file; the banded
MPCT-cs at N=120, whose dense oracle takes a minute of numpy, is held to
the JAX banded solver in test_torch_banded.py instead."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu.oracle as joracle
from tests.test_fuzz_differential import DIMS, _random_system

import spcies_tpu_torch as tsp
import spcies_tpu_torch.oracle as toracle

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs: numpy's OpenBLAS threads
    spin-wait for each other, and under the suite's workers a small
    factorization waits for all of them to be scheduled."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _fixture(kind):
    """The tester fixture as each JAX test file prepares it."""
    sys, param, st = tsp.systems.tester_fixture()
    sys, param = dict(sys), dict(param)
    if kind in ("lax", "ellip"):
        param["T"] = np.diag(np.sum(param["T"], axis=1))
    if kind == "ellip":
        param.update(P=np.eye(len(st["xr"])), c=st["xr"], r=0.0)
    if kind == "equ":
        param.pop("T")
    if kind == "mpct":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
    if kind in ("hmpc", "elliphmpc"):
        param.pop("T")
        param["w"] = 3 * 1.627 * 0.2
        param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
        param["Th"] = param["Te"]
        param["Se"] = np.asarray(param["R"]).copy()
        param["Sh"] = 0.5 * param["Se"]
    if kind in ("elliphmpc", "con_out"):
        n, m = len(st["x"]), 2
        key = "E" if kind == "elliphmpc" else "C"
        sys[key] = np.eye(3, n)
        sys["F" if kind == "elliphmpc" else "D"] = np.zeros((3, m))
        bound = 0.3 if kind == "elliphmpc" else 0.25
        sys["LBy"] = -bound * np.ones(3)
        sys["UBy"] = bound * np.ones(3)
    if kind == "con_out":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
    return sys, param, st


def _refs(st):
    return st["x"], st["xr"], st["ur"]


def _harmonic_refs(st):
    xr, ur = st["xr"], st["ur"]
    zn, zm = np.zeros_like(xr), np.zeros_like(ur)
    return (st["x"], xr, zn, zn, ur, zm, zm)


LAX = dict(rho=15.0, tol=1e-7, k_max=5000)
FISTA = dict(tol=1e-7, k_max=5000)
SOC = dict(rho=15.0, sigma=10.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)
EADMM = dict(rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000)
CS = dict(rho=1e-2, tol=1e-7, k_max=5000)
SEMI = dict(rho=0.5, tol_p=1e-7, tol_d=1e-7, k_max=5000)
HMPC = dict(rho=2.0, sigma=20.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)
EHMPC = dict(rho=2.0, sigma=0.01, tol_p=1e-7, tol_d=1e-7, k_max=5000)


def _case(oracle, kind, triple, opts, keys, *, backend="dense",
          oracle_kw=None, extra_input=None):
    """One engine-against-oracle case: the oracle's name, the fixture,
    the triple and its solver options, the iterates compared, the
    backend, the oracle's own options where they differ from the
    solver's, a trailing engine input (the soc radius, [1]) with the
    oracle's positional argument."""
    return dict(oracle=oracle, kind=kind, triple=triple, opts=opts,
                keys=keys, backend=backend, oracle_kw=oracle_kw,
                extra_input=extra_input)


ENGINE_CASES = {}
for _be in ("dense", "banded"):
    ENGINE_CASES[f"laxMPC-ADMM-{_be}"] = _case(
        "laxmpc_admm_oracle", "lax", ("laxMPC", "ADMM", ""), LAX,
        ("z", "v", "lam"), backend=_be)
    ENGINE_CASES[f"laxMPC-FISTA-{_be}"] = _case(
        "laxmpc_fista_oracle", "lax", ("laxMPC", "FISTA", ""), FISTA,
        ("z", "lam"), backend=_be)
    ENGINE_CASES[f"equMPC-ADMM-{_be}"] = _case(
        "equmpc_admm_oracle", "equ", ("equMPC", "ADMM", ""), LAX,
        ("z", "v", "lam"), backend=_be)
    ENGINE_CASES[f"equMPC-FISTA-{_be}"] = _case(
        "equmpc_fista_oracle", "equ", ("equMPC", "FISTA", ""), FISTA,
        ("z", "lam"), backend=_be)
    ENGINE_CASES[f"ellipMPC-ADMM-{_be}"] = _case(
        "ellipmpc_admm_oracle", "ellip", ("ellipMPC", "ADMM", ""), LAX,
        ("z", "v", "lam"), backend=_be)
_rho = 15.0 * (1.0 + 0.5 * np.random.default_rng(7).random(80))
_rho[80 - 6:] = 20.0
ENGINE_CASES["ellipMPC-ADMM-vector-rho"] = _case(
    "ellipmpc_admm_oracle", "ellip", ("ellipMPC", "ADMM", ""),
    dict(LAX, rho=_rho), ("z", "v", "lam"))
ENGINE_CASES["ellipMPC-ADMM-soc"] = _case(
    "ellipmpc_admm_soc_oracle", "ellip", ("ellipMPC", "ADMM", "soc"), SOC,
    ("z", "s", "lam", "mu"))
for _r in (0.0, 0.3):
    ENGINE_CASES[f"ellipMPC-ADMM-soc-r{_r}"] = _case(
        "ellipmpc_admm_soc_oracle", "ellip", ("ellipMPC", "ADMM", "soc"),
        SOC, (), extra_input=_r)
ENGINE_CASES["MPCT-EADMM"] = _case(
    "mpct_eadmm_oracle", "mpct", ("MPCT", "EADMM", ""), EADMM,
    ("z1", "z2", "z3", "lam"))
ENGINE_CASES["MPCT-EADMM-scalar-rho"] = _case(
    "mpct_eadmm_oracle", "mpct", ("MPCT", "EADMM", ""),
    dict(rho=2.0, tol=1e-5, k_max=5000), (),
    oracle_kw=dict(rho_base=2.0, rho_mult=1.0, tol=1e-5, k_max=5000))
ENGINE_CASES["MPCT-ADMM-cs"] = _case(
    "mpct_admm_cs_oracle", "mpct", ("MPCT", "ADMM", "cs"), CS,
    ("z", "v", "lam"))
for _name, _kind, _extra in (
        ("hard", "mpct", {}),
        ("soft", "mpct", dict(soft_constraints=True, beta=1.0)),
        ("con_out", "con_out", dict(constrained_output=True)),
        ("soft-con_out", "con_out", dict(constrained_output=True,
                                         soft_constraints=True, beta=2.0))):
    ENGINE_CASES[f"MPCT-ADMM-semiband-{_name}"] = _case(
        "mpct_admm_semiband_oracle", _kind, ("MPCT", "ADMM", "semiband"),
        dict(SEMI, **_extra), ("z", "v", "lam"))
for _soc in (False, True):
    _s = "soc" if _soc else "diamond"
    ENGINE_CASES[f"HMPC-ADMM-{_s}"] = _case(
        "hmpc_admm_oracle", "hmpc", ("HMPC", "ADMM", ""),
        dict(HMPC, use_soc=_soc), ("z", "s", "lam"))
    ENGINE_CASES[f"HMPC-ADMM-split-{_s}"] = _case(
        "hmpc_split_oracle", "hmpc", ("HMPC", "ADMM", "split"),
        dict(HMPC, use_soc=_soc), ("z", "s", "lam", "mu"),
        oracle_kw=dict(HMPC, use_soc=_soc, symmetric=False))
    ENGINE_CASES[f"HMPC-SADMM-split-{_s}"] = _case(
        "hmpc_split_oracle", "hmpc", ("HMPC", "SADMM", "split"),
        dict(HMPC, use_soc=_soc, alpha=0.95), ("z", "s", "lam", "mu"),
        oracle_kw=dict(HMPC, use_soc=_soc, symmetric=True, alpha=0.95))
    ENGINE_CASES[f"ellipHMPC-ADMM-{_s}"] = _case(
        "elliphmpc_admm_oracle", "elliphmpc", ("ellipHMPC", "ADMM", ""),
        dict(EHMPC, use_soc=_soc), ("z", "s", "lam"))


def _setup(case):
    """(sys, param, engine inputs, oracle positional inputs, oracle
    options) of an engine case."""
    sys, param, st = _fixture(case["kind"])
    inputs = (_harmonic_refs(st) if case["triple"][0] == "ellipHMPC"
              else _refs(st))
    oracle_inputs = inputs
    if case["extra_input"] is not None:
        oracle_inputs = inputs + (case["extra_input"],)
        inputs = inputs + (np.array([case["extra_input"]]),)
    oracle_kw = case["oracle_kw"] or case["opts"]
    return sys, param, inputs, oracle_inputs, oracle_kw


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_dense_engine_matches_own_oracle(case):
    c = ENGINE_CASES[case]
    sys, param, inputs, oracle_inputs, oracle_kw = _setup(c)
    f, m, sm = c["triple"]
    s = tsp.make_solver(sys, param, formulation=f, method=m, submethod=sm,
                        backend=c["backend"], device="cpu", **c["opts"])
    assert s.dtype == torch.float64
    r = s(*inputs)
    u_o, k_o, e_o, sol_o = getattr(toracle, c["oracle"])(
        sys, param, *oracle_inputs, **oracle_kw)
    assert int(r.e_flag[0]) == e_o == 1
    assert int(r.k[0]) == k_o
    for key in c["keys"]:
        gap = np.max(np.abs(r.sol[key][0].numpy() - sol_o[key]))
        assert gap < 1e-9, (key, gap)
    assert np.max(np.abs(r.u[0].numpy() - u_o)) < 1e-9


def _fuzz(which, n, m, seed):
    """test_fuzz_differential.py's three engine-against-oracle cases:
    (sys, param, inputs, triple, options, oracle, keys)."""
    if which == "laxMPC-ADMM":
        sys, param, x0, xr, ur = _random_system(100 + seed, n, m)
        param = dict(param, T=2.0 * np.asarray(param["Q"]))
        return (sys, param, (x0, xr, ur), ("laxMPC", "ADMM", ""),
                dict(rho=1.0, tol=1e-7, k_max=20000), "laxmpc_admm_oracle",
                ("z", "v", "lam"))
    if which == "equMPC-FISTA":
        sys, param, x0, xr, ur = _random_system(200 + seed, n, m)
        return (sys, param, (x0, xr, ur), ("equMPC", "FISTA", ""),
                dict(tol=1e-7, k_max=20000), "equmpc_fista_oracle",
                ("z", "lam"))
    sys, param, x0, xr, ur = _random_system(300 + seed, n, m)
    param = dict(param, T=5.0 * np.asarray(param["Q"]),
                 S=2.0 * np.asarray(param["R"]))
    return (sys, param, (x0, xr, ur), ("MPCT", "ADMM", "cs"),
            dict(rho=0.5, tol=1e-7, k_max=20000), "mpct_admm_cs_oracle",
            ("z", "v", "lam"))


@pytest.mark.parametrize("n,m,seed", DIMS)
@pytest.mark.parametrize("which", ["laxMPC-ADMM", "equMPC-FISTA",
                                   "MPCT-ADMM-cs"])
def test_fuzz_dense_engine_matches_own_oracle(which, n, m, seed):
    sys, param, inputs, triple, opts, oracle, keys = _fuzz(which, n, m,
                                                           seed)
    s = tsp.make_solver(sys, param, formulation=triple[0],
                        method=triple[1], submethod=triple[2],
                        device="cpu", **opts)
    r = s(*inputs)
    u_o, k_o, e_o, sol_o = getattr(toracle, oracle)(sys, param, *inputs,
                                                    **opts)
    assert int(r.e_flag[0]) == e_o == 1
    assert int(r.k[0]) == k_o
    for key in keys:
        assert np.max(np.abs(r.sol[key][0].numpy() - sol_o[key])) < 1e-9


# ---------------------------------------------------------------------------
# the port's oracles against the JAX package's
# ---------------------------------------------------------------------------

# each iterative oracle on the first engine case that runs it
ORACLE_CASES = {c["oracle"]: name for name, c in
                sorted(ENGINE_CASES.items(), reverse=True)}


def _assert_same(a, b, where=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for key in b:
            _assert_same(a[key], b[key], f"{where}.{key}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, (int, np.integer, bool)) and not isinstance(
            b, (float, np.floating)):
        assert a == b, where
    else:
        a, b = np.asarray(a, float), np.asarray(b, float)
        assert a.shape == b.shape, where
        if a.size:
            assert np.max(np.abs(a - b)) <= 1e-12, (where,
                                                    np.max(np.abs(a - b)))


@pytest.mark.parametrize("name", toracle.__all__)
def test_oracle_equals_jax_oracle(name):
    assert toracle.__all__ == joracle.__all__
    rng = np.random.default_rng(17)
    if name == "solve_eq_qp":
        M = rng.standard_normal((8, 8))
        H = M @ M.T + 8 * np.eye(8)
        G = rng.standard_normal((3, 8))
        Hinv = np.linalg.inv(H)
        args = (Hinv, G, G @ Hinv @ G.T, rng.standard_normal(8),
                rng.standard_normal(3))
        kw = {}
    elif name == "solve_box_qp":
        args = (3 * rng.standard_normal(9), -np.ones(9), np.ones(9))
        kw = {}
    else:
        sys, param, _, args, kw = _setup(ENGINE_CASES[ORACLE_CASES[name]])
        args = (sys, param) + tuple(args)
    got = getattr(toracle, name)(*args, **kw)
    want = getattr(joracle, name)(*args, **kw)
    if name.endswith("_oracle"):
        assert got[1] == want[1] and got[2] == want[2]
    _assert_same(got, want)
