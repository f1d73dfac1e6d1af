"""The offline layer of the PyTorch port (spcies_tpu_torch) against the JAX
package: option registry, system matrices, fp64 linear algebra, laxMPC-ADMM
ingredients and the projections."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
import spcies_tpu.config as jcfg
from spcies_tpu.formulations.laxmpc import (
    laxmpc_admm_ingredients as jax_ingredients)
from spcies_tpu.utils import linalg as jlinalg
from spcies_tpu.utils import projections as jproj

import spcies_tpu_torch as tsp
import spcies_tpu_torch.config as tcfg
from spcies_tpu_torch.formulations.laxmpc import (
    laxmpc_admm_ingredients as torch_ingredients)
from spcies_tpu_torch.utils import linalg as tlinalg
from spcies_tpu_torch.utils import projections as tproj

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


@pytest.mark.parametrize("name", ["METHODS_BY_FORMULATION", "SUBMETHODS",
                                  "DEFAULT_METHOD", "SOLVER_REGISTRY"])
def test_registry_equal(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("triple", sorted(jcfg.SOLVER_REGISTRY))
def test_default_options_equal(triple):
    a = tsp.default_options(*triple, rho=3.0)
    b = jsp.default_options(*triple, rho=3.0)
    assert (a.formulation, a.method, a.submethod) == (
        b.formulation, b.method, b.submethod)
    assert a.solver == b.solver


@pytest.mark.parametrize("bad", [
    dict(formulation="nope"),
    dict(formulation="laxMPC", method="EADMM"),
    dict(formulation="MPCT", method="ADMM", submethod="zz"),
])
def test_options_errors(bad):
    with pytest.raises(ValueError):
        tsp.Options(**bad)
    with pytest.raises(ValueError):
        jsp.Options(**bad)


@pytest.mark.parametrize("keys", [("S",), ("w",), ("c",), ("P",), ("T",),
                                  ("S", "P"), ("Q",)])
def test_determine_formulation(keys):
    param = {k: 1 for k in keys}
    try:
        want = jsp.determine_formulation(param)
    except ValueError:
        with pytest.raises(ValueError):
            tsp.determine_formulation(param)
        return
    assert tsp.determine_formulation(param) == want


def test_problem_generate_c_not_ported(tmp_path):
    """Problem.generate_c, which this test once found refused, writes,
    compiles and returns the recipe's C solver: the JAX package's
    bytes."""
    sys_, param, _ = tsp.systems.tester_fixture()
    prob = tcfg.Problem(sys=sys_, param=param,
                        options=tsp.default_options("laxMPC", "ADMM"))
    c_path = prob.generate_c(directory=str(tmp_path / "t"))
    assert c_path == str(tmp_path / "t" / "laxmpc_admm.c")
    assert (tmp_path / "t" / "liblaxmpc_admm.so").exists()
    j_path = jcfg.Problem(
        sys=sys_, param=param,
        options=jsp.default_options("laxMPC", "ADMM")).generate_c(
            directory=str(tmp_path / "j"), compile=False)
    assert open(c_path, "rb").read() == open(j_path, "rb").read()


@pytest.mark.parametrize("N", [5, 10])
def test_system_matrices_equal(N):
    a_sys, a_param = tsp.systems.example_oscmass(N=N)
    b_sys, b_param = jsp.systems.example_oscmass(N=N)
    for key in ("A", "B", "LBx", "UBx", "LBu", "UBu", "Nx", "Nu"):
        np.testing.assert_array_equal(a_sys[key], b_sys[key])
    for key in ("Q", "R", "T"):
        np.testing.assert_array_equal(a_param[key], b_param[key])
    _, _, a_st = tsp.systems.tester_fixture()
    _, _, b_st = jsp.systems.tester_fixture()
    for key in ("x", "xr", "ur"):
        np.testing.assert_array_equal(a_st[key], b_st[key])


def test_linalg_equal():
    sys_, param, _ = tsp.systems.tester_fixture()
    A, B = sys_["A"], sys_["B"]
    Ac, Bc = tsp.systems.gen_oscillating_masses([1.0, 0.5, 1.0],
                                                2.0 * np.ones(4),
                                                [1, 0, 1])
    for a, b in zip(tlinalg.c2d_zoh(Ac, Bc, 0.2),
                    jlinalg.c2d_zoh(Ac, Bc, 0.2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tlinalg.dlqr_P(A, B, param["Q"], param["R"]),
        jlinalg.dlqr_P(A, B, param["Q"], param["R"]))
    for drop in (False, True):
        np.testing.assert_array_equal(
            tlinalg.mpc_equality_matrix(A, B, 7, drop_terminal=drop),
            jlinalg.mpc_equality_matrix(A, B, 7, drop_terminal=drop))
    G = tlinalg.mpc_equality_matrix(A, B, 7)
    W = G @ G.T + np.eye(G.shape[0])
    for a, b in zip(tlinalg.band_chol_blocks(W, 6, 7),
                    jlinalg.band_chol_blocks(W, 6, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N", [10, 30])
@pytest.mark.parametrize("rho", [15.0, "vector"])
def test_laxmpc_admm_ingredients_equal(N, rho):
    sys_, param, _ = tsp.systems.tester_fixture()
    param = dict(param, N=N)
    nz = N * 8
    if rho == "vector":
        rho = np.linspace(1.0, 20.0, nz)
    a = torch_ingredients(sys_, param,
                          tsp.default_options("laxMPC", "ADMM", rho=rho))
    b = jax_ingredients(sys_, param,
                        jsp.default_options("laxMPC", "ADMM", rho=rho))
    assert set(a) == set(b)
    for key, val in b.items():
        if isinstance(val, np.ndarray):
            assert a[key].shape == val.shape, key
            np.testing.assert_allclose(a[key], val, rtol=0, atol=1e-12,
                                       err_msg=key)
        else:
            assert a[key] == val, key


def test_ingredients_reject_nondiagonal_q():
    sys_, param, _ = tsp.systems.tester_fixture()
    param = dict(param)
    param["Q"] = np.asarray(param["Q"]) + 0.1
    with pytest.raises(ValueError, match="diagonal"):
        torch_ingredients(sys_, param, tsp.default_options("laxMPC", "ADMM"))


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def test_proj_box_equal():
    y = _rand((5, 7), 0) * 3
    lb, ub = -np.abs(_rand(7, 1)), np.abs(_rand(7, 2))
    np.testing.assert_array_equal(
        tproj.proj_box(torch.as_tensor(y), torch.as_tensor(lb),
                       torch.as_tensor(ub)).numpy(),
        np.asarray(jproj.proj_box(y, lb, ub)))


def test_proj_ellipsoid_equal():
    y = _rand((6, 4), 3) * 2
    L = _rand((4, 4), 4)
    P = L @ L.T + np.eye(4)
    c = _rand(4, 5) * 0.1
    a = tproj.proj_ellipsoid(torch.as_tensor(y), torch.as_tensor(P),
                             torch.as_tensor(c), 0.7).numpy()
    b = np.asarray(jproj.proj_ellipsoid(y, P, c, 0.7))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("alpha", [1.0, -1.0])
def test_proj_ssoc_equal(alpha):
    y = _rand((40, 3), 6)
    d = _rand(40, 7) * 0.3
    for fn_t, fn_j, extra in ((tproj.proj_soc, jproj.proj_soc, ()),
                              (tproj.proj_ssoc, jproj.proj_ssoc,
                               (alpha, d))):
        a = fn_t(torch.as_tensor(y),
                 *(torch.as_tensor(e) if isinstance(e, np.ndarray) else e
                   for e in extra)).numpy()
        b = np.asarray(fn_j(y, *extra))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_proj_diamond_equal():
    y = _rand((40, 3), 8)
    lb, ub = -0.5 + 0.1 * _rand(40, 9), 0.5 + 0.1 * _rand(40, 10)
    a = tproj.proj_diamond(torch.as_tensor(y), torch.as_tensor(lb),
                           torch.as_tensor(ub)).numpy()
    b = np.asarray(jproj.proj_diamond(y, lb, ub))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
