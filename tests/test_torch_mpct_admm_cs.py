"""MPCT-ADMM-cs in the PyTorch port: ports of tests/test_mpct_admm_cs.py
(golden optimum, numpy oracle, u against EADMM, batched masking) on the
dense backend, the JAX dense engine's k and iterates in fp64, the MPCT-cs
case of tests/test_fused_admm.py:162 (the box-ADMM kernel's plain version
against the JAX fused kernel in interpret mode), the slice as a whole from
ingredients carried across from the JAX package for both MPCT triples, and
error probes. The banded tests of tests/test_mpct_admm_cs.py are in
tests/test_torch_banded.py, the time-varying ones in
tests/test_torch_time_varying.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import mpct_admm_cs_oracle
from tests.golden.mpct_admm_cs_golden import Z_OPT

import spcies_tpu_torch as tsp
from spcies_tpu_torch.convert import ingredients_from_jax
from spcies_tpu_torch.kernels import fused_admm as fa

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

OPTS = dict(rho=1e-2, tol=1e-7, k_max=5000)   # test_MPCT_ADMM.m
CS = dict(formulation="MPCT", method="ADMM", submethod="cs")


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = 10.0 * np.asarray(param["Q"])
    param["S"] = np.asarray(param["R"]).copy()
    return sys, param, status


@pytest.fixture(scope="module")
def solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, **CS, **OPTS, device="cpu")


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def test_vs_golden(solver, fixture):
    _, _, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_vs_oracle(solver, fixture):
    sys, param, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = mpct_admm_cs_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_u_matches_eadmm(solver, fixture):
    """cs and EADMM solve the same MPCT QP: the control actions agree to
    the optimisation tolerance."""
    sys, param, st = fixture
    s_ea = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                           rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000,
                           device="cpu")
    u_cs = solver(st["x"], st["xr"], st["ur"]).u[0].numpy()
    u_ea = s_ea(st["x"], st["xr"], st["ur"]).u[0].numpy()
    assert np.max(np.abs(u_cs - u_ea)) < 1e-4


def test_batched_masking(solver, fixture):
    _, _, st = fixture
    x0s, xr, ur = _batch(st, 3, 9)
    batched = solver(x0s, xr, ur)
    for i in range(3):
        solo = solver(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("relax_alpha", [1.0, 1.6])
def test_dense_fp64_parity(fixture, relax_alpha):
    """The JAX dense engine's per-lane k and e_flag, iterates within 1e-9,
    warm start included."""
    sys, param, st = fixture
    kw = dict(rho=0.1, tol=1e-7, k_max=5000, relax_alpha=relax_alpha)
    s_j, s_t = (pkg.make_solver(sys, param, **CS, **kw, **_on_cpu(pkg))
                for pkg in (jsp, tsp))
    x = _batch(st, 8, 2)

    def parity(rj, rt):
        np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        for key in ("z", "v", "lam", "r_p", "r_d"):
            np.testing.assert_allclose(rt.sol[key].numpy(),
                                       np.asarray(rj.sol[key]), rtol=0,
                                       atol=1e-9, err_msg=key)
        np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                                   atol=1e-9)

    rt, rj = s_t(*x), s_j(*x)
    parity(rj, rt)
    init_t = (rt.sol["z"], rt.sol["v"], rt.sol["lam"])
    warm_t = s_t(*x, init=init_t)
    assert np.all(warm_t.k.numpy() < rt.k.numpy())
    parity(s_j(*x, init=tuple(a.numpy() for a in init_t)), warm_t)


def _fused_pair(sys, param, **kw):
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("MPCT", "ADMM", "cs", tile_b=8,
                                **{**kw, **extra})
        o.precision = "float"
        out.append(pkg.make_solver(sys, param, **CS, backend="fused",
                                   options=o, **_on_cpu(pkg)))
    return out


@pytest.mark.parametrize("mode", ["checked", "bench-exact-k"])
def test_fused_matches_jax_fused(fixture, mode):
    """MPCT-cs on the box-ADMM kernel (tests/test_fused_admm.py:162: rho
    0.1, tol 1e-4, checked; and the bench's N=30 settings rho 2, exact-k,
    check_every 8): the JAX fused kernel's k and e_flag on every lane,
    iterates within the fp32 drift bound (1e-5, or 2e-7 per iteration;
    lam to rho times that), and u within 1e-4 of the port's fp32 dense
    engine."""
    sys, param, st = fixture
    kw = dict(rho=1e-1, tol=1e-4, k_max=1000)
    if mode == "bench-exact-k":
        kw = dict(rho=2.0, tol=1e-4, k_max=4000, check_every=8,
                  exact_k=True)
    s_j, s_t = _fused_pair(sys, param, **kw)
    x = _batch(st, 8, 4)
    rt, rj = s_t(*x), s_j(*x)
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    assert np.all(rt.e_flag.numpy() == 1)
    atol = max(1e-5, 2e-7 * (int(rt.k.max()) + 8))
    for key in ("z", "v", "r_p", "r_d"):
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(rt.sol["lam"].numpy(),
                               np.asarray(rj.sol["lam"]), rtol=0,
                               atol=max(1.0, kw["rho"]) * atol)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=atol)
    dense_kw = {key: v for key, v in kw.items()
                if key not in ("check_every", "exact_k")}
    o = tsp.default_options("MPCT", "ADMM", "cs", **dense_kw)
    o.precision = "float"
    rd = tsp.make_solver(sys, param, **CS, options=o, device="cpu")(*x)
    assert np.all(rd.e_flag.numpy() == 1)
    np.testing.assert_allclose(rd.u.numpy(), rt.u.numpy(), rtol=0,
                               atol=1e-4)
    before = fa.fused_admm_solve.launches
    s_t(*x)
    assert fa.fused_admm_solve.launches == before


TRIPLES = {
    "EADMM": (("MPCT", "EADMM", ""),
              dict(rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000),
              "mpct_eadmm_ingredients"),
    "ADMM-cs": (("MPCT", "ADMM", "cs"), dict(rho=0.1, tol=1e-7, k_max=5000),
                "mpct_admm_cs_ingredients"),
}


@pytest.mark.parametrize("name", sorted(TRIPLES))
def test_slice_from_jax_ingredients(fixture, name):
    """Both MPCT triples built from one ingredient dict, the JAX solver's
    carried across with ingredients_from_jax(..., submethod=): the port's
    own ingredients' keys and values, and at fp64 the JAX solver's k and
    e_flag on every lane and u within 1e-9, from those ingredients and
    from the port's own."""
    sys, param, st = fixture
    (formulation, method, submethod), kw, fn = TRIPLES[name]
    fm = dict(formulation=formulation, method=method, submethod=submethod)
    s_j = jsp.make_solver(sys, param, **fm, **kw)
    ing = ingredients_from_jax(s_j.ingredients, **fm)
    own = getattr(tsp.formulations.mpct, fn)(
        sys, param, tsp.default_options(formulation, method, submethod,
                                        **kw))
    assert set(ing) == set(own)
    for key, val in own.items():
        if isinstance(val, np.ndarray):
            assert ing[key].dtype == val.dtype, key
            np.testing.assert_allclose(ing[key], val, rtol=0, atol=1e-12)
        else:
            assert ing[key] == val and type(ing[key]) is type(val), key
    with pytest.raises(KeyError, match="lack"):
        ingredients_from_jax({k: v for k, v in s_j.ingredients.items()
                              if k != "LB"}, **fm)
    x = _batch(st, 8, 7)
    rj = s_j(*x)
    for ingredients in (ing, None):
        rt = tsp.make_solver(sys, param, **fm, ingredients=ingredients,
                             **kw, device="cpu")(*x)
        np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                                   atol=1e-9)


def test_semiband_has_no_ingredient_layout():
    # the semiband triple has a layout now (its dense backend is ported):
    # what an empty dict lacks is its keys
    with pytest.raises(KeyError, match="ingredients lack"):
        ingredients_from_jax({}, formulation="MPCT", method="ADMM",
                             submethod="semiband")


@pytest.mark.parametrize("probe,exc,match", [
    # a rho vector of the wrong length; the time-varying mode takes a
    # scalar rho only, and computes its ingredients per call
    (dict(backend="banded", rho_len=7), ValueError, "must have length"),
    (dict(time_varying=True, rho_len=30 * 16), ValueError, "scalar rho"),
    (dict(time_varying=True, backend="fused", ingredients={}), ValueError,
     "per call"),
    (dict(backend="nope"), ValueError, "dense, banded and fused"),
    (dict(backend="fused"), ValueError, "fp32"),
    (dict(backend="fused", precision="float", force_vector_rho=True),
     ValueError, "scalar rho"),
    (dict(submethod="semiband", backend="fused"), ValueError,
     "dense and banded"),
])
def test_error_probes(fixture, probe, exc, match):
    sys, param, _ = fixture
    probe = dict(probe)
    sub = probe.pop("submethod", "cs")
    o = tsp.default_options("MPCT", "ADMM", sub, rho=0.1,
                            **({"force_vector_rho": True}
                               if probe.pop("force_vector_rho", False)
                               else {}))
    o.time_varying = probe.pop("time_varying", False)
    o.precision = probe.pop("precision", "double")
    if "rho_len" in probe:
        o.solver["rho"] = np.full(probe.pop("rho_len"), 0.1)
    with pytest.raises(exc, match=match):
        tsp.make_solver(sys, param, formulation="MPCT", method="ADMM",
                        submethod=sub, options=o, **probe, device="cpu")
