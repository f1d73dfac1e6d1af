"""equMPC (ADMM and FISTA) in the PyTorch port: ports of
tests/test_equmpc.py (golden optimum, numpy oracles, terminal state,
batched masking) on the dense backend, the JAX dense engine's k and
iterates in fp64, the equMPC case of tests/test_fused_admm.py:163 (the
box-ADMM kernel's plain version against the JAX fused kernel in
interpret mode), ingredients carried across from the JAX package for each
of the slice's triples, and error probes."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import equmpc_admm_oracle, equmpc_fista_oracle
from tests.golden.equmpc_golden import Z_OPT

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

ADMM_OPTS = dict(rho=15.0, tol=1e-7, k_max=5000)   # test_equMPC_ADMM.m:6-8
FISTA_OPTS = dict(tol=1e-7, k_max=5000)            # test_equMPC_FISTA.m:6-7

# fp32 box-ADMM iterates, as tests/test_torch_fused_admm.py holds them:
# 1e-5, or 2e-7 per iteration run, and lam to rho times that
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param.pop("T", None)  # equMPC has no terminal cost
    return sys, param, status


@pytest.fixture(scope="module")
def admm_solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, formulation="equMPC", method="ADMM",
                           **ADMM_OPTS, device="cpu")


@pytest.fixture(scope="module")
def fista_solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, formulation="equMPC", method="FISTA",
                           **FISTA_OPTS, device="cpu")


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def test_admm_vs_golden(admm_solver, fixture):
    _, _, st = fixture
    res = admm_solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_admm_vs_oracle(admm_solver, fixture):
    sys, param, st = fixture
    res = admm_solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = equmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **ADMM_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


@pytest.mark.parametrize("method", ["ADMM", "FISTA"])
def test_terminal_state_reaches_xr(admm_solver, fista_solver, fixture,
                                   method):
    """The terminal equality x_N = xr holds at the solution: propagate the
    dynamics from the last stage and compare."""
    sys, _, st = fixture
    solver = admm_solver if method == "ADMM" else fista_solver
    res = solver(st["x"], st["xr"], st["ur"])
    z = res.sol["z"][0].numpy()
    n, m = solver.n, solver.m
    assert z.shape == (solver.N * (n + m) - n,)
    xl = z[-(n + m):-m]
    ul = z[-m:]
    xN = np.asarray(sys["A"]) @ xl + np.asarray(sys["B"]) @ ul
    assert np.max(np.abs(xN - st["xr"])) < 1e-5


def test_fista_vs_golden(fista_solver, fixture):
    _, _, st = fixture
    res = fista_solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_fista_vs_oracle(fista_solver, fixture):
    sys, param, st = fixture
    res = fista_solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = equmpc_fista_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **FISTA_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


@pytest.mark.parametrize("method", ["ADMM", "FISTA"])
def test_batched_masking(admm_solver, fista_solver, fixture, method):
    _, _, st = fixture
    solver = admm_solver if method == "ADMM" else fista_solver
    x0s, xr, ur = _batch(st, 4, 1)
    batched = solver(x0s, xr, ur)
    for i in range(4):
        solo = solver(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("relax_alpha", [1.0, 1.8])
def test_admm_dense_fp64_parity(fixture, relax_alpha):
    """The JAX dense engine's per-lane k and e_flag, iterates within 1e-9,
    warm start included."""
    sys, param, st = fixture
    s_j, s_t = (pkg.make_solver(sys, param, formulation="equMPC",
                                method="ADMM", relax_alpha=relax_alpha,
                                **ADMM_OPTS, **_on_cpu(pkg))
                for pkg in (jsp, tsp))
    x = _batch(st, 8, 2)
    rt, rj = s_t(*x), s_j(*x)
    assert s_t.stage_layout == ("stagewise", False)

    def parity(rj, rt):
        np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        for key in ("z", "v", "lam", "r_p", "r_d"):
            np.testing.assert_allclose(rt.sol[key].numpy(),
                                       np.asarray(rj.sol[key]), rtol=0,
                                       atol=1e-9, err_msg=key)

    parity(rj, rt)
    init_t = (rt.sol["z"], rt.sol["v"], rt.sol["lam"])
    init_j = tuple(np.asarray(rj.sol[key]) for key in ("z", "v", "lam"))
    warm_t = s_t(*x, init=init_t)
    assert np.all(warm_t.k.numpy() < rt.k.numpy())
    parity(s_j(*x, init=init_j), warm_t)


def _fused_admm_pair(sys, param, **kw):
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("equMPC", "ADMM", tile_b=8, **extra, **kw)
        o.precision = "float"
        out.append(pkg.make_solver(sys, param, formulation="equMPC",
                                   method="ADMM", backend="fused",
                                   options=o, **_on_cpu(pkg)))
    return out


@pytest.mark.parametrize("mode", ["checked", "bench-exact-k"])
def test_fused_admm_matches_jax_fused(fixture, mode):
    """equMPC on the box-ADMM kernel (tests/test_fused_admm.py:163, and the
    bench's N=30 settings rho 6, relax_alpha 1.8, exact-k): the JAX fused
    kernel's k and e_flag, iterates within the fp32 drift bound, and u
    within 1e-4 of the port's fp32 dense engine. In checked mode lane 6
    ends at the tolerance boundary: its r_d at k=414 is 1.00017e-4 here,
    just under 1e-4 in the JAX run, so it exits one iteration later."""
    sys, param, st = fixture
    kw = dict(rho=15.0, tol=1e-4, k_max=1000)
    moved = [6]
    if mode == "bench-exact-k":
        kw = dict(rho=6.0, relax_alpha=1.8, tol=1e-4, k_max=4000,
                  check_every=8, exact_k=True)
        moved = []
    s_j, s_t = _fused_admm_pair(sys, param, **kw)
    x = _batch(st, 8, 4)
    rt, rj = s_t(*x), s_j(*x)
    same = np.ones(8, bool)
    same[moved] = False
    kt, kj = rt.k.numpy(), np.asarray(rj.k)
    np.testing.assert_array_equal(kt[same], kj[same])
    assert np.all(np.abs(kt - kj) <= 1)
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    assert np.all(rt.e_flag.numpy() == 1)
    atol = max(ATOL_FP32, ATOL_PER_ITER * (int(rt.k.max()) + 8))
    for key in ("z", "v", "r_p", "r_d"):
        np.testing.assert_allclose(rt.sol[key].numpy()[same],
                                   np.asarray(rj.sol[key])[same], rtol=0,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(rt.sol["lam"].numpy()[same],
                               np.asarray(rj.sol["lam"])[same], rtol=0,
                               atol=kw["rho"] * atol)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=atol)
    # the dense engine forms dq in another order (rho (zr - v) - rho (v -
    # v_prev)), so its fp32 k may differ; its answer agrees to tol scale
    dense_kw = {key: v for key, v in kw.items()
                if key not in ("check_every", "exact_k")}
    o = tsp.default_options("equMPC", "ADMM", **dense_kw)
    o.precision = "float"
    rd = tsp.make_solver(sys, param, formulation="equMPC", method="ADMM",
                         options=o, device="cpu")(*x)
    assert np.all(rd.e_flag.numpy() == 1)
    np.testing.assert_allclose(rd.u.numpy(), rt.u.numpy(), rtol=0,
                               atol=1e-4)


def test_fused_admm_on_cpu_launches_nothing(fixture):
    sys, param, st = fixture
    _, s_t = _fused_admm_pair(sys, param, rho=15.0, tol=1e-4, k_max=1000)
    before = fa.fused_admm_solve.launches
    s_t(*_batch(st, 8, 0))
    assert fa.fused_admm_solve.launches == before


TRIPLES = {
    "laxMPC-FISTA": ("laxMPC", "FISTA", {}),
    "equMPC-ADMM": ("equMPC", "ADMM", dict(rho=15.0)),
    "equMPC-FISTA": ("equMPC", "FISTA", {}),
}


@pytest.mark.parametrize("name", sorted(TRIPLES))
def test_ingredients_from_jax_per_triple(name):
    """A JAX solver's ingredients convert for every triple of the slice
    (ingredients_from_jax used to require the laxMPC-ADMM keys, T and M_b
    among them, of every dict, and raised KeyError for these), hold the
    port's own ingredients' keys and values, and drive the port's builder
    to the same result as building from sys and param."""
    formulation, method, kw = TRIPLES[name]
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    if formulation == "laxMPC":
        param["T"] = np.diag(np.sum(param["T"], axis=1))
    else:
        param.pop("T")
    s_j = jsp.make_solver(sys, param, formulation=formulation, method=method,
                          **kw)
    ing = ingredients_from_jax(s_j.ingredients, formulation=formulation,
                               method=method)
    mod = getattr(tsp.formulations, formulation.lower())
    own = getattr(mod, f"{formulation.lower()}_{method.lower()}_ingredients")(
        sys, param, tsp.default_options(formulation, method, **kw))
    assert set(ing) == set(own)
    for key, val in own.items():
        if isinstance(val, np.ndarray):
            assert ing[key].dtype == val.dtype, key
            np.testing.assert_allclose(ing[key], val, rtol=0, atol=1e-12)
        else:
            assert ing[key] == val and type(ing[key]) is type(val), key
    with pytest.raises(KeyError):
        ingredients_from_jax({k: v for k, v in s_j.ingredients.items()
                              if k != "LB_z"}, formulation=formulation,
                             method=method)
    x = _batch(st, 8, 7)
    for backend, precision in (("dense", "double"), ("fused", "float")):
        res = []
        for ingredients in (None, ing):
            o = tsp.default_options(formulation, method, tol=1e-5,
                                    k_max=3000, tile_b=8, **kw)
            o.precision = precision
            res.append(tsp.make_solver(sys, param, formulation=formulation,
                                       method=method, options=o,
                                       backend=backend,
                                       ingredients=ingredients,
                                       device="cpu")(*x))
        assert torch.equal(res[0].k, res[1].k)
        for key in res[0].sol:
            if key != "times_ms":
                assert torch.equal(res[0].sol[key], res[1].sol[key]), key
        assert bool((res[0].e_flag == 1).all())


def test_ingredients_from_jax_unknown_triple():
    with pytest.raises(KeyError, match="no ingredient layout"):
        ingredients_from_jax({}, formulation="personal", method="mine")


@pytest.mark.parametrize("method", ["ADMM", "FISTA"])
@pytest.mark.parametrize("probe,exc,match", [
    # the time-varying mode computes its ingredients per call, and its
    # nine inputs have the ranks (1, 1, 1, 2, 2, 1, 1, 1, 1)
    (dict(time_varying=True, ingredients={}), ValueError, "per call"),
    (dict(time_varying=True, bad_rank=True), ValueError, "rank 2"),
    (dict(backend="nope"), ValueError, "unknown backend"),
    (dict(backend="fused"), ValueError, "fp32"),
    (dict(nondiag_q=True), ValueError, "diagonal"),
])
def test_error_probes(fixture, method, probe, exc, match):
    sys, param, st = fixture
    probe = dict(probe)
    p = dict(param)
    if probe.pop("nondiag_q", False):
        p["Q"] = np.asarray(p["Q"]) + 0.1
    o = tsp.default_options("equMPC", method, rho=15.0)
    o.time_varying = probe.pop("time_varying", False)
    bad_rank = probe.pop("bad_rank", False)
    with pytest.raises(exc, match=match):
        s = tsp.make_solver(sys, p, formulation="equMPC", method=method,
                            options=o, **probe, device="cpu")
        if bad_rank:
            # A given as a vector where one problem's A is a matrix
            s(st["x"], st["xr"], st["ur"], np.ravel(sys["A"]), sys["B"],
              np.diag(p["Q"]), np.diag(p["R"]),
              np.concatenate([sys["LBx"], sys["LBu"]]),
              np.concatenate([sys["UBx"], sys["UBu"]]))
