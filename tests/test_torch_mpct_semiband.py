"""MPCT-ADMM-semiband in the PyTorch port: the six dense tests of
tests/test_mpct_semiband.py (the in-repo oracle of
spcies_MPCT_ADMM_semiband_solver.m, across hard and soft constraints and
plain and constrained output), the JAX dense engine's per-lane k and
e_flag with iterates within 1e-9 in fp64 (vector rho, warm start and a
batch included), ingredients carried across from the JAX package, error
probes, and the banded backend (the two-level Woodbury as stage-local
operators): the four banded tests of tests/test_mpct_semiband.py, each
held to the JAX package's banded solver and to the port's dense one, its
memory contract (nothing O(N^2) among its ingredients), and its
ingredients carried across."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import mpct_admm_semiband_oracle

import spcies_tpu_torch as tsp
from spcies_tpu_torch.convert import ingredients_from_jax

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


SB = dict(formulation="MPCT", method="ADMM", submethod="semiband")
OPTS = dict(rho=0.5, tol_p=1e-7, tol_d=1e-7, k_max=5000)


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = 10.0 * np.asarray(param["Q"])
    param["S"] = np.asarray(param["R"]).copy()
    return sys, param, status


def _with_output(sys, n, m=2):
    """The three mass positions as constrained outputs y = C x."""
    sys = dict(sys)
    sys["C"] = np.eye(3, n)
    sys["D"] = np.zeros((3, m))
    sys["LBy"] = -0.25 * np.ones(3)
    sys["UBy"] = 0.25 * np.ones(3)
    return sys


def _run_pair(sys, param, st, **extra):
    opts = {**OPTS, **extra}
    s = tsp.make_solver(sys, param, **SB, **opts, device="cpu")
    res = s(st["x"], st["xr"], st["ur"])
    return s, res, mpct_admm_semiband_oracle(sys, param, st["x"], st["xr"],
                                             st["ur"], **opts)


def _assert_oracle(res, oracle):
    u_o, k_o, e_o, sol_o = oracle
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9


def test_hard_vs_oracle(fixture):
    sys, param, st = fixture
    _, res, oracle = _run_pair(sys, param, st)
    _assert_oracle(res, oracle)
    assert np.max(np.abs(res.u[0].numpy() - oracle[0])) < 1e-9


def test_hard_u_matches_eadmm(fixture):
    """semiband solves the same MPCT QP as EADMM: control actions agree."""
    sys, param, st = fixture
    _, res, _ = _run_pair(sys, param, st)
    s_ea = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                           rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000,
                           device="cpu")
    u_ea = s_ea(st["x"], st["xr"], st["ur"]).u[0].numpy()
    assert np.max(np.abs(res.u[0].numpy() - u_ea)) < 1e-4


def test_soft_vs_oracle(fixture):
    sys, param, st = fixture
    _, res, oracle = _run_pair(sys, param, st, soft_constraints=True,
                               beta=1.0)
    _assert_oracle(res, oracle)


def test_soft_allows_violation_with_infeasible_x0(fixture):
    """With an initial state outside the feasible tube, soft constraints
    must still converge."""
    sys, param, st = fixture
    x_bad = np.asarray(st["x"]) * 20.0   # positions beyond the 0.3 bound
    s = tsp.make_solver(sys, param, **SB, rho=0.5, tol_p=1e-5, tol_d=1e-5,
                        k_max=5000, soft_constraints=True, beta=1.0,
                        device="cpu")
    assert int(s(x_bad, st["xr"], st["ur"]).e_flag[0]) == 1


def test_constrained_output_vs_oracle(fixture):
    sys, param, st = fixture
    sys = _with_output(sys, len(st["x"]))
    s, res, oracle = _run_pair(sys, param, st, constrained_output=True)
    _assert_oracle(res, oracle)
    # the output bound binds tighter than the state bound it shadows
    v = res.sol["v"][0].numpy()
    sv = s.n + s.m + 3
    for stage in range(1, s.N):
        y = v[stage * sv + s.n + s.m:(stage + 1) * sv]
        assert np.all(y <= 0.25 + 1e-8)


def test_soft_constrained_output_vs_oracle(fixture):
    sys, param, st = fixture
    sys = _with_output(sys, len(st["x"]))
    _, res, oracle = _run_pair(sys, param, st, constrained_output=True,
                               soft_constraints=True, beta=2.0)
    _assert_oracle(res, oracle)


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


CASES = {
    "hard": {},
    "soft": dict(soft_constraints=True, beta=1.0),
    "output": dict(constrained_output=True),
    "soft-output": dict(constrained_output=True, soft_constraints=True,
                        beta=2.0),
    "vector-rho": dict(rho="vector"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_fp64_matches_jax_dense(fixture, case):
    """The JAX dense engine's per-lane k and e_flag, with z, v and lam
    within 1e-9, on a batch of 6 and on a warm start from it."""
    sys, param, st = fixture
    extra = dict(CASES[case])
    if extra.get("constrained_output"):
        sys = _with_output(sys, len(st["x"]))
    if extra.get("rho") == "vector":
        n, m, N = len(st["x"]), 2, int(param["N"])
        rng = np.random.default_rng(3)
        extra["rho"] = 0.3 + 0.4 * rng.random((N + 1) * (n + m))
    kw = {**OPTS, "tol_p": 1e-6, "tol_d": 1e-6, **extra}
    s_j = jsp.make_solver(sys, param, **SB, **kw)
    s_t = tsp.make_solver(sys, param, **SB, **kw, device="cpu")
    x = _batch(st, 6, 4)
    rj, rt = s_j(*x), s_t(*x)
    warm = [s(*x, init=(r.sol["z"], r.sol["v"], r.sol["lam"]))
            for s, r in ((s_j, rj), (s_t, rt))]
    for a, b in ((rj, rt), tuple(warm)):
        np.testing.assert_array_equal(b.k.numpy(), np.asarray(a.k))
        np.testing.assert_array_equal(b.e_flag.numpy(), np.asarray(a.e_flag))
        for key in ("z", "v", "lam", "r_p", "r_d"):
            np.testing.assert_allclose(b.sol[key].numpy(),
                                       np.asarray(a.sol[key]), rtol=0,
                                       atol=1e-9, err_msg=key)
    assert np.all(rt.e_flag.numpy() == 1)


def test_ingredients_from_jax(fixture):
    """The JAX solver's ingredients drive the port's builder to the same
    answer as the port's own offline computation."""
    sys, param, st = fixture
    sys = _with_output(sys, len(st["x"]))
    kw = dict(OPTS, constrained_output=True, soft_constraints=True,
              beta=2.0)
    s_j = jsp.make_solver(sys, param, **SB, **kw)
    ing = ingredients_from_jax(s_j.ingredients, **SB)
    x = _batch(st, 4, 5)
    res = [tsp.make_solver(sys, param, **SB, **kw, ingredients=i,
                           device="cpu")(*x) for i in (ing, None)]
    assert torch.equal(res[0].k, res[1].k)
    for key in ("z", "v", "lam"):
        np.testing.assert_allclose(res[0].sol[key].numpy(),
                                   res[1].sol[key].numpy(), rtol=0,
                                   atol=1e-9)


def test_fixed_iters_and_debug_traces(fixture):
    sys, param, st = fixture
    x = _batch(st, 3, 6)
    s = tsp.make_solver(sys, param, **SB, **OPTS, device="cpu")
    r = s(*x, fixed_iters=20)
    assert np.all(r.k.numpy() == 20) and np.all(r.e_flag.numpy() == 1)
    o = tsp.default_options("MPCT", "ADMM", "semiband", **OPTS)
    o.debug = 2
    rd = tsp.make_solver(sys, param, **SB, options=o, device="cpu")(*x)
    k = rd.k.numpy()
    assert rd.sol["hRp"].shape[:2] == (3, OPTS["k_max"])
    for i in range(3):
        assert float(rd.sol["hRp"][i, k[i] - 1]) == float(rd.sol["r_p"][i])


@pytest.mark.parametrize("probe,exc,match", [
    (dict(backend="banded", rho=np.ones(7)), ValueError, "must have length"),
    (dict(backend="fused"), ValueError, "dense and banded"),
    (dict(constrained_output=True), ValueError, "LBy"),
])
def test_error_probes(fixture, probe, exc, match):
    sys, param, _ = fixture
    with pytest.raises(exc, match=match):
        tsp.make_solver(sys, param, **SB, **probe, device="cpu")


# ---------------------------------------------------------------------------
# the O(N)-memory structured backend (two-level Woodbury, backend='banded')
# ---------------------------------------------------------------------------

def _hold(got, ref, tol=1e-9):
    """Per-lane k and e_flag equal, z, v and lam within tol."""
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(got.e_flag.numpy(), np.asarray(ref.e_flag))
    for key in ("z", "v", "lam"):
        np.testing.assert_allclose(got.sol[key].numpy(),
                                   np.asarray(ref.sol[key]), rtol=0,
                                   atol=tol, err_msg=key)


def _banded_trio(sys, param, x, **kw):
    """The port's banded solve of x, held to the JAX package's banded
    solve and to the port's dense one; returns the port's banded solver
    and result."""
    s_t = tsp.make_solver(sys, param, **SB, backend="banded", **kw,
                          device="cpu")
    r_t = s_t(*x)
    assert np.all(r_t.e_flag.numpy() == 1)
    _hold(r_t, jsp.make_solver(sys, param, **SB, backend="banded", **kw)(*x))
    _hold(r_t, tsp.make_solver(sys, param, **SB, **kw, device="cpu")(*x))
    return s_t, r_t


@pytest.mark.parametrize("extra", [
    dict(),
    dict(soft_constraints=True, beta=1.0),
    dict(constrained_output=True),
    dict(soft_constraints=True, constrained_output=True, beta=2.0),
], ids=["hard", "soft", "output", "soft-output"])
def test_banded_backend_matches_dense(fixture, extra):
    """tests/test_mpct_semiband.py:129-160 on a batch of 4, and a warm
    start from it against the JAX package's from its own."""
    sys, param, st = fixture
    if extra.get("constrained_output"):
        sys = _with_output(sys, len(st["x"]))
    kw = {**OPTS, **extra}
    x = _batch(st, 4, 7)
    s_t, r_t = _banded_trio(sys, param, x, **kw)
    s_j = jsp.make_solver(sys, param, **SB, backend="banded", **kw)
    r_j = s_j(*x)
    _hold(*(s(*x, init=(r.sol["z"], r.sol["v"], r.sol["lam"]))
            for s, r in ((s_t, r_t), (s_j, r_j))))


def test_banded_backend_long_horizon(fixture):
    """tests/test_mpct_semiband.py:163-186: N=120, where the dense M_q
    would be (121 * 8)^2, and the memory contract: no O(N^2) array among
    the banded ingredients."""
    sys, param, st = fixture
    p = dict(param, N=120)
    kw = dict(rho=0.5, tol_p=1e-6, tol_d=1e-6, k_max=3000)
    s, _ = _banded_trio(sys, p, (st["x"], st["xr"], st["ur"]), **kw)
    ing = s.ingredients
    assert ing["M_q"] is None and ing["M_b"] is None
    nz = ing["nz"]
    for key in ("blocks_inv", "Gu", "Gv", "Alpha", "BetaInv", "Pu", "Vt"):
        assert np.asarray(ing[key]).size < nz * 20 * (ing["n"] + ing["m"])


def test_banded_backend_vector_rho(fixture):
    """tests/test_mpct_semiband.py:189-205: a per-entry rho through the
    structured stage blocks, on a batch of 3."""
    sys, param, st = fixture
    n, m, N = len(st["x"]), 2, int(param["N"])
    rng = np.random.default_rng(3)
    rho_vec = 0.3 + 0.4 * rng.random((N + 1) * (n + m))
    _banded_trio(sys, param, _batch(st, 3, 8), rho=rho_vec, tol_p=1e-7,
                 tol_d=1e-7, k_max=5000)


def test_banded_parallel_scan_matches_sequential(fixture):
    """tests/test_mpct_semiband.py:208-228 at N=40: the scan band solve
    gives the sequential one's k and iterates within 1e-8 (the JAX
    package's bar), the JAX package's scan's and the port's dense engine's
    within 1e-9."""
    sys, param, st = fixture
    p = dict(param, N=40)
    kw = dict(rho=0.5, tol_p=1e-6, tol_d=1e-6, k_max=3000)
    x = (st["x"], st["xr"], st["ur"])
    _, r_scan = _banded_trio(sys, p, x, band_parallel_scan=True, **kw)
    r_seq = tsp.make_solver(sys, p, **SB, backend="banded", **kw,
                            device="cpu")(*x)
    _hold(r_scan, r_seq, tol=1e-8)


def test_banded_ingredients_from_jax(fixture):
    """The JAX banded solver's structured ingredients, carried across with
    convert.BANDED_KEYS, drive the port's banded builder to the answer of
    its own offline computation."""
    sys, param, st = fixture
    sys = _with_output(sys, len(st["x"]))
    kw = dict(OPTS, constrained_output=True, soft_constraints=True,
              beta=2.0)
    ing = ingredients_from_jax(
        jsp.make_solver(sys, param, **SB, backend="banded",
                        **kw).ingredients, **SB, backend="banded")
    x = _batch(st, 4, 9)
    got, own = (tsp.make_solver(sys, param, **SB, backend="banded", **kw,
                                ingredients=i, device="cpu")(*x)
                for i in (ing, None))
    _hold(got, own, tol=1e-12)


def test_fp32_banded_against_fp32_dense(fixture):
    """In fp32 the banded engine ends every lane within one iteration of
    the fp32 dense engine at tol 1e-4, with u within 1e-4 where k agrees:
    the bar chip_smoke.py holds the card's fp32 banded rows to."""
    sys, param, st = fixture
    x = _batch(st, 32, 10)
    runs = []
    for backend in ("banded", "dense"):
        o = tsp.default_options("MPCT", "ADMM", "semiband",
                                **dict(OPTS, tol_p=1e-4, tol_d=1e-4))
        o.precision = "float"
        runs.append(tsp.make_solver(sys, param, **SB, options=o,
                                    backend=backend, device="cpu")(*x))
    rb, rd = runs
    assert np.all(rb.e_flag.numpy() == 1) and np.all(rd.e_flag.numpy() == 1)
    dk = rb.k.numpy().astype(int) - rd.k.numpy().astype(int)
    assert np.abs(dk).max() <= 1, dk
    same = dk == 0
    assert np.abs(rb.u.numpy() - rd.u.numpy())[same].max() <= 1e-4
