"""HMPC's banded backend in the PyTorch port (the arrowhead-Woodbury
structured KKT on the band solve): ports of the banded cases of
tests/test_hmpc.py (split ADMM and SADMM, the split pair at N=120 on
fixed iterations, the single split with diamond and shifted-SOC sets, the
scan against the sequential band solve), all in fp64, each held to the
JAX package's banded solver (per-lane k and e_flag, iterates within 1e-9)
and to the port's dense engine (k, iterates within 1e-9); warm starts,
ingredients carried across from the JAX package, and the fp32 banded
engine against the fp32 dense one. The random plants of
tests/test_fuzz_differential.py::test_fuzz_hmpc_banded_structure are
tests/test_torch_hmpc_banded_fuzz.py's (a file of their own, so that the
suite's workers share them)."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

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


def _hmpc_param(param, N=None):
    """tests/test_hmpc.py:14-25's harmonic parameters, at horizon N."""
    p = dict(param)
    p.pop("T", None)
    if N is not None:
        p["N"] = N
    p["w"] = 3 * 1.627 * 0.2
    p["Te"] = 10 * p["N"] * np.asarray(p["Q"])
    p["Th"] = p["Te"]
    p["Se"] = np.asarray(p["R"]).copy()
    p["Sh"] = 0.5 * p["Se"]
    return p


@pytest.fixture(scope="module")
def fixture():
    sys, param, st = tsp.systems.tester_fixture()
    return sys, _hmpc_param(param), st


OPTS = dict(rho=2.0, sigma=20.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)
# (method, submethod, extra options) of each triple
TRIPLES = {"single": ("ADMM", "", {}), "split": ("ADMM", "split", {}),
           "sadmm": ("SADMM", "split", dict(alpha=0.95))}


def _solver(pkg, sys, param, which, backend="dense", **kw):
    method, sub, extra = TRIPLES[which]
    where = dict(device="cpu") if pkg is tsp else {}
    return pkg.make_solver(sys, param, formulation="HMPC", method=method,
                           submethod=sub, backend=backend,
                           **{**OPTS, **extra, **kw}, **where)


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _keys(which):
    return ("z", "s", "lam") if which == "single" else ("z", "s", "lam",
                                                         "mu")


def _hold(got, ref, keys, tol=1e-9, k=True):
    """got (the port's) against ref (either package's): per-lane k and
    e_flag equal where `k`, and each iterate within tol."""
    if k:
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(ref.k))
        np.testing.assert_array_equal(got.e_flag.numpy(),
                                      np.asarray(ref.e_flag))
    for key in keys:
        gap = np.max(np.abs(got.sol[key].numpy() - np.asarray(ref.sol[key])))
        assert gap < tol, (key, gap)


def _hold_both(which, sys, param, x, backend_kw=(), fixed_iters=None,
               warm=False, **kw):
    """The port's banded solve of x against the JAX package's banded one
    and the port's dense one; with `warm`, also a warm start from the
    banded result against the JAX package's from its own."""
    extra = dict(backend_kw)
    s_t = _solver(tsp, sys, param, which, "banded", **extra, **kw)
    s_j = _solver(jsp, sys, param, which, "banded", **extra, **kw)
    s_d = _solver(tsp, sys, param, which, **kw)
    rt, rj, rd = (s(*x, fixed_iters=fixed_iters) for s in (s_t, s_j, s_d))
    keys = _keys(which)
    if fixed_iters is None:
        assert np.all(rt.e_flag.numpy() == 1)
    _hold(rt, rj, keys)
    _hold(rt, rd, keys)
    if warm:
        wt, wj = (s(*x, init=tuple(r.sol[key] for key in keys))
                  for s, r in ((s_t, rt), (s_j, rj)))
        _hold(wt, wj, keys)
    return rt


@pytest.mark.parametrize("method,use_soc",
                         [("ADMM", False), ("SADMM", True)])
def test_banded_split_matches_dense(fixture, method, use_soc):
    """tests/test_hmpc.py:228-255: the split pair's banded backend on a
    batch of 4, and a warm start from it."""
    sys, param, st = fixture
    which = "split" if method == "ADMM" else "sadmm"
    _hold_both(which, sys, param, _batch(st, 4, 17), warm=True,
               use_soc=use_soc)


def test_banded_split_long_horizon_n120(fixture):
    """tests/test_hmpc.py:258-280: at N=120 the structured KKT gives the
    dense M1/M2 path's iterates on 100 fixed iterations."""
    sys, param, st = fixture
    x = (st["x"], st["xr"], st["ur"])
    _hold_both("split", sys, _hmpc_param(param, 120), x, fixed_iters=100,
               k_max=2000)


@pytest.mark.parametrize("use_soc", [False, True])
def test_banded_single_matches_dense(fixture, use_soc):
    """tests/test_hmpc.py:283-308: the single split's banded backend (Hz =
    H + rho C'C keeps the arrowhead in box mode) on a batch of 4, and a
    warm start from it."""
    sys, param, st = fixture
    _hold_both("single", sys, param, _batch(st, 4, 19), warm=True,
               use_soc=use_soc)


@pytest.mark.parametrize("which", ["single", "split"])
def test_banded_parallel_scan_matches_sequential(fixture, which):
    """tests/test_hmpc.py:311-335 at N=40 on 100 fixed iterations: the
    scan band solve gives the sequential one's iterates within 1e-8 (the
    JAX package's bar), and the JAX package's scan's and the port's dense
    engine's within 1e-9."""
    sys, param, st = fixture
    p = _hmpc_param(param, 40)
    x = (st["x"], st["xr"], st["ur"])
    r_scan = _hold_both(which, sys, p, x, fixed_iters=100,
                        backend_kw=dict(band_parallel_scan=True),
                        use_soc=False)
    r_seq = _solver(tsp, sys, p, which, "banded", use_soc=False)(
        *x, fixed_iters=100)
    _hold(r_scan, r_seq, _keys(which), tol=1e-8, k=False)


@pytest.mark.parametrize("which", sorted(TRIPLES))
def test_ingredients_from_jax(fixture, which):
    """The JAX solver's ingredients, carried across with the banded
    layout (the common HMPC keys), drive the port's banded builder to the
    answer of its own offline computation."""
    sys, param, st = fixture
    ing = ingredients_from_jax(
        _solver(jsp, sys, param, which).ingredients, "HMPC",
        *TRIPLES[which][:2], backend="banded")
    x = _batch(st, 3, 21)
    got, own = (_solver(tsp, sys, param, which, "banded",
                        ingredients=i)(*x) for i in (ing, None))
    _hold(got, own, _keys(which), tol=1e-12)


@pytest.mark.parametrize("which", sorted(TRIPLES))
def test_fp32_banded_against_fp32_dense(fixture, which):
    """In fp32 the banded engine (the level-2 Woodbury included) ends
    every lane within one iteration of the fp32 dense engine at tol 1e-4,
    with u within 1e-4 where k agrees: the bar chip_smoke.py holds the
    card's fp32 banded rows to."""
    sys, param, st = fixture
    x = _batch(st, 32, 23)
    method, sub, extra = TRIPLES[which]
    runs = []
    for backend in ("banded", "dense"):
        opt = tsp.default_options("HMPC", method, sub, **{
            **OPTS, **extra, "tol_p": 1e-4, "tol_d": 1e-4})
        opt.precision = "float"
        runs.append(tsp.make_solver(sys, param, formulation="HMPC",
                                    method=method, submethod=sub,
                                    options=opt, backend=backend,
                                    device="cpu")(*x))
    rb, rd = runs
    assert np.all(rb.e_flag.numpy() == 1) and np.all(rd.e_flag.numpy() == 1)
    dk = rb.k.numpy().astype(int) - rd.k.numpy().astype(int)
    assert np.abs(dk).max() <= 1, dk
    same = dk == 0
    assert np.abs(rb.u.numpy() - rd.u.numpy())[same].max() <= 1e-4
