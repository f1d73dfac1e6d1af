"""HMPC in the PyTorch port: ports of the dense cases of tests/test_hmpc.py
(numpy oracle and golden optimum for single-split ADMM, split ADMM and
SADMM, each with diamond and shifted-SOC sets; SADMM differs from ADMM;
batched masking), the JAX dense engines' k and iterates in fp64 lane for
lane (box and output mode, warm starts), debug traces and fixed_iters,
ingredients carried across from the JAX package, the fused backends
against the dense engines, and error probes. The banded cases of
tests/test_hmpc.py are tests/test_torch_hmpc_banded.py's."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import hmpc_admm_oracle, hmpc_split_oracle
from tests.golden.hmpc_golden import Z_OPT

import spcies_tpu_torch as tsp
from spcies_tpu_torch.convert import ingredients_from_jax
from spcies_tpu_torch.formulations import base
from spcies_tpu_torch.formulations import hmpc as th
from spcies_tpu_torch.kernels import fused_hmpc as k6
from spcies_tpu_torch.kernels import fused_split as k7

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


@pytest.fixture(scope="module")
def fixture():
    """tests/test_hmpc.py:14-25 (test_HMPC_ADMM.m:14-21), and the same
    plant with the three mass positions as coupled outputs within +-0.3
    (output mode)."""
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    param.pop("T", None)
    param["w"] = 3 * 1.627 * 0.2
    param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
    param["Th"] = param["Te"]
    param["Se"] = np.asarray(param["R"]).copy()
    param["Sh"] = 0.5 * param["Se"]
    sys_e = dict(sys, E=np.eye(3, len(st["x"])), F=np.zeros((3, 2)),
                 LBy=-0.3 * np.ones(3), UBy=0.3 * np.ones(3))
    return sys, sys_e, param, st


OPTS = dict(rho=2.0, sigma=20.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)
# (method, submethod, extra options) of each triple
TRIPLES = {"single": ("ADMM", "", {}), "split": ("ADMM", "split", {}),
           "sadmm": ("SADMM", "split", dict(alpha=0.95))}


def _solver(pkg, sys, param, which, backend="dense", **kw):
    method, sub, extra = TRIPLES[which]
    return pkg.make_solver(sys, param, formulation="HMPC", method=method,
                           submethod=sub, backend=backend,
                           **{**OPTS, **extra, **kw}, **_on_cpu(pkg))


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _keys(which):
    return ("z", "s", "lam") if which == "single" else ("z", "s", "lam",
                                                         "mu")


_SOLO = {}


def _solo(fixture, which, use_soc=False):
    """The port's dense solve of the fixture's state, run once a module
    for the tests that read it."""
    if (which, use_soc) not in _SOLO:
        sys, _, param, st = fixture
        _SOLO[which, use_soc] = _solver(tsp, sys, param, which,
                                        use_soc=use_soc)(
            st["x"], st["xr"], st["ur"])
    return _SOLO[which, use_soc]


@pytest.mark.parametrize("use_soc", [False, True])
@pytest.mark.parametrize("which", sorted(TRIPLES))
def test_vs_oracle_and_golden(fixture, which, use_soc):
    """The numpy oracle's k exactly and iterates within 1e-8, and z within
    1e-4 of the golden optimum (tests/test_hmpc.py:31-76)."""
    sys, _, param, st = fixture
    res = _solo(fixture, which, use_soc)
    if which == "single":
        _, k_o, e_o, sol_o = hmpc_admm_oracle(
            sys, param, st["x"], st["xr"], st["ur"], use_soc=use_soc, **OPTS)
    else:
        _, k_o, e_o, sol_o = hmpc_split_oracle(
            sys, param, st["x"], st["xr"], st["ur"], use_soc=use_soc,
            symmetric=which == "sadmm", **{**OPTS, **TRIPLES[which][2]})
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in _keys(which):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-8
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_sadmm_differs_from_admm_iterations(fixture):
    """The symmetric half-step must actually change the trajectory."""
    assert int(_solo(fixture, "split").k[0]) != int(
        _solo(fixture, "sadmm").k[0])


@pytest.mark.parametrize("which", ["single", "sadmm"])
def test_batched_masking(fixture, which):
    """A batch gives each lane the k and iterates of solving it alone."""
    sys, _, param, st = fixture
    s = _solver(tsp, sys, param, which)
    x0s, xr, ur = _batch(st, 3, 13)
    batched = s(x0s, xr, ur)
    for i in range(3):
        solo = s(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)


def _parity(rj, rt, keys):
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    for key in keys + ("r_p", "r_d"):
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)


@pytest.mark.parametrize("mode", ["diamond", "soc", "output"])
@pytest.mark.parametrize("which", sorted(TRIPLES))
def test_dense_fp64_parity(fixture, which, mode):
    """The JAX dense engines' per-lane k and e_flag, iterates within 1e-9;
    diamond and SOC sets in box mode, and output mode (box rows on s); and
    a warm start, with diamonds (the warm path does not depend on the set).
    sigma 2 keeps the split runs short."""
    sys, sys_e, param, st = fixture
    kw = dict(sigma=2.0, use_soc=mode == "soc")
    s = sys_e if mode == "output" else sys
    s_j, s_t = (_solver(pkg, s, param, which, **kw) for pkg in (jsp, tsp))
    x = _batch(st, 8, 2)
    rt, rj = s_t(*x), s_j(*x)
    keys = _keys(which) + (() if which == "single" else ("z_hat", "s_hat"))
    _parity(rj, rt, keys)
    if mode != "diamond":
        return
    loose = _solver(tsp, s, param, which, k_max=40, **kw)(*x)
    init = tuple(loose.sol[key] for key in _keys(which))
    warm_t = s_t(*x, init=init)
    assert np.all(warm_t.k.numpy() < rt.k.numpy())
    _parity(s_j(*x, init=tuple(a.numpy() for a in init)), warm_t, keys)


@pytest.mark.parametrize("which,debug", [("single", 1), ("single", 2),
                                         ("sadmm", 1), ("sadmm", 2)])
def test_debug_traces_and_fixed_iters(fixture, which, debug):
    """genHist traces as the JAX dense engines record them, and
    fixed_iters."""
    sys, _, param, st = fixture
    method, sub, extra = TRIPLES[which]
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("HMPC", method, sub,
                                **{**OPTS, **extra, "k_max": 200})
        o.debug = debug
        out.append(pkg.make_solver(sys, param, formulation="HMPC",
                                   method=method, submethod=sub, options=o,
                                   **_on_cpu(pkg))(*_batch(st, 3, 3)))
    rj, rt = out
    for key in ("hRp", "hRd") + (("hZ", "hS", "hLam") if debug == 2
                                 else ()):
        assert rt.sol[key].shape[:2] == (3, 200)
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
    r = _solver(tsp, sys, param, which)(*_batch(st, 3, 3), fixed_iters=7)
    assert np.all(r.k.numpy() == 7) and np.all(r.e_flag.numpy() == 1)
    np.testing.assert_allclose(r.sol["r_p"].numpy(),
                               rt.sol["hRp"][:, 6].numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("which", sorted(TRIPLES))
def test_ingredients_from_jax(fixture, which):
    """convert.ingredients_from_jax carries a JAX solver's ingredients to
    the port's builder: the same keys and values as the port's own, and the
    same solve, dense and fused."""
    sys, _, param, st = fixture
    method, sub, extra = TRIPLES[which]
    s_j = _solver(jsp, sys, param, which, use_soc=True)
    ing = ingredients_from_jax(s_j.ingredients, "HMPC", method, sub)
    o = tsp.default_options("HMPC", method, sub, use_soc=True)
    own = th.hmpc_common_ingredients(sys, param, o, split=bool(sub))
    assert set(ing) == set(own)
    for key, val in own.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_allclose(ing[key], val, rtol=0, atol=1e-12,
                                       err_msg=key)
        else:
            assert ing[key] == val, key
    x = _batch(st, 8, 5)
    for backend, precision in (("dense", "double"), ("fused", "float")):
        res = []
        for ingredients in (None, ing):
            # tol 1e-3: use_soc's fp32 floor (tests/test_hmpc.py:147-150)
            o = tsp.default_options("HMPC", method, sub, tile_b=8, **{
                **OPTS, **extra, "sigma": 2.0, "tol_p": 1e-3, "tol_d": 1e-3,
                "use_soc": True})
            o.precision = precision
            res.append(tsp.make_solver(sys, param, formulation="HMPC",
                                       method=method, submethod=sub,
                                       options=o, backend=backend,
                                       ingredients=ingredients,
                                       device="cpu")(*x))
        assert torch.equal(res[0].k, res[1].k)
        assert float((res[0].u - res[1].u).abs().max()) < 1e-12
    with pytest.raises(KeyError, match="'H'"):
        ingredients_from_jax({k: v for k, v in s_j.ingredients.items()
                              if k != "H"}, "HMPC", method, sub)


@pytest.mark.parametrize("which", sorted(TRIPLES))
def test_fused_matches_dense(fixture, which):
    """The fused backends (on the CPU, the kernels' plain versions) track
    the port's fp32 dense engines: per-lane k within one check of each
    other and iterates within 1e-4, as tests/test_hmpc.py:107-196 holds the
    JAX kernels; a warm start from the dense solution exits within a few
    iterations. No kernel is launched on the CPU."""
    sys, _, param, st = fixture
    method, sub, extra = TRIPLES[which]
    kw = dict(OPTS, **extra, sigma=2.0, tol_p=1e-5, tol_d=1e-5, k_max=3000)
    solvers = []
    for backend in ("fused", "dense"):
        o = tsp.default_options("HMPC", method, sub, tile_b=8, **kw)
        o.precision = "float"
        solvers.append(tsp.make_solver(sys, param, formulation="HMPC",
                                       method=method, submethod=sub,
                                       options=o, backend=backend,
                                       device="cpu"))
    before = (k6.fused_hmpc_solve.launches, k7.fused_split_solve.launches)
    x = _batch(st, 8, 7)
    rf, rd = solvers[0](*x), solvers[1](*x)
    assert np.max(np.abs(rf.k.numpy() - rd.k.numpy())) <= 1
    assert np.all(rf.e_flag.numpy() == 1)
    for key in _keys(which):
        assert float((rf.sol[key] - rd.sol[key]).abs().max()) < 1e-4, key
    warm = solvers[0](*x, init=tuple(rd.sol[key] for key in _keys(which)))
    assert int(warm.k.max()) <= 8
    assert (k6.fused_hmpc_solve.launches,
            k7.fused_split_solve.launches) == before


def test_fused_batch_padding(fixture):
    """A batch that is not a multiple of tile_b is padded with zero lanes
    and the outputs are sliced back: the solve returns the kernel's plain
    version's results on the prepared inputs, lane for lane."""
    sys, _, param, st = fixture
    for which, plain in (("single", k6.fused_hmpc_reference),
                         ("split", k7.fused_split_reference)):
        method, sub, extra = TRIPLES[which]
        o = tsp.default_options("HMPC", method, sub, tile_b=8,
                                **{**OPTS, "sigma": 2.0, "tol_p": 1e-5,
                                   "tol_d": 1e-5})
        o.precision = "float"
        s = tsp.make_solver(sys, param, formulation="HMPC", method=method,
                            submethod=sub, options=o, backend="fused",
                            device="cpu")
        x = tsp.api.broadcast_inputs(torch.float32, "cpu", *_batch(st, 5, 1))
        *kin, Bsz = s.raw_fn.prepare(*x)
        assert Bsz == 5 and all(t.shape[0] == 8 for t in kin)
        assert all(bool((t[5:] == 0).all()) for t in kin)
        r5 = s(*x)
        assert tuple(r5.u.shape) == (5, 2) and tuple(r5.k.shape) == (5,)
        out = plain(*kin, *s.raw_fn.operator, **s.raw_fn.kernel_kw)
        assert torch.equal(r5.k, out[3][:5])


def test_builders_registered():
    """Every triple of the JAX package's registry (the four HMPC triples
    among them) has a builder there and in the port, and get_builder
    returns the port's."""
    from spcies_tpu.config import SOLVER_REGISTRY
    from spcies_tpu.formulations import BUILDERS as JAX_BUILDERS
    assert {("HMPC", "ADMM", ""), ("HMPC", "ADMM", "split"),
            ("HMPC", "SADMM", "split"),
            ("ellipHMPC", "ADMM", "")} <= set(SOLVER_REGISTRY)
    for triple in SOLVER_REGISTRY:
        assert triple in JAX_BUILDERS and triple in base.BUILDERS, triple
        assert base.get_builder(*triple) is base.BUILDERS[triple]


@pytest.mark.parametrize("which,probe,exc,match", [
    # the banded backend's refusals: N >= 3, box constraints only
    ("single", dict(backend="banded", N=2), ValueError, "N >= 3"),
    ("split", dict(backend="banded", N=2), ValueError, "N >= 3"),
    ("sadmm", dict(backend="banded", output=True), ValueError,
     "box constraints only"),
    ("single", dict(backend="nope"), ValueError, "unknown backend"),
    ("single", dict(backend="fused", precision="double"), ValueError,
     "fp32"),
    ("split", dict(backend="fused", precision="double"), ValueError, "fp32"),
    ("single", dict(backend="fused", fixed_iters=5), ValueError,
     "fixed_iters"),
    ("sadmm", dict(backend="fused", fixed_iters=5), ValueError,
     "fixed_iters"),
    ("split", dict(sparse=True), ValueError, "sparse"),
    ("single", dict(backend="fused", debug=1), ValueError, "genHist"),
])
def test_error_probes(fixture, which, probe, exc, match):
    sys, sys_e, param, st = fixture
    probe = dict(probe)
    if probe.pop("output", False):
        sys = sys_e
    if "N" in probe:
        param = dict(param, N=probe.pop("N"))
    method, sub, extra = TRIPLES[which]
    o = tsp.default_options("HMPC", method, sub, **{
        **OPTS, **extra, "sparse": probe.pop("sparse", False)})
    o.precision = probe.pop("precision", "float")
    o.debug = probe.pop("debug", 0)
    fixed = probe.pop("fixed_iters", None)
    with pytest.raises(exc, match=match):
        s = tsp.make_solver(sys, param, formulation="HMPC", method=method,
                            submethod=sub, options=o, device="cpu", **probe)
        s(*_batch(st, 8, 0), fixed_iters=fixed)
