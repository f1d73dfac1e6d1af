"""The port's API extras against the JAX package: backend='auto' (ports of
the three auto-backend tests of tests/test_api_misc.py:206-296, and the
port's own decisions: a cache key that holds the tuning options and the
model, a candidate skipped only where its builder refuses it, a cached
'fused' never served to a debug build, no ingredients= under auto, the
fused probe's exact iteration count, every triple in fp32),
BatchedSolver.aot_memory_analysis
(None on the CPU), the debug traces of tests/test_api_misc.py:125, and
tests/test_option_registry.py: every advertised knob of the 13 triples
builds and solves in both packages with u within 1e-9 in fp64, or raises
the same exception type in both; and its other tests (:122-215 and
:243-265, banded among the traced backends); its codegen test (:217) is
ported in test_torch_codegen_c.py. Also ports of test_api_misc.py's
test_make_solver_autodetects and test_personal_formulation_hatch (a
builder of the JAX plugin signature, ROADMAP queue 3 F1), and the
replica's copy of the recipe (F2). Every auto test points the cache at
a temporary directory."""

import json
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.config import SOLVER_REGISTRY
from tests.test_option_registry import PROBES, EXPECT_RAISE
from tests.test_option_registry import _inputs_for, _params_for

import spcies_tpu_torch as tsp
from spcies_tpu_torch import api
from spcies_tpu_torch.formulations import base as fbase
from spcies_tpu_torch.solvers import fused_backend

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


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SPCIES_AUTO_CACHE_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture(scope="module")
def fixture():
    return tsp.systems.tester_fixture()


# the auto tests' laxMPC-ADMM build, with a short probe
AUTO = dict(formulation="laxMPC", method="ADMM", backend="auto", rho=15.0,
            tol=1e-6, k_max=5000, auto_probe_batch=64, auto_probe_iters=5,
            auto_probe_reps=1, device="cpu")


def _counting(monkeypatch, triple, fail=None):
    """Replace triple's builder by one that records each backend it is
    asked for; `fail` maps a backend to the exception its build raises,
    or to a function of the built solver that replaces the solver's
    raw_fn (a solve that fails)."""
    builds = []
    real = fbase.get_builder(*triple)

    def counting(sys, param, opt, backend="dense", device="cuda",
                 ingredients=None):
        builds.append(backend)
        what = (fail or {}).get(backend)
        if isinstance(what, Exception):
            raise what
        solver = real(sys, param, opt, backend=backend, device=device,
                      ingredients=ingredients)
        if what is not None:
            solver.raw_fn = what(solver.raw_fn)
        return solver

    monkeypatch.setitem(fbase.BUILDERS, triple, counting)
    return builds


def test_auto_backend_selection(fixture, cache_dir):
    """tests/test_api_misc.py:206-230: 'auto' probes the backends and
    keeps the fastest, which solves as the dense engine does."""
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, **AUTO)
    assert s.backend_choice in ("dense", "fused", "banded")
    # fp64: the fused backend refuses at build, so it is no candidate
    assert set(s.backend_probe_s) == {"dense", "banded"}
    res = s(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    ref = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          rho=15.0, tol=1e-6, k_max=5000, device="cpu")(
        st["x"], st["xr"], st["ur"])
    assert np.max(np.abs(res.u[0].numpy() - ref.u[0].numpy())) < 1e-6


def test_auto_backend_single_candidate(fixture, cache_dir):
    """tests/test_api_misc.py:233-251: MPCT-ADMM-semiband under 'auto'
    (dense and banded) records its choice and solves."""
    sys, param, st = fixture
    p = dict(param, T=10.0 * np.asarray(param["Q"]),
             S=np.asarray(param["R"]).copy())
    s = tsp.make_solver(sys, p, formulation="MPCT", method="ADMM",
                        submethod="semiband", backend="auto", rho=0.5,
                        tol_p=1e-6, tol_d=1e-6, k_max=3000,
                        auto_probe_batch=64, auto_probe_iters=5,
                        auto_probe_reps=1, device="cpu")
    assert s.backend_choice in ("dense", "banded")
    assert int(s(st["x"], st["xr"], st["ur"]).e_flag[0]) == 1


def test_auto_backend_probe_cache(fixture, cache_dir, monkeypatch):
    """tests/test_api_misc.py:254-296: the choice persists on disk, and a
    second build under the same key builds only the winner; refresh
    probes again; another shape misses the cache."""
    sys, param, st = fixture
    builds = _counting(monkeypatch, ("laxMPC", "ADMM", ""))
    s1 = tsp.make_solver(sys, param, **AUTO)
    assert not s1.backend_probe_cached
    n_first = len(builds)
    assert n_first >= 2
    assert (cache_dir / "spcies_auto_backend.json").exists()

    s2 = tsp.make_solver(sys, param, **AUTO)
    assert s2.backend_probe_cached and s2.backend_probe_s == {}
    assert s2.backend_choice == s1.backend_choice
    assert builds[n_first:] == [s1.backend_choice]

    s3 = tsp.make_solver(sys, param, auto_probe_refresh=True, **AUTO)
    assert not s3.backend_probe_cached
    assert len(builds) > n_first + 1

    s4 = tsp.make_solver(sys, dict(param, N=12), **AUTO)
    assert not s4.backend_probe_cached
    assert int(s2(st["x"], st["xr"], st["ur"]).e_flag[0]) == 1


@pytest.mark.parametrize("change", ["rho", "tol", "Q", "A"])
def test_auto_cache_key_holds_options_and_model(fixture, cache_dir,
                                                change):
    """The JAX package's key leaves out the tuning options and the model
    (ROADMAP queue 3): the port's key changes with rho, tol and every
    array of sys and param, so such a build probes anew."""
    sys, param, _ = fixture
    s1 = tsp.make_solver(sys, param, **AUTO)
    assert not s1.backend_probe_cached
    kw, sys2, param2 = dict(AUTO), dict(sys), dict(param)
    if change in ("rho", "tol"):
        kw[change] = 2.0 * kw[change]
    elif change == "Q":
        param2["Q"] = 1.5 * np.asarray(param["Q"])
    else:
        sys2["A"] = 0.99 * np.asarray(sys["A"])
    s2 = tsp.make_solver(sys2, param2, **kw)
    assert not s2.backend_probe_cached
    cache = json.loads((cache_dir / "spcies_auto_backend.json").read_text())
    assert len(cache) == 2
    # the same build again is served from the cache
    assert tsp.make_solver(sys2, param2, **kw).backend_probe_cached


@pytest.mark.parametrize("how,exc", [
    ("build", RuntimeError), ("probe", RuntimeError),
    ("nan", FloatingPointError), ("refusal", None)])
def test_auto_skips_only_documented_refusals(fixture, cache_dir,
                                             monkeypatch, how, exc):
    """A candidate whose build raises anything but ValueError or
    NotImplementedError, whose probe solve raises, or whose probe gives a
    non-finite u, fails the auto build: the JAX package's probe would give
    it an infinite time and serve another backend. A documented refusal
    (ValueError at build) skips the candidate."""
    sys, param, st = fixture

    def raising(raw):
        def solve(*args):
            raise RuntimeError("the kernel failed to launch")
        return solve

    def nan(raw):
        def solve(*args):
            res = raw(*args)
            res.u[:] = float("nan")
            return res
        return solve

    fail = {"build": {"banded": RuntimeError("nvcc failed")},
            "probe": {"banded": raising}, "nan": {"banded": nan},
            "refusal": {"banded": ValueError("banded refuses")}}[how]
    _counting(monkeypatch, ("laxMPC", "ADMM", ""), fail)
    if exc is None:
        s = tsp.make_solver(sys, param, **AUTO)
        assert s.backend_choice == "dense"
        assert int(s(st["x"], st["xr"], st["ur"]).e_flag[0]) == 1
    else:
        with pytest.raises(exc):
            tsp.make_solver(sys, param, **AUTO)


def test_cached_fused_not_served_to_debug(fixture, cache_dir):
    """A cached 'fused' under a debug build's key is probed anew, since
    the fused kernels keep no traces; fp32, where fused builds."""
    sys, param, st = fixture
    kw = {k: v for k, v in AUTO.items()
          if k not in ("formulation", "method", "backend", "device")}
    o = tsp.default_options("laxMPC", "ADMM", **kw)
    o.precision = "float"
    o.debug = 1
    key = api.auto_cache_key(sys, param, o, "cpu", (64, 5, 1))
    api._auto_cache_store(key, "fused")
    assert api._auto_cache_load() == {key: "fused"}
    s = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=o, backend="auto", device="cpu")
    assert not s.backend_probe_cached
    assert s.backend_choice in ("dense", "banded")
    assert "fused" not in s.backend_probe_s
    assert "hRp" in s(st["x"], st["xr"], st["ur"]).sol


def test_auto_refuses_ingredients(fixture, cache_dir):
    """Under 'auto' each backend would read its own ingredient layout:
    ingredients= is refused, naming the reason."""
    sys, param, _ = fixture
    ing = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          rho=15.0, device="cpu").ingredients
    with pytest.raises(ValueError, match="ingredients"):
        tsp.make_solver(sys, param, ingredients=ing, **AUTO)


def test_aot_memory_analysis_none_on_cpu(fixture):
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        rho=15.0, device="cpu")
    assert s.aot_memory_analysis(st["x"], st["xr"], st["ur"]) is None


def _hmpc_fused(which):
    """An fp32 fused HMPC solver on the CPU (its kernel's plain version)."""
    sys, param, st = tsp.systems.tester_fixture()
    sys, param = _params_for("HMPC", sys, param, st)
    method, sub = {"single": ("ADMM", ""), "split": ("ADMM", "split")}[which]
    o = tsp.default_options("HMPC", method, sub, rho=5.0, sigma=5.0,
                            tol_p=1e-4, tol_d=1e-4, k_max=4000)
    o.precision = "float"
    return tsp.make_solver(sys, param, formulation="HMPC", method=method,
                           submethod=sub, options=o, backend="fused",
                           device="cpu"), st


@pytest.mark.parametrize("which", ["single", "split"])
def test_fused_probe_runs_exactly_its_iterations(which):
    """K6 and K7 take no fixed_iters; the auto probe runs their kernels
    through fused_backend.for_iterations, every lane for exactly the
    probe's iterations, and the public call still refuses fixed_iters."""
    s, st = _hmpc_fused(which)
    assert not s.raw_fn.takes_fixed_iters
    with pytest.raises(ValueError, match="fixed_iters"):
        s(st["x"], st["xr"], st["ur"], fixed_iters=5)
    x = tuple(np.tile(st[key], (3, 1)) for key in ("x", "xr", "ur"))
    s.raw_fn = fused_backend.for_iterations(s.raw_fn, 7)
    res = s(*x)
    assert np.all(res.k.numpy() == 7) and np.all(res.e_flag.numpy() == -1)


@pytest.mark.parametrize("triple", sorted(SOLVER_REGISTRY))
def test_auto_every_triple_fp32(triple, cache_dir):
    """backend='auto' in fp32 on every triple: each candidate its builder
    takes is probed (the fused ones on their kernels' plain versions, K3,
    K5, K6 and K7 through for_iterations) and the choice solves; a triple
    whose every backend refuses the model (laxMPC-FISTA with this
    non-diagonal T) raises ValueError, as the JAX package's auto does."""
    sys0, param0, st = tsp.systems.tester_fixture()
    sys, param = _params_for(triple[0], sys0, param0, st)
    o = tsp.default_options(*triple, k_max=200, auto_probe_batch=32,
                            auto_probe_iters=3, auto_probe_reps=1)
    o.precision = "float"
    kw = dict(formulation=triple[0], method=triple[1], submethod=triple[2],
              options=o, backend="auto", device="cpu")
    if triple == ("laxMPC", "FISTA", ""):
        with pytest.raises(ValueError, match="no backend"):
            tsp.make_solver(sys, param, **kw)
        return
    s = tsp.make_solver(sys, param, **kw)
    assert s.backend_choice in s.backend_probe_s
    # every triple but semiband has a fused backend
    assert ("fused" in s.backend_probe_s) == (triple[2] != "semiband")
    assert np.all(np.isfinite(s(*_inputs_for(s, st)).u.numpy()))


def test_debug_history_traces(fixture):
    """tests/test_api_misc.py:125-158: options.debug records the residual
    histories, laxMPC-ADMM and MPCT-EADMM, as the JAX package's do."""
    sys, param, st = fixture
    x = (st["x"], st["xr"], st["ur"])
    for pkg in (tsp, jsp):
        where = dict(device="cpu") if pkg is tsp else {}
        opt = pkg.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-5,
                                  k_max=2000)
        opt.debug = True
        res = pkg.make_solver(sys, param, formulation="laxMPC",
                              method="ADMM", options=opt, **where)(*x)
        k = int(res.k[0])
        hRp = np.asarray(res.sol["hRp"][0])
        hRd = np.asarray(res.sol["hRd"][0])
        assert hRp.shape == (2000,)
        assert hRp[k - 1] <= 1e-5 and hRd[k - 1] <= 1e-5
        assert hRd[0] > 1e-5
        np.testing.assert_allclose(hRp[k - 1], float(res.sol["r_p"][0]))
        if pkg is tsp:
            ours = (k, hRp[:k], hRd[:k])
        else:
            assert k == ours[0]
            np.testing.assert_allclose(ours[1], hRp[:k], rtol=0, atol=1e-9)
            np.testing.assert_allclose(ours[2], hRd[:k], rtol=0, atol=1e-9)
        p2 = dict(param, T=10 * np.asarray(param["Q"]),
                  S=np.asarray(param["R"]))
        opt2 = pkg.default_options("MPCT", "EADMM", rho_base=2.0,
                                   rho_mult=20.0, tol=1e-5, k_max=2000)
        opt2.debug = True
        r2 = pkg.make_solver(sys, p2, formulation="MPCT", method="EADMM",
                             options=opt2, **where)(*x)
        k2 = int(r2.k[0])
        for key in ("hRpf", "hRz2", "hRz3"):
            assert np.asarray(r2.sol[key][0])[k2 - 1] <= 1e-5


def _knob_run(pkg, triple, sys, param, st, knob):
    """Build and solve with one knob at its probe value (k_max 60): the
    result's u, or the exception raised."""
    formulation, method, submethod = triple
    where = dict(device="cpu") if pkg is tsp else {}
    try:
        s = pkg.make_solver(sys, param, formulation=formulation,
                            method=method, submethod=submethod,
                            **{knob: PROBES[knob], "k_max": 60}, **where)
        return np.asarray(s(*_inputs_for(s, st)).u)
    except (ValueError, NotImplementedError) as exc:
        assert str(exc), f"{triple} knob {knob}: empty error message"
        return exc


@pytest.mark.parametrize("triple", sorted(SOLVER_REGISTRY))
def test_every_advertised_knob_matches_jax(triple):
    """tests/test_option_registry.py:99-120 over the 13 triples, held to
    the JAX package: each knob at its probe value builds and solves in
    both packages with u within 1e-9 (fp64), or raises the same exception
    type in both; a knob documented to raise raises."""
    sys0, param0, st = tsp.systems.tester_fixture()
    sys, param = _params_for(triple[0], sys0, param0, st)
    for knob in SOLVER_REGISTRY[triple]:
        ours = _knob_run(tsp, triple, sys, param, st, knob)
        theirs = _knob_run(jsp, triple, sys, param, st, knob)
        if isinstance(theirs, Exception):
            assert type(ours) is type(theirs), (triple, knob, ours, theirs)
            continue
        assert not isinstance(ours, Exception), (triple, knob, ours)
        assert knob not in EXPECT_RAISE, (triple, knob)
        assert np.all(np.isfinite(ours)), (triple, knob)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-9,
                                   err_msg=f"{triple} {knob}")


def test_sparse_true_raises(fixture):
    """tests/test_option_registry.py:122-130."""
    sys0, param0, st = fixture
    sys, param = _params_for("HMPC", sys0, param0, st)
    with pytest.raises(ValueError, match="sparse"):
        tsp.make_solver(sys, param, formulation="HMPC", method="ADMM",
                        sparse=True, device="cpu")


def test_force_diagonal_consumed(fixture):
    """tests/test_option_registry.py:133-151: MPCT-EADMM's diagonal
    offline H3 gives the same solve on diagonal Q and R."""
    sys0, param0, st = fixture
    sys, param = _params_for("MPCT", sys0, param0, st)
    opt = tsp.default_options("MPCT", "EADMM", tol=1e-5, k_max=2000)
    opt.force_diagonal = True
    r1, r2 = (tsp.make_solver(sys, param, formulation="MPCT",
                              method="EADMM", device="cpu", **kw)(
        st["x"], st["xr"], st["ur"])
        for kw in (dict(options=opt), dict(tol=1e-5, k_max=2000)))
    assert int(r1.k[0]) == int(r2.k[0])
    np.testing.assert_allclose(r1.u.numpy(), r2.u.numpy(), atol=1e-12)


def test_timing_phase_times(fixture):
    """tests/test_option_registry.py:154-176."""
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        rho=15.0, tol=1e-4, k_max=500, device="cpu")
    assert s.options.timing
    times = s(st["x"], st["xr"], st["ur"]).sol["times_ms"]
    assert set(times) == {"update", "solve", "polish", "run"}
    assert all(t >= 0.0 for t in times.values())
    assert times["run"] >= times["solve"]
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=500)
    opt.timing = False
    res = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          options=opt, device="cpu")(st["x"], st["xr"],
                                                     st["ur"])
    assert "times_ms" not in res.sol


def test_debug_is_int_level():
    """tests/test_option_registry.py:179-188."""
    opt = tsp.default_options("laxMPC", "ADMM")
    assert opt.debug == 0 and isinstance(opt.debug, int)
    opt2 = tsp.Options(formulation="laxMPC", method="ADMM", debug=True)
    assert opt2.debug == 1 and isinstance(opt2.debug, int)
    assert tsp.Options(formulation="laxMPC", method="ADMM",
                       debug=2).debug == 2


def test_verbose_gates_personal_default_warning():
    """tests/test_option_registry.py:191-205."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tsp.Options(formulation="personal", method="X", verbose=1,
                    solver=dict(rho=1.0))
    assert any("personal" in str(w.message) for w in rec)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tsp.Options(formulation="personal", method="X", verbose=0,
                    solver=dict(rho=1.0))
    assert not rec


def test_inf_value_consumed(fixture):
    """tests/test_option_registry.py:208-222."""
    sys, param, _ = fixture
    sys2 = {k: v for k, v in sys.items() if k not in ("LBx", "UBx")}
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=100)
    opt.inf_value = 12345.0
    s = tsp.make_solver(sys2, param, formulation="laxMPC", method="ADMM",
                        options=opt, device="cpu")
    assert np.asarray(s.ingredients["LB_z"]).min() == -12345.0
    assert np.asarray(s.ingredients["UB_z"]).max() == 12345.0


@pytest.mark.parametrize("backend", ["dense", "banded"])
def test_debug_traces_per_backend(fixture, backend):
    """tests/test_option_registry.py:243-265: debug traces on the dense
    and banded loops, held to the JAX package's traces; the fused backend
    refuses debug."""
    sys, param, st = fixture
    x = (st["x"], st["xr"], st["ur"])
    runs = []
    for pkg in (tsp, jsp):
        opt = pkg.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                                  k_max=200)
        opt.debug = 1
        where = dict(device="cpu") if pkg is tsp else {}
        runs.append(pkg.make_solver(sys, param, formulation="laxMPC",
                                    method="ADMM", options=opt,
                                    backend=backend, **where)(*x))
    ours, theirs = runs
    for key in ("hRp", "hRd"):
        np.testing.assert_allclose(ours.sol[key].numpy(),
                                   np.asarray(theirs.sol[key]), rtol=0,
                                   atol=1e-9)
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=200)
    opt.precision = "float"
    opt.debug = 1
    with pytest.raises(ValueError, match="debug traces"):
        tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=opt, backend="fused", device="cpu")


# ---------------------------------------------------------------------------
# the builder contract (ROADMAP queue 3, F1) and the replica's snapshot of
# the recipe (F2)
# ---------------------------------------------------------------------------

def test_make_solver_autodetects():
    """Port of tests/test_api_misc.py::test_make_solver_autodetects: the
    formulation is found from param's fields (laxMPC on the tester
    fixture), and the solve converges."""
    sys, param, st = tsp.systems.tester_fixture()
    s = tsp.make_solver(sys, param, rho=15.0, tol=1e-4, k_max=1000,
                        device="cpu")
    assert s.options.formulation == "laxMPC"
    res = s(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1


def test_personal_formulation_hatch():
    """Port of tests/test_api_misc.py::test_personal_formulation_hatch:
    a builder of the JAX package's plugin signature, build(sys, param,
    opt, backend="dense"), returning a BatchedSolver made with no device
    and a numpy dtype, builds and solves through make_solver on the
    device make_solver resolved."""
    from spcies_tpu_torch.formulations import register_builder, BUILDERS
    from spcies_tpu_torch.api import BatchedSolver
    from spcies_tpu_torch.solvers.common import SolveResult

    key = ("personal", "gradientDescent", "")
    if key in BUILDERS:
        del BUILDERS[key]

    @register_builder("personal", "gradientDescent")
    def build(sys, param, opt, backend="dense"):
        n = np.asarray(sys["A"]).shape[0]

        def _solve(x0, xr, ur, init, fixed_iters):
            u = -0.5 * x0[:, :2]
            B = x0.shape[0]
            return SolveResult(u=u, k=torch.ones(B, dtype=torch.int32),
                               e_flag=torch.ones(B, dtype=torch.int32),
                               sol={})
        return BatchedSolver(_solve, {}, opt, n=n, m=2, N=1, nz=n,
                             dtype=np.float64)

    try:
        sys, param, st = tsp.systems.tester_fixture()
        s = tsp.make_solver(sys, param, formulation="personal",
                            method="gradientDescent", device="cpu")
        assert s.device == torch.device("cpu")
        assert s.dtype == torch.float64
        res = s(st["x"], st["xr"], st["ur"])
        assert torch.is_tensor(res.u) and res.u.dtype == torch.float64
        np.testing.assert_allclose(res.u[0].numpy(),
                                   -0.5 * np.asarray(st["x"][:2]))
        # a replica rebuilds through the same signature
        r = api._rebuild(s, "cpu")
        assert r.device == torch.device("cpu")
        assert torch.equal(r(st["x"], st["xr"], st["ur"]).u, res.u)
        with pytest.raises(TypeError, match="ingredients"):
            tsp.make_solver(sys, param, formulation="personal",
                            method="gradientDescent", device="cpu",
                            ingredients={})
    finally:
        del BUILDERS[key]


def test_builder_taking_device_gets_the_resolved_one(fixture):
    """A builder whose signature takes device= and ingredients= (the
    port's own) receives the device make_solver resolved, and the
    ingredients given; a BatchedSolver made with torch.float64 keeps
    it."""
    from spcies_tpu_torch.api import BatchedSolver
    from spcies_tpu_torch.solvers.common import SolveResult
    seen = []

    def build(sys, param, opt, backend="dense", device="cuda",
              ingredients=None):
        seen.append((device, ingredients))

        def _solve(x0, xr, ur, init, fixed_iters):
            B = x0.shape[0]
            return SolveResult(u=x0[:, :2], k=torch.ones(B, dtype=torch.int32),
                               e_flag=torch.ones(B, dtype=torch.int32),
                               sol={})
        return BatchedSolver(_solve, ingredients or {}, opt, n=6, m=2, N=1,
                             nz=6, dtype=torch.float64, device=device)

    key = ("personal", "withDevice", "")
    fbase.BUILDERS[key] = build
    try:
        sys, param, st = fixture
        s = tsp.make_solver(sys, param, formulation="personal",
                            method="withDevice", device="cpu",
                            ingredients={"a": 1})
        assert seen == [(torch.device("cpu"), {"a": 1})]
        assert s.device == torch.device("cpu") and s.dtype == torch.float64
        assert s.ingredients == {"a": 1}
    finally:
        del fbase.BUILDERS[key]


def test_batched_solver_without_device_takes_the_card(monkeypatch):
    """A BatchedSolver built directly with no device resolves it as every
    entry point does: the card, and RuntimeError without one (no quiet
    CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = tsp.default_options("laxMPC", "ADMM")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        api.BatchedSolver(lambda *a: None, {}, opt, n=6, m=2, N=1, nz=6,
                          dtype=torch.float64)
    s = api.BatchedSolver(lambda *a: None, {}, opt, n=6, m=2, N=1, nz=6,
                          dtype="float32", device="cpu")
    assert s.device == torch.device("cpu") and s.dtype == torch.float32


def _edit_after_build():
    """The reproduction of ROADMAP queue 3's F2 (fp64, CPU, tester
    fixture): solver A with tol 1e-4 and k_max 1000; then the caller
    edits the options to build solver B and changes param["Q"] in place.
    Returns A, A's result before the edits and the inputs."""
    sys, param, st = tsp.systems.tester_fixture()
    sys, param = dict(sys), dict(param, Q=np.array(param["Q"], float))
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=1000)
    a = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=opt, device="cpu")
    x = (st["x"], st["xr"], st["ur"])
    before = a(*x)
    assert int(before.k[0]) == 407
    opt.solver["k_max"] = 20
    opt.solver["tol"] = 1e-2
    b = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=opt, device="cpu")
    assert int(b(*x).k[0]) < 407
    param["Q"] *= 3.0
    sys["A"] = sys["A"] * 1.1
    return a, before, x


def _assert_bits(a, b):
    """u, k, e_flag and every iterate of sol bit for bit (times_ms, a
    clock reading, aside)."""
    for name in ("u", "k", "e_flag"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    keys = sorted(k for k in b.sol if torch.is_tensor(b.sol[k]))
    assert keys and keys == sorted(k for k in a.sol
                                   if torch.is_tensor(a.sol[k]))
    for key in keys:
        assert torch.equal(a.sol[key], b.sol[key]), key


def test_replica_keeps_the_options_it_was_built_with():
    """api._rebuild(A) after the caller's edits gives A's u, k, e_flag
    and sol bit for bit: the recipe holds copies of sys, param and the
    resolved options taken when A was built."""
    a, before, x = _edit_after_build()
    _assert_bits(a(*x), before)
    _assert_bits(api._rebuild(a, "cpu")(*x), before)
    assert a._recipe[3].solver["k_max"] == 1000
    assert a._recipe[3].solver is not a.options.solver


def test_sharded_replicas_keep_the_options(monkeypatch):
    """The same through parallel.sharded_solver over two logical CPU
    devices, each shard through a replica rebuilt from the recipe (as on
    cards of their own): every lane gives A's bits."""
    from spcies_tpu_torch.parallel import mesh as pmesh
    a, _, x = _edit_after_build()
    rebuilt = []

    def rebuild(solver, device):
        rebuilt.append(device)
        return api._rebuild(solver, device)

    monkeypatch.setattr(pmesh, "_replica", rebuild)
    rng = np.random.default_rng(3)
    lanes = (np.asarray(x[0])[None] * rng.uniform(-2, 2, (8, 1)),
             np.tile(x[1], (8, 1)), np.tile(x[2], (8, 1)))
    solve = tsp.parallel.sharded_solver(
        a, tsp.parallel.batch_mesh(["cpu", "cpu"]))
    assert rebuilt
    res = solve(*lanes)
    for half in (slice(0, 4), slice(4, 8)):
        want = a(*(l[half] for l in lanes))
        _assert_bits(type(res)(u=res.u[half], k=res.k[half],
                               e_flag=res.e_flag[half],
                               sol={k: v[half] for k, v in res.sol.items()
                                    if torch.is_tensor(v)}),
                     want)
    assert int(res.k.max()) > 20
