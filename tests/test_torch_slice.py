"""The port's laxMPC-ADMM slice end to end through make_solver: dense and
fused backends against the JAX package, ingredients carried across,
engineering units, phase timing, the precision pin, error probes, and the
package's independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

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


def _on_cpu(pkg):
    """make_solver's device argument for `pkg`: the port's solvers run on
    the card unless asked for the CPU; the JAX package takes none."""
    return dict(device="cpu") if pkg is tsp else {}

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fixture():
    return tsp.systems.tester_fixture()


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _opts(pkg, precision, **kw):
    o = pkg.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                            k_max=1000, **kw)
    o.precision = precision
    return o


def test_ingredients_from_jax(fixture):
    sys, param, _ = fixture
    s_j = jsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          rho=15.0)
    ing = ingredients_from_jax(s_j.ingredients)
    own = tsp.formulations.laxmpc.laxmpc_admm_ingredients(
        sys, param, tsp.default_options("laxMPC", "ADMM", rho=15.0))
    assert set(ing) == set(own)
    for key, val in own.items():
        if isinstance(val, np.ndarray):
            assert ing[key].dtype == val.dtype, key
            np.testing.assert_allclose(ing[key], val, rtol=0, atol=1e-12)
        else:
            assert ing[key] == val and type(ing[key]) is type(val), key
    with pytest.raises(KeyError, match="M_q"):
        ingredients_from_jax({k: v for k, v in s_j.ingredients.items()
                              if k != "M_q"})


def test_dense_fp64_end_to_end(fixture):
    """make_solver(backend='dense') in fp64 against the JAX package: same
    per-lane k and e_flag, iterates within 1e-9, from the port's own
    ingredients and from the JAX solver's."""
    sys, param, st = fixture
    s_j = jsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          options=_opts(jsp, "double"))
    x = _batch(st, 16, 11)
    rj = s_j(*x)
    for ing in (None, ingredients_from_jax(s_j.ingredients)):
        s_t = tsp.make_solver(sys, param, formulation="laxMPC",
                              method="ADMM", options=_opts(tsp, "double"),
                              ingredients=ing, device="cpu")
        rt = s_t(*x)
        np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        for key in ("z", "v", "lam"):
            np.testing.assert_allclose(rt.sol[key].numpy(),
                                       np.asarray(rj.sol[key]), rtol=0,
                                       atol=1e-9)
        assert rt.u.dtype == torch.float64 and rt.k.dtype == torch.int32


def test_fused_end_to_end(fixture):
    """make_solver(backend='fused') in fp32 from the port's own ingredients
    and from the JAX solver's, against the JAX fused backend in interpret
    mode: the same e_flag, u within 1e-5, and k equal but where a lane
    ends at the tolerance boundary — there the products' different sum
    orders can move the exit by one iteration (one lane of these 24)."""
    sys, param, st = fixture
    kw = dict(tile_b=8, check_every=8, exact_k=True, sort_lanes=True)
    o_j = _opts(jsp, "float", pallas_interpret=True, **kw)
    s_j = jsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          options=o_j, backend="fused")
    x = _batch(st, 24, 12)
    rj = s_j(*x)
    results = []
    for ing in (None, ingredients_from_jax(s_j.ingredients)):
        s_t = tsp.make_solver(sys, param, formulation="laxMPC",
                              method="ADMM", options=_opts(tsp, "float", **kw),
                              backend="fused", ingredients=ing, device="cpu")
        assert s_t.stage_layout == ("stagewise", True)
        rt = s_t(*x)
        dk = np.abs(rt.k.numpy() - np.asarray(rj.k))
        assert dk.max() <= 1 and np.sum(dk) <= 1, dk
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                                   atol=1e-5)
        results.append(rt)
    # fp64 ingredients agree to 1e-12, so the fp32 solves are identical
    for key in ("z", "v", "lam"):
        assert torch.equal(results[0].sol[key], results[1].sol[key])


def test_single_problem_and_broadcast(fixture):
    sys, param, st = fixture
    s_t = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          options=_opts(tsp, "double"), device="cpu")
    one = s_t(st["x"], st["xr"], st["ur"])
    assert tuple(one.u.shape) == (1, 2)
    x0, _, _ = _batch(st, 3, 13)
    many = s_t(x0, st["xr"], st["ur"])          # [n] refs broadcast
    assert tuple(many.u.shape) == (3, 2)
    with pytest.raises(ValueError, match="inconsistent batch"):
        s_t(x0, np.tile(st["xr"], (2, 1)), st["ur"])
    with pytest.raises(ValueError, match="rank"):
        s_t(x0[None], st["xr"], st["ur"])
    with pytest.raises(TypeError, match="expects inputs"):
        s_t(x0, st["xr"])


def test_engineering_units(fixture):
    """in_engineering: inputs in engineering units are scaled to
    incremental units and u is scaled back, as the JAX package does."""
    sys, param, st = fixture
    n, m = 6, 2
    sys_e = dict(sys, Nx=np.full(n, 1.5), Nu=np.full(m, 0.8),
                 x0=np.linspace(-0.1, 0.1, n), u0=np.array([0.05, -0.05]))
    out = []
    for pkg in (jsp, tsp):
        o = _opts(pkg, "double")
        o.in_engineering = True
        out.append(pkg.make_solver(sys_e, param, formulation="laxMPC",
                                   method="ADMM", options=o, **_on_cpu(pkg)))
    x0e = np.asarray(st["x"]) / sys_e["Nx"] + sys_e["x0"]
    xre = np.asarray(st["xr"]) / sys_e["Nx"] + sys_e["x0"]
    ure = np.asarray(st["ur"]) / sys_e["Nu"] + sys_e["u0"]
    rj, rt = out[0](x0e, xre, ure), out[1](x0e, xre, ure)
    assert int(rt.k[0]) == int(rj.k[0])
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-9)
    # the incremental solve gives the same move, de-scaled
    s_inc = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                            options=_opts(tsp, "double"), device="cpu")
    r_inc = s_inc(st["x"], st["xr"], st["ur"])
    np.testing.assert_allclose(
        rt.u.numpy(), r_inc.u.numpy() / sys_e["Nu"] + sys_e["u0"], rtol=0,
        atol=1e-9)


def test_timing_and_precision_pin(fixture):
    sys, param, st = fixture
    s_t = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          options=_opts(tsp, "float"), device="cpu")
    seen = []
    raw = s_t.raw_fn

    def spy(*args):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return raw(*args)

    s_t.raw_fn = spy
    prec = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        res = s_t(st["x"], st["xr"], st["ur"])
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prec)
    assert seen == [("highest", False)]
    assert set(res.sol["times_ms"]) == {"update", "solve", "polish", "run"}
    o = _opts(tsp, "float")
    o.timing = False
    res = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          options=o, device="cpu")(st["x"], st["xr"], st["ur"])
    assert "times_ms" not in res.sol


def test_problem_recipe_builds_solver(fixture):
    sys, param, st = fixture
    prob = tsp.Problem(sys=sys, param=param, options=_opts(tsp, "double"))
    res = prob.copy().solver(device="cpu")(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1


@pytest.mark.parametrize("probe,exc,match", [
    (dict(formulation="nope", method="ADMM"), ValueError, "Unknown"),
    (dict(formulation="laxMPC", method="EADMM"), ValueError, "not available"),
    # a backend the triple lacks, and a personal triple that no builder is
    # registered for
    (dict(formulation="MPCT", method="ADMM", submethod="semiband",
          backend="fused"), ValueError, "dense and banded"),
    (dict(formulation="personal", method="mine"), NotImplementedError,
     "No solver builder"),
    # backend='auto' refuses ingredients (each backend reads its own
    # layout), and the time-varying inputs it cannot make probe inputs for
    (dict(backend="auto", ingredients={}), ValueError, "ingredients"),
    (dict(backend="auto", time_varying=True), ValueError, "probe inputs"),
    (dict(formulation="HMPC", method="ADMM", backend="nope"), ValueError,
     "unknown backend"),
    (dict(backend="nope"), ValueError, "unknown backend"),
    (dict(backend="fused"), ValueError, "fp32"),
    (dict(backend="fused", debug=1), ValueError, "genHist"),
    # the time-varying mode takes a scalar rho only
    (dict(time_varying=True, vector_rho=True), ValueError, "scalar rho"),
    (dict(nondiag_q=True), ValueError, "diagonal"),
])
def test_error_probes(fixture, probe, exc, match):
    sys, param, _ = fixture
    probe = dict(probe)
    p = dict(param)
    if probe.pop("nondiag_q", False):
        p["Q"] = np.asarray(p["Q"]) + 0.1
    o = tsp.default_options(
        "laxMPC", "ADMM", rho=15.0) if "formulation" not in probe else None
    if o is not None:
        o.debug = probe.pop("debug", 0)
        o.time_varying = probe.pop("time_varying", False)
        if probe.pop("vector_rho", False):
            o.solver["rho"] = np.full(30 * 8, 15.0)
    with pytest.raises(exc, match=match):
        if o is None:
            tsp.make_solver(sys, p, rho=15.0, **probe, device="cpu")
        else:
            tsp.make_solver(sys, p, formulation="laxMPC", method="ADMM",
                            options=o, **probe, device="cpu")


def test_default_device_is_the_card(fixture):
    """Left out, make_solver's and every builder's device is the CUDA card:
    without one they raise and name device="cpu", never solving on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    sys, param, _ = fixture
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=_opts(tsp, "double"))
    builders = [(key, fn) for key, fn in tsp.formulations.BUILDERS.items()]
    assert len(builders) == 13
    for (f, m, sub), build in builders:
        opt = tsp.default_options(f, m, sub)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(sys, param, opt)
    assert tsp.api.resolve_device("cpu") == torch.device("cpu")


def test_fused_rejects_vector_rho(fixture):
    sys, param, _ = fixture
    o = _opts(tsp, "float", force_vector_rho=True)
    with pytest.raises(ValueError, match="scalar rho"):
        tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=o, backend="fused", device="cpu")


def test_package_never_imports_jax():
    """Importing the port leaves jax and spcies_tpu out of sys.modules, and
    no source file of the port names them in an import."""
    code = ("import sys, spcies_tpu_torch, spcies_tpu_torch.convert; "
            "import spcies_tpu_torch.kernels._build; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'spcies_tpu' "
            "or m.startswith('spcies_tpu.')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in (REPO / "spcies_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "spcies_tpu"), (path,
                                                                    line)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    device."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
