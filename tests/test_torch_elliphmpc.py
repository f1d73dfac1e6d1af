"""ellipHMPC in the PyTorch port: ports of tests/test_elliphmpc.py (the
numpy oracle, output constraints, the sigma-tightened D-set, the fused
backend against the dense engine), the JAX dense engine's k and iterates
in fp64 with per-lane sinusoidal references and warm starts, the seven
decomposed inputs, ingredients carried across from the JAX package, the
options copy, and error probes."""

import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import elliphmpc_admm_oracle

import spcies_tpu_torch as tsp
from spcies_tpu_torch.convert import ingredients_from_jax
from spcies_tpu_torch.formulations import hmpc as th

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
    """tests/test_elliphmpc.py:14-31: coupled outputs (the three mass
    positions) within +-0.3 and the HMPC harmonic weights."""
    sys, param, st = tsp.systems.tester_fixture()
    sys = dict(sys, E=np.eye(3, len(st["x"])), F=np.zeros((3, 2)),
               LBy=-0.3 * np.ones(3), UBy=0.3 * np.ones(3))
    param = dict(param)
    param.pop("T", None)
    param["w"] = 3 * 1.627 * 0.2
    param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
    param["Th"] = param["Te"]
    param["Se"] = np.asarray(param["R"]).copy()
    param["Sh"] = 0.5 * param["Se"]
    return sys, param, st


OPTS = dict(rho=2.0, sigma=0.01, tol_p=1e-7, tol_d=1e-7, k_max=5000)
# with _batch's binding references rho 2 stalls on most lanes; at rho 20
# they converge in 1600-1900 iterations, the others in 12
BATCH_OPTS = dict(OPTS, rho=20.0)
ELLIP = dict(formulation="ellipHMPC", method="ADMM")


def _refs(st):
    """Decomposed harmonic references: offset = (xr, ur), zero sine/cosine
    components."""
    xr, ur = st["xr"], st["ur"]
    zn, zm = np.zeros_like(xr), np.zeros_like(ur)
    return (st["x"], xr, zn, zn, ur, zm, zm)


def _batch(st, B, seed):
    """Per-lane x0 and sine amplitudes on the positions, large enough that
    the output bounds bind (bench.py:355-370's scenario)."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    xr, ur = np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))
    amp = np.zeros_like(xr)
    amp[:, :3] = rng.uniform(0.1, 0.4, (B, 1))
    zu = np.zeros_like(ur)
    return x0, xr, amp, 0.5 * amp, ur, 0.1 * np.ones_like(ur), zu


@pytest.mark.parametrize("use_soc", [False, True])
def test_vs_oracle(fixture, use_soc):
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, **ELLIP, use_soc=use_soc, **OPTS,
                        device="cpu")
    args = _refs(st)
    res = s(*args)
    u_o, k_o, e_o, sol_o = elliphmpc_admm_oracle(
        sys, param, *args, use_soc=use_soc, **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "s", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-8
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-8


def test_output_constraints_hold(fixture):
    """Stage outputs y_i = E x_i + F u_i respect LBy/UBy at the solution."""
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, **ELLIP, **OPTS, device="cpu")
    z = s(*_refs(st)).sol["z"][0].numpy()
    n, m, N = s.n, s.m, s.N
    E, F = np.asarray(sys["E"]), np.asarray(sys["F"])
    for l in range(1, N):
        x_l = z[m + (l - 1) * (n + m): m + (l - 1) * (n + m) + n]
        u_l = z[m + (l - 1) * (n + m) + n: m + l * (n + m)]
        y = E @ x_l + F @ u_l
        assert np.all(y <= sys["UBy"] + 1e-5)
        assert np.all(y >= sys["LBy"] - 1e-5)


def test_harmonic_amplitude_in_dset(fixture):
    """The harmonic output (ye, ys, yc) of each constrained output meets
    the sigma-tightened D-set: ||(ys, yc)|| <= min(ye - LBy, UBy - ye),
    with the bounds pulled in by sigma; binding references included."""
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, **ELLIP, **BATCH_OPTS, device="cpu")
    res = s(*_batch(st, 4, 2))
    assert bool((res.e_flag == 1).all())
    n, m, N = s.n, s.m, s.N
    ns = (N - 1) * (n + m) + m
    E, F = np.asarray(sys["E"]), np.asarray(sys["F"])
    sig, tol = OPTS["sigma"], 1e-5
    for z in res.sol["z"].numpy():
        xe, xs, xc = (z[ns:ns + n], z[ns + n:ns + 2 * n],
                      z[ns + 2 * n:ns + 3 * n])
        ue, us, uc = (z[ns + 3 * n:ns + 3 * n + m],
                      z[ns + 3 * n + m:ns + 3 * n + 2 * m],
                      z[ns + 3 * n + 2 * m:])
        for j in range(3):
            ye = E[j] @ xe + F[j] @ ue
            amp = np.hypot(E[j] @ xs + F[j] @ us, E[j] @ xc + F[j] @ uc)
            assert amp <= ye - (sys["LBy"][j] + sig) + tol
            assert amp <= (sys["UBy"][j] - sig) - ye + tol


@pytest.mark.parametrize("use_soc", [False, True])
def test_dense_fp64_parity(fixture, use_soc):
    """The JAX dense engine's per-lane k and e_flag, iterates within 1e-9,
    with per-lane references; and a warm start (with diamonds: the warm
    path does not depend on the cone)."""
    sys, param, st = fixture
    kw = dict(BATCH_OPTS, use_soc=use_soc)
    s_j, s_t = (pkg.make_solver(sys, param, **ELLIP, **kw, **_on_cpu(pkg))
                for pkg in (jsp, tsp))
    x = _batch(st, 8, 2)
    rt, rj = s_t(*x), s_j(*x)

    def parity(rj, rt):
        np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        for key in ("z", "s", "lam", "r_p", "r_d"):
            np.testing.assert_allclose(rt.sol[key].numpy(),
                                       np.asarray(rj.sol[key]), rtol=0,
                                       atol=1e-9, err_msg=key)

    parity(rj, rt)
    if use_soc:
        return
    loose = tsp.make_solver(sys, param, **ELLIP, **dict(kw, k_max=30),
                            device="cpu")(*x)
    init = tuple(loose.sol[key] for key in ("z", "s", "lam"))
    warm = s_t(*x, init=init)
    assert np.all(warm.k.numpy() < rt.k.numpy())
    parity(s_j(*x, init=tuple(a.numpy() for a in init)), warm)


def _fp32_options(kw, use_soc):
    """(backend, fp32 Options) for the fused and the dense solver."""
    for backend in ("fused", "dense"):
        o = tsp.default_options("ellipHMPC", "ADMM", tile_b=8,
                                use_soc=use_soc, **kw)
        o.precision = "float"
        yield backend, o


@pytest.mark.parametrize("use_soc", [False, True])
def test_fused_matches_dense(fixture, use_soc):
    """backend='fused' (on the CPU, K6's plain version) reproduces the
    fp32 dense engine's per-lane k, iterates within 1e-4, as
    tests/test_elliphmpc.py:107 holds the JAX kernel; with the binding
    references of _batch at tol 1e-5, whose lanes run about 1000
    iterations, k within one (the kernel's layout sums C's rows in another
    order than the dense engine)."""
    sys, param, st = fixture
    for kw, args, dk in ((OPTS, _refs(st), 0),
                         (dict(BATCH_OPTS, tol_p=1e-5, tol_d=1e-5),
                          _batch(st, 8, 2), 1)):
        rf, rd = (tsp.make_solver(sys, param, **ELLIP, options=o,
                                  backend=backend, device="cpu")(*args)
                  for backend, o in _fp32_options(kw, use_soc))
        assert np.max(np.abs(rf.k.numpy() - rd.k.numpy())) <= dk
        assert np.all(rf.e_flag.numpy() == 1)
        for key in ("z", "s", "lam"):
            gap = float((rf.sol[key] - rd.sol[key]).abs().max())
            # the dual scaled by its largest entry (O(10) at rho 20)
            scale = (max(1.0, float(rd.sol[key].abs().max()))
                     if key == "lam" else 1.0)
            assert gap < 1e-4 * scale, (key, gap)


def test_options_are_copied(fixture):
    """The JAX builder writes box_constraints=False into the caller's
    Options (spcies_tpu/formulations/hmpc.py:1068); the port copies the
    options first and writes it into the solver's copy, leaving the
    caller's as they were. The solve is the same."""
    sys, param, st = fixture
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("ellipHMPC", "ADMM", **OPTS)
        assert o.solver.get("box_constraints") is None
        s = pkg.make_solver(sys, param, **ELLIP, options=o, **_on_cpu(pkg))
        out.append((o, s))
    (o_j, s_j), (o_t, s_t) = out
    assert o_j.solver["box_constraints"] is False
    assert o_t.solver.get("box_constraints") is None
    assert s_t.options is not o_t
    assert s_t.options.solver["box_constraints"] is False
    assert dataclasses.replace(s_t.options, solver={}) == dataclasses.replace(
        o_t, solver={})
    assert {k: v for k, v in s_t.options.solver.items()
            if k != "box_constraints"} == {
        k: v for k, v in o_t.solver.items() if k != "box_constraints"}
    x = _refs(st)
    assert int(s_t(*x).k[0]) == int(s_j(*x).k[0])


def test_seven_inputs(fixture):
    """The solver takes the generated MEX's 7 inputs
    (struct_ellipHMPC_ADMM_C_Matlab.c:27); only x0 carries a unit kind,
    as in the JAX package."""
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, **ELLIP, **OPTS, device="cpu")
    assert s.input_names == th.ELLIP_INPUTS == (
        "x0", "xre", "xrs", "xrc", "ure", "urs", "urc")
    with pytest.raises(TypeError, match="expects inputs"):
        s(*_refs(st)[:3])


def test_engineering_units_scale_the_harmonic_references(fixture):
    """in_engineering: the offsets xre/ure take the operating point and
    the scaling, the sine and cosine amplitudes the scaling alone, as the
    JAX package does (its api.py input kinds 'xa' and 'ua'); the port gave
    them no kind, so they went unscaled."""
    sys, param, st = fixture
    n, m = 6, 2
    sys_e = dict(sys, Nx=np.linspace(0.5, 2.0, n), Nu=np.array([0.8, 1.3]),
                 x0=np.linspace(-0.1, 0.1, n), u0=np.array([0.05, -0.05]))
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("ellipHMPC", "ADMM", **BATCH_OPTS)
        o.in_engineering = True
        out.append(pkg.make_solver(sys_e, param, **ELLIP, options=o,
                                   **_on_cpu(pkg)))
    s_j, s_t = out
    assert s_t.input_kinds == s_j.input_kinds == (
        "x", "x", "xa", "xa", "u", "ua", "ua")
    x0, xr, xrs, xrc, ur, urs, urc = _batch(st, 4, 2)
    op_x, op_u = sys_e["x0"], sys_e["u0"]
    x = (x0 / sys_e["Nx"] + op_x, xr / sys_e["Nx"] + op_x, xrs / sys_e["Nx"],
         xrc / sys_e["Nx"], ur / sys_e["Nu"] + op_u, urs / sys_e["Nu"],
         urc / sys_e["Nu"])
    rj, rt = s_j(*x), s_t(*x)
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-9)
    # the same solve as the incremental inputs without engineering units
    r_inc = tsp.make_solver(sys, param, **ELLIP, **BATCH_OPTS,
                            device="cpu")(x0, xr, xrs, xrc, ur, urs, urc)
    assert torch.equal(rt.k, r_inc.k)
    np.testing.assert_allclose(rt.u.numpy(),
                               r_inc.u.numpy() / sys_e["Nu"] + op_u,
                               rtol=0, atol=1e-9)


def test_ingredients_from_jax(fixture):
    """convert.ingredients_from_jax carries the JAX solver's ingredients
    (output mode) to the port's builder: the same values, the same
    solve."""
    sys, param, st = fixture
    s_j = jsp.make_solver(sys, param, **ELLIP, **OPTS)
    ing = ingredients_from_jax(s_j.ingredients, "ellipHMPC", "ADMM")
    assert ing["box_constraints"] is False and ing["stage_LB"] is None
    o = tsp.default_options("ellipHMPC", "ADMM", **OPTS)
    o.solver["box_constraints"] = False
    own = th.hmpc_common_ingredients(sys, param, o, split=False)
    for key, val in own.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_allclose(ing[key], val, rtol=0, atol=1e-12,
                                       err_msg=key)
        else:
            assert ing[key] == val, key
    x = _batch(st, 4, 5)
    r_own = tsp.make_solver(sys, param, **ELLIP, **BATCH_OPTS,
                            device="cpu")(*x)
    r_jax = tsp.make_solver(sys, param, **ELLIP, **BATCH_OPTS,
                            ingredients=ing, device="cpu")(*x)
    assert bool((r_own.e_flag == 1).all())
    assert torch.equal(r_own.k, r_jax.k)
    assert float((r_own.u - r_jax.u).abs().max()) < 1e-12


@pytest.mark.parametrize("probe,exc,match", [
    (dict(backend="banded"), ValueError, "dense and fused"),
    (dict(no_outputs=True), ValueError, "coupled-output"),
    (dict(backend="fused", fixed_iters=5), ValueError, "fixed_iters"),
    (dict(backend="fused", precision="double"), ValueError, "fp32"),
])
def test_error_probes(fixture, probe, exc, match):
    sys, param, st = fixture
    probe = dict(probe)
    if probe.pop("no_outputs", False):
        sys = {k: v for k, v in sys.items() if k not in ("E", "F")}
    o = tsp.default_options("ellipHMPC", "ADMM", **OPTS)
    o.precision = probe.pop("precision", "float")
    fixed = probe.pop("fixed_iters", None)
    with pytest.raises(exc, match=match):
        s = tsp.make_solver(sys, param, **ELLIP, options=o, device="cpu",
                            **probe)
        s(*_refs(st), fixed_iters=fixed)
