"""ellipMPC in the PyTorch port: ports of the dense cases of
tests/test_ellipmpc.py (golden optimum, numpy oracle, vector rho, the
nonconstant-terminal raise, terminal in the ellipsoid, the soc golden,
oracle and runtime radius, batched masking), the JAX dense engines' k and
iterates in fp64 (a non-identity P and a per-lane radius included), debug
traces, ingredients carried across from the JAX package, the soc solver's
optional 4th input, the fused backends against the dense engines, and
error probes. The banded cases of tests/test_ellipmpc.py are in
tests/test_torch_banded.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import ellipmpc_admm_oracle, ellipmpc_admm_soc_oracle
from tests.golden.ellipmpc_golden import Z_OPT

import spcies_tpu_torch as tsp
from spcies_tpu_torch.convert import ingredients_from_jax
from spcies_tpu_torch.kernels import fused_ellip as k4
from spcies_tpu_torch.kernels import fused_soc as k5

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


ADMM_OPTS = dict(rho=15.0, tol=1e-7, k_max=5000)
SOC_OPTS = dict(rho=15.0, sigma=10.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)
ADMM = dict(formulation="ellipMPC", method="ADMM")
SOC = dict(formulation="ellipMPC", method="ADMM", submethod="soc")


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    # test_ellipMPC_ADMM.m:15-20
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    param["P"] = np.eye(len(status["xr"]))
    param["c"] = status["xr"]
    param["r"] = 0.0
    return sys, param, status


@pytest.fixture(scope="module")
def admm_solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, **ADMM, **ADMM_OPTS, device="cpu")


@pytest.fixture(scope="module")
def soc_solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, **SOC, **SOC_OPTS, device="cpu")


def _batch(st, B, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-scale, scale, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _ellipsoid(param, st, seed=3):
    """A random SPD P and a centre c != xr drawn from `seed`, radius 0.4,
    which binds the terminal state of every lane of _batch's inputs
    (P = I makes the P_half coordinates trivial)."""
    rng = np.random.default_rng(seed)
    n = len(st["xr"])
    L = rng.normal(0.0, 0.3, (n, n))
    return dict(param, P=L @ L.T + 0.5 * np.eye(n),
                c=np.asarray(st["xr"]) + rng.normal(0.0, 0.1, n), r=0.4)


def test_admm_vs_golden(admm_solver, fixture):
    _, _, st = fixture
    res = admm_solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_admm_vs_oracle(admm_solver, fixture):
    sys, param, st = fixture
    res = admm_solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = ellipmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **ADMM_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_admm_vector_rho_vs_oracle(fixture):
    """Vector rho (compute_ellipMPC_ADMM_ingredients.m:68-77): varying
    stage entries, constant over the terminal block; force_vector_rho on a
    scalar agrees with the scalar build."""
    sys, param, st = fixture
    n = len(st["xr"])
    nz = param["N"] * (n + sys["B"].shape[1])
    rng = np.random.default_rng(7)
    rho_vec = 15.0 * (1.0 + 0.5 * rng.random(nz))
    rho_vec[nz - n:] = 20.0
    opts = dict(ADMM_OPTS, rho=rho_vec)
    solver = tsp.make_solver(sys, param, **ADMM, **opts, device="cpu")
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = ellipmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **opts)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    s_vec = tsp.make_solver(sys, param, **ADMM, force_vector_rho=True,
                            **ADMM_OPTS, device="cpu")
    s_sc = tsp.make_solver(sys, param, **ADMM, **ADMM_OPTS, device="cpu")
    rv = s_vec(st["x"], st["xr"], st["ur"])
    rs = s_sc(st["x"], st["xr"], st["ur"])
    assert int(rv.k[0]) == int(rs.k[0])
    assert float((rv.sol["z"] - rs.sol["z"]).abs().max()) < 1e-12


def test_admm_vector_rho_nonconstant_terminal_raises(fixture):
    sys, param, st = fixture
    n = len(st["xr"])
    nz = param["N"] * (n + sys["B"].shape[1])
    rho_vec = np.full(nz, 15.0)
    rho_vec[-1] = 30.0
    with pytest.raises(ValueError, match="terminal"):
        tsp.make_solver(sys, param, **ADMM, rho=rho_vec, tol=1e-7,
                        k_max=100, device="cpu")


def test_admm_terminal_in_ellipsoid(fixture):
    """With r > 0 the terminal v satisfies (v_N - c)' P (v_N - c) <= r^2."""
    sys, param, st = fixture
    param = dict(param, r=0.05)
    s = tsp.make_solver(sys, param, **ADMM, **ADMM_OPTS, device="cpu")
    v = s(st["x"], st["xr"], st["ur"]).sol["v"][0].numpy()
    d = v[-s.n:] - param["c"]
    assert d @ (param["P"] @ d) <= param["r"] ** 2 + 1e-8


def test_soc_vs_golden(soc_solver, fixture):
    _, _, st = fixture
    res = soc_solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    z = res.sol["z"][0].numpy()
    assert np.max(np.abs(z[:len(Z_OPT)] - Z_OPT)) <= 1e-4


def test_soc_vs_oracle(soc_solver, fixture):
    sys, param, st = fixture
    res = soc_solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = ellipmpc_admm_soc_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **SOC_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "s", "lam", "mu"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_soc_runtime_radius(soc_solver, fixture):
    """The radius is the 4th input (code_ellipMPC_ADMM_soc_C.c:20); each
    radius matches the oracle at that radius."""
    sys, param, st = fixture
    for r in (0.0, 0.3):
        res = soc_solver(st["x"], st["xr"], st["ur"], np.array([r]))
        u_o, k_o, _, _ = ellipmpc_admm_soc_oracle(
            sys, param, st["x"], st["xr"], st["ur"], r, **SOC_OPTS)
        assert int(res.k[0]) == k_o
        assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


@pytest.mark.parametrize("which", ["admm", "soc"])
def test_batched_masking(admm_solver, soc_solver, fixture, which):
    """A batch gives each lane the k and iterates of solving it alone."""
    _, _, st = fixture
    solver = admm_solver if which == "admm" else soc_solver
    x0s, xr, ur = _batch(st, 4, 4)
    batched = solver(x0s, xr, ur)
    for i in range(4):
        solo = solver(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)


KEYS = {"admm": ("z", "v", "lam", "r_p", "r_d"),
        "soc": ("z", "s", "z_hat", "s_hat", "lam", "mu", "r_p", "r_d")}


def _parity(rj, rt, keys):
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    for key in keys:
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)


@pytest.mark.parametrize("which,ellipsoid", [("admm", False),
                                             ("admm", True),
                                             ("soc", False),
                                             ("soc", True)])
def test_dense_fp64_parity(fixture, which, ellipsoid):
    """The JAX dense engines' per-lane k and e_flag, iterates within 1e-9,
    warm start included; with a random SPD P and c != xr as well as P = I.
    The soc solver takes a per-lane radius, small enough to bind."""
    sys, param, st = fixture
    if ellipsoid:
        param = _ellipsoid(param, st)
    triple, opts = (ADMM, ADMM_OPTS) if which == "admm" else (SOC, SOC_OPTS)
    s_j, s_t = (pkg.make_solver(sys, param, **triple, **opts,
                                **_on_cpu(pkg)) for pkg in (jsp, tsp))
    x = _batch(st, 8, 2)
    if which == "soc":
        x = x + (np.random.default_rng(2).uniform(0.01, 0.1, (8, 1)),)
    rt, rj = s_t(*x), s_j(*x)
    _parity(rj, rt, KEYS[which])
    loose = tsp.make_solver(sys, param, **triple, **dict(opts, k_max=60),
                            device="cpu")(*x)
    keys = ("z", "v", "lam") if which == "admm" else ("z", "s", "lam", "mu")
    init = tuple(loose.sol[key] for key in keys)
    warm_t = s_t(*x, init=init)
    assert np.all(warm_t.k.numpy() < rt.k.numpy())
    _parity(s_j(*x, init=tuple(a.numpy() for a in init)), warm_t,
            KEYS[which])


@pytest.mark.parametrize("which,debug", [("admm", 1), ("admm", 2),
                                         ("soc", 1), ("soc", 2)])
def test_debug_traces_and_fixed_iters(fixture, which, debug):
    """genHist traces as the JAX dense engines record them, and
    fixed_iters."""
    sys, param, st = fixture
    triple, opts = (ADMM, ADMM_OPTS) if which == "admm" else (SOC, SOC_OPTS)
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("ellipMPC", "ADMM", triple.get("submethod",
                                                               ""),
                                **dict(opts, k_max=300))
        o.debug = debug
        out.append(pkg.make_solver(sys, param, **triple, options=o,
                                   **_on_cpu(pkg))(*_batch(st, 3, 3)))
    rj, rt = out
    for key in ("hRp", "hRd"):
        assert tuple(rt.sol[key].shape) == (3, 300)
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
    s = tsp.make_solver(sys, param, **triple, **opts, device="cpu")
    r = s(*_batch(st, 3, 3), fixed_iters=7)
    assert np.all(r.k.numpy() == 7) and np.all(r.e_flag.numpy() == 1)
    np.testing.assert_allclose(r.sol["r_p"].numpy(),
                               rt.sol["hRp"][:, 6].numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("which", ["admm", "soc"])
def test_ingredients_from_jax(fixture, which):
    """convert.ingredients_from_jax carries a JAX solver's ingredients to
    the port's builder: the same keys and values as the port's own, and the
    same solve."""
    sys, param, st = fixture
    param = _ellipsoid(param, st)
    triple, opts = (ADMM, ADMM_OPTS) if which == "admm" else (SOC, SOC_OPTS)
    s_j = jsp.make_solver(sys, param, **triple, **opts)
    ing = ingredients_from_jax(s_j.ingredients, **triple)
    mod = tsp.formulations.ellipmpc
    o = tsp.default_options("ellipMPC", "ADMM", triple.get("submethod", ""),
                            **opts)
    own = (mod.ellipmpc_admm_ingredients if which == "admm"
           else mod.ellipmpc_admm_soc_ingredients)(sys, param, o)
    assert set(ing) == set(own)
    for key, val in own.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_allclose(ing[key], val, rtol=0, atol=1e-12,
                                       err_msg=key)
        else:
            assert ing[key] == val, key
    x = _batch(st, 4, 5)
    r_own = tsp.make_solver(sys, param, **triple, **opts, device="cpu")(*x)
    r_jax = tsp.make_solver(sys, param, **triple, **opts, ingredients=ing,
                            device="cpu")(*x)
    assert torch.equal(r_own.k, r_jax.k)
    assert float((r_own.u - r_jax.u).abs().max()) < 1e-12
    with pytest.raises(KeyError, match="M_q" if which == "admm" else "M1"):
        ingredients_from_jax({k: v for k, v in s_j.ingredients.items()
                              if k not in ("M_q", "M1")}, **triple)


def test_soc_optional_radius_input(soc_solver, fixture):
    """r_ellip is an optional trailing input defaulting to param's r, with
    no unit kind: in_engineering scales x0, xr and ur and leaves it as it
    is, as the JAX package does."""
    sys, param, st = fixture
    assert soc_solver.input_names == ("x0", "xr", "ur", "r_ellip")
    assert soc_solver.input_kinds == ("x", "x", "u", None)
    x = _batch(st, 3, 6)
    a = soc_solver(*x)
    b = soc_solver(*x, np.full((3, 1), param["r"]))
    assert torch.equal(a.k, b.k) and torch.equal(a.u, b.u)
    with pytest.raises(TypeError, match="expects inputs"):
        soc_solver(*x, np.zeros((3, 1)), np.zeros((3, 1)))
    with pytest.raises(TypeError, match="expects inputs"):
        soc_solver(*x[:2])
    n, m = 6, 2
    sys_e = dict(sys, Nx=np.full(n, 1.5), Nu=np.full(m, 0.8),
                 x0=np.linspace(-0.1, 0.1, n), u0=np.array([0.05, -0.05]))
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("ellipMPC", "ADMM", "soc", **SOC_OPTS)
        o.in_engineering = True
        out.append(pkg.make_solver(sys_e, param, **SOC, options=o,
                                   **_on_cpu(pkg)))
    x0e = np.asarray(st["x"]) / sys_e["Nx"] + sys_e["x0"]
    xre = np.asarray(st["xr"]) / sys_e["Nx"] + sys_e["x0"]
    ure = np.asarray(st["ur"]) / sys_e["Nu"] + sys_e["u0"]
    rj = out[0](x0e, xre, ure, np.array([0.2]))
    rt = out[1](x0e, xre, ure, np.array([0.2]))
    assert int(rt.k[0]) == int(rj.k[0])
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# fused backends (on the CPU, the kernels' plain versions)
# ---------------------------------------------------------------------------

FUSED_OPTS = dict(rho=15.0, tol=1e-4, k_max=5000)
SOC_FUSED = dict(rho=15.0, sigma=1.0, tol_p=1e-5, tol_d=1e-5, k_max=5000)


def _pair(sys, param, triple, kw, **extra):
    """(fused, dense) port solvers at fp32; the dense one without the
    kernel's window options."""
    sub = triple.get("submethod", "")
    o = tsp.default_options("ellipMPC", "ADMM", sub, tile_b=8,
                            **{**kw, **extra})
    o.precision = "float"
    s_f = tsp.make_solver(sys, param, **triple, backend="fused", options=o,
                          device="cpu")
    od = tsp.default_options("ellipMPC", "ADMM", sub, **{
        **kw, **{k: v for k, v in extra.items()
                 if k not in ("check_every", "exact_k")}})
    od.precision = "float"
    s_d = tsp.make_solver(sys, param, **triple, backend="dense", options=od,
                          device="cpu")
    return s_f, s_d


def test_fused_matches_dense(fixture):
    """The transformed-coordinate fused solve tracks the fp32 dense engine:
    k within 1 and iterates within 5e-4 (the P_half coordinates sum in
    other orders), as tests/test_ellipmpc.py:194 holds the JAX kernel."""
    sys, param, st = fixture
    s_f, s_d = _pair(sys, param, ADMM, FUSED_OPTS)
    x = _batch(st, 8, 0)
    rf, rd = s_f(*x), s_d(*x)
    assert np.max(np.abs(rf.k.numpy() - rd.k.numpy())) <= 1
    assert torch.equal(rf.e_flag, rd.e_flag)
    for key in ("z", "v", "lam"):
        assert float((rf.sol[key] - rd.sol[key]).abs().max()) < 5e-4, key


def test_fused_vs_golden(fixture):
    """The fused fixed point is the fp64 golden optimum's, to 1e-2."""
    sys, param, st = fixture
    s_f, _ = _pair(sys, param, ADMM, FUSED_OPTS)
    res = s_f(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-2


def test_fused_warm_start_and_check_every(fixture):
    sys, param, st = fixture
    s_f, _ = _pair(sys, param, ADMM, FUSED_OPTS)
    cold = s_f(st["x"], st["xr"], st["ur"])
    warm = s_f(st["x"], st["xr"], st["ur"],
               init=(cold.sol["z"], cold.sol["v"], cold.sol["lam"]))
    assert int(warm.k[0]) < int(cold.k[0])
    s_c, _ = _pair(sys, param, ADMM, FUSED_OPTS, check_every=8)
    rc = s_c(st["x"], st["xr"], st["ur"])
    assert int(rc.e_flag[0]) == 1
    assert int(rc.k[0]) % 8 == 0 and int(rc.k[0]) <= int(cold.k[0]) + 8


def test_soc_fused_matches_dense(fixture):
    """The fused soc solve against the fp32 dense engine with the runtime
    radius: k within 1 and iterates within 1e-3 (the kernel's layout sums
    the delta products in another order than the dense engine's, which
    tests/test_ellipmpc.py:247 holds to equal k on the JAX package's
    own)."""
    sys, param, st = fixture
    s_f, s_d = _pair(sys, dict(param, r=0.5), SOC, SOC_FUSED)
    x = _batch(st, 8, 3, scale=1.5)
    for r_run in (None, np.full((8, 1), 0.3, np.float32)):
        args = x if r_run is None else x + (r_run,)
        rf, rd = s_f(*args), s_d(*args)
        assert np.max(np.abs(rf.k.numpy() - rd.k.numpy())) <= 1
        assert np.all(rf.e_flag.numpy() == 1)
        for key in ("z", "s", "lam", "mu"):
            gap = float((rf.sol[key] - rd.sol[key]).abs().max())
            assert gap < 1e-3, (key, gap)


def test_soc_fused_check_every_and_warm_start(fixture):
    sys, param, st = fixture
    s_f, s_d = _pair(sys, dict(param, r=0.5), SOC, SOC_FUSED, check_every=4)
    res_d = s_d(st["x"], st["xr"], st["ur"])
    res = s_f(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert abs(int(res.k[0]) - int(res_d.k[0])) <= 4
    rws = s_f(st["x"], st["xr"], st["ur"],
              init=tuple(res_d.sol[key] for key in ("z", "s", "lam", "mu")))
    assert int(rws.k[0]) <= 8


@pytest.mark.parametrize("which", ["admm", "soc"])
def test_fused_exact_k_bit_identical(fixture, which):
    """exact_k (window snapshots + replay) equals the checked mode bit for
    bit — k, e_flag, every iterate — including the k_max-capped path."""
    sys, param, st = fixture
    if which == "admm":
        triple, kw, cap = ADMM, FUSED_OPTS, dict(tol=1e-13, k_max=19)
        x = _batch(st, 8, 5)
    else:
        triple = SOC
        kw = dict(rho=5.0, sigma=4.0, tol_p=1e-5, tol_d=1e-5, k_max=3000)
        cap = dict(tol_p=1e-13, tol_d=1e-13, k_max=19)
        x = _batch(st, 8, 21) + (np.full((8, 1), 0.5),)
    for extra in ({}, cap):
        r1 = _pair(sys, param, triple, kw, **extra)[0](*x)
        r2 = _pair(sys, param, triple, kw, check_every=8, exact_k=True,
                   **extra)[0](*x)
        assert torch.equal(r1.k, r2.k) and torch.equal(r1.e_flag, r2.e_flag)
        for key, val in r1.sol.items():
            if torch.is_tensor(val):
                assert torch.equal(val, r2.sol[key]), key


def test_fused_batch_padding_and_no_launch(fixture):
    """A batch that is not a multiple of tile_b is padded with zero lanes
    and the outputs are sliced back: the solve returns the kernel's plain
    version's results on the prepared inputs, lane for lane. On the CPU
    the fused solvers launch nothing."""
    sys, param, st = fixture
    s_a, _ = _pair(sys, param, ADMM, FUSED_OPTS, check_every=8, exact_k=True)
    s_s, _ = _pair(sys, param, SOC, SOC_FUSED, check_every=8, exact_k=True)
    before = (k4.fused_ellip_solve.launches, k5.fused_soc_solve.launches)
    for s, plain in ((s_a, k4.fused_ellip_reference),
                     (s_s, k5.fused_soc_reference)):
        x = _batch(st, 5, 1) + (() if s is s_a else (np.full((5, 1), 0.5),))
        x = tsp.api.broadcast_inputs(torch.float32, "cpu", *x)
        *kin, Bsz = s.raw_fn.prepare(*x)
        assert Bsz == 5 and all(t.shape[0] == 8 for t in kin)
        assert all(bool((t[5:] == 0).all()) for t in kin)
        r5 = s(*x)
        assert tuple(r5.u.shape) == (5, 2) and tuple(r5.k.shape) == (5,)
        out = plain(*kin, *s.raw_fn.operator, **s.raw_fn.kernel_kw)
        assert torch.equal(r5.k, out[3][:5])
        assert torch.equal(r5.e_flag, out[4][:5])
    assert (k4.fused_ellip_solve.launches,
            k5.fused_soc_solve.launches) == before


@pytest.mark.parametrize("which,probe,exc,match", [
    ("admm", dict(backend="banded", nondiag_q=True), ValueError,
     "diagonal"),
    ("soc", dict(backend="banded"), ValueError, "dense and fused"),
    ("admm", dict(backend="nope"), ValueError, "unknown backend"),
    ("admm", dict(backend="fused", precision="double"), ValueError, "fp32"),
    ("soc", dict(backend="fused", precision="double"), ValueError, "fp32"),
    ("admm", dict(backend="fused", force_vector_rho=True), ValueError,
     "scalar rho"),
    ("soc", dict(backend="fused", fixed_iters=5), ValueError, "fixed_iters"),
    ("admm", dict(backend="fused", debug=1), ValueError, "genHist"),
    ("soc", dict(nondiag_q=True), ValueError, "diagonal"),
])
def test_error_probes(fixture, which, probe, exc, match):
    sys, param, st = fixture
    probe = dict(probe)
    p = dict(param)
    if probe.pop("nondiag_q", False):
        p["Q"] = np.asarray(p["Q"]) + 0.1
    triple, kw = (ADMM, FUSED_OPTS) if which == "admm" else (SOC, SOC_FUSED)
    o = tsp.default_options("ellipMPC", "ADMM", triple.get("submethod", ""),
                            force_vector_rho=probe.pop("force_vector_rho",
                                                       False), **kw)
    o.precision = probe.pop("precision", "float")
    o.debug = probe.pop("debug", 0)
    fixed = probe.pop("fixed_iters", None)
    with pytest.raises(exc, match=match):
        s = tsp.make_solver(sys, p, **triple, options=o, device="cpu",
                            **probe)
        s(*_batch(st, 8, 0), fixed_iters=fixed)
