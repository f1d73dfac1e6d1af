"""Engineering-units mode of the port, held against the JAX package: the
port of tests/test_engineering_units.py (the Duffing oscillator linearized
about an operating point and scaled by scale_ss, solved with
in_engineering=True: inputs in engineering units, u_opt returned in them;
code_laxMPC_ADMM_C.c:82-115 scaling, :642-651 de-scaling), every family,
the harmonic amplitudes, and the scale-out path: an engineering-units
solver through shard_map_solver and sharded_solver gives the unsharded
call's u in engineering units, where the JAX package's shard_map_solver
returns the raw solve's incremental u."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.systems import duffing_ode, duffing_to_ss, scale_ss
from spcies_tpu_torch.utils import linalg
from tests.test_codegen_c_ext import _float_setup

torch.set_num_threads(2)

DUFFING = dict(alpha=-1.0, beta=1.0, delta=0.3, gamma=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _on_cpu(pkg):
    return dict(device="cpu") if pkg is tsp else {}


@pytest.fixture(scope="module")
def fixture():
    x_op = np.array([0.0, 1.0])     # linearize about (v, p) = (0, 1)
    u_op = np.array([DUFFING["delta"] * 0.0 + DUFFING["alpha"] * 1.0
                     + DUFFING["beta"] * 1.0])  # steady input at x_op
    Ac, Bc = duffing_to_ss(x_op, u_op, **DUFFING)
    A, B = linalg.c2d_zoh(Ac, Bc, 0.1)
    Nx = np.array([2.0, 0.5])
    Nu = np.array([4.0])
    scaled = scale_ss(A, B, UBx=x_op + 0.5, LBx=x_op - 0.5,
                      UBu=u_op + 1.0, LBu=u_op - 1.0,
                      x0=x_op, u0=u_op, Nx=Nx, Nu=Nu)
    sys = dict(scaled)
    param = dict(Q=np.diag([1.0, 10.0]), R=np.eye(1),
                 T=np.diag([5.0, 50.0]), N=12)
    return sys, param, x_op, u_op, Nx, Nu


def _eng_solver(pkg, sys, param, **kw):
    opt = pkg.default_options("laxMPC", "ADMM", **kw)
    opt.in_engineering = True
    return pkg.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                           options=opt, **_on_cpu(pkg))


def test_engineering_matches_manual_incremental(fixture):
    sys, param, x_op, u_op, Nx, Nu = fixture
    x_eng = x_op + np.array([0.05, -0.1])
    xr_eng, ur_eng = x_op, u_op
    kw = dict(rho=1.0, tol=1e-7, k_max=5000)
    s_eng = _eng_solver(tsp, sys, param, **kw)
    s_inc = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                            device="cpu", **kw)
    res_eng = s_eng(x_eng, xr_eng, ur_eng)
    res_inc = s_inc(Nx * (x_eng - x_op), Nx * (xr_eng - x_op),
                    Nu * (ur_eng - u_op))
    assert int(res_eng.e_flag[0]) == int(res_inc.e_flag[0]) == 1
    assert int(res_eng.k[0]) == int(res_inc.k[0])
    # sol iterates stay incremental; u is de-scaled to engineering units
    np.testing.assert_allclose(res_eng.sol["z"][0].numpy(),
                               res_inc.sol["z"][0].numpy(), rtol=0,
                               atol=1e-12)
    u_expected = res_inc.u[0].numpy() / Nu + u_op
    np.testing.assert_allclose(res_eng.u[0].numpy(), u_expected, rtol=0,
                               atol=1e-12)
    ref = _eng_solver(jsp, sys, param, **kw)(x_eng, xr_eng, ur_eng)
    assert int(ref.k[0]) == int(res_eng.k[0])
    np.testing.assert_allclose(res_eng.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=1e-9)


def test_engineering_closed_loop_regulates_to_op(fixture):
    """Closed loop in engineering units: the nonlinear Duffing plant driven
    by the engineering-units MPC approaches the operating point, each
    step's k the JAX package's."""
    sys, param, x_op, u_op, Nx, Nu = fixture
    kw = dict(rho=1.0, tol=1e-5, k_max=5000)
    s = _eng_solver(tsp, sys, param, **kw)
    s_j = _eng_solver(jsp, sys, param, **kw)
    Ts = 0.1
    x = x_op + np.array([0.1, -0.2])
    err0 = np.linalg.norm(x - x_op)
    for _ in range(100):
        res = s(x, x_op, u_op)
        assert int(res.e_flag[0]) == 1
        assert int(res.k[0]) == int(s_j(x, x_op, u_op).k[0])
        u = float(res.u[0, 0])
        # RK4 integration of the true nonlinear plant
        f = lambda xx: duffing_ode(0.0, xx, u, **DUFFING)  # noqa: E731
        k1 = f(x)
        k2 = f(x + Ts / 2 * k1)
        k3 = f(x + Ts / 2 * k2)
        k4 = f(x + Ts * k3)
        x = x + Ts / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    assert np.linalg.norm(x - x_op) < 0.2 * err0


_ENG_TRIPLES = [
    ("laxMPC", "FISTA", ""), ("equMPC", "ADMM", ""),
    ("ellipMPC", "ADMM", ""), ("ellipMPC", "ADMM", "soc"),
    ("MPCT", "EADMM", ""), ("MPCT", "ADMM", "cs"),
    ("MPCT", "ADMM", "semiband"),
    ("HMPC", "ADMM", ""), ("HMPC", "ADMM", "split"),
    ("ellipHMPC", "ADMM", ""),
]


@pytest.mark.parametrize("triple", _ENG_TRIPLES,
                         ids=["-".join(filter(None, t))
                              for t in _ENG_TRIPLES])
def test_engineering_mode_all_families(triple):
    """The in_engineering solve of engineering-unit inputs equals the
    plain solve of the scaled inputs, u de-scaled back; and the JAX
    package's in_engineering solve: k equal, u within 1e-9."""
    f, m_, sm = triple
    sys0, param, st = tsp.systems.tester_fixture()
    sysd, p, kw, _ = _float_setup(triple, sys0, param, st)
    n = len(st["x"])
    mdim = sysd["B"].shape[1]
    Nx, Nu = np.full(n, 1.5), np.full(mdim, 0.8)
    x_op, u_op = 0.01 * np.ones(n), 0.02 * np.ones(mdim)
    sys_eng = dict(sysd, Nx=Nx, Nu=Nu, x0=x_op, u0=u_op)
    for key in ("tol", "tol_p", "tol_d"):
        if key in kw:
            kw[key] = 1e-7

    def eng(pkg):
        opt = pkg.default_options(f, m_, sm, **kw)
        opt.in_engineering = True
        return pkg.make_solver(sys_eng, p, formulation=f, method=m_,
                               submethod=sm, options=opt, **_on_cpu(pkg))

    s_eng = eng(tsp)
    s_inc = tsp.make_solver(sysd, p, formulation=f, method=m_, submethod=sm,
                            device="cpu", **kw)
    x0e = np.asarray(st["x"]) / Nx + x_op
    xre = np.asarray(st["xr"]) / Nx + x_op
    ure = np.asarray(st["ur"]) / Nu + u_op
    if f == "ellipHMPC":
        za, zu = np.zeros(n), np.zeros(mdim)
        args_eng = (x0e, xre, za, za, ure, zu, zu)
        args_inc = (st["x"], st["xr"], za, za, st["ur"], zu, zu)
    elif (f, sm) == ("ellipMPC", "soc"):
        args_eng = (x0e, xre, ure, np.array([0.5]))
        args_inc = (st["x"], st["xr"], st["ur"], np.array([0.5]))
    else:
        args_eng = (x0e, xre, ure)
        args_inc = (st["x"], st["xr"], st["ur"])
    r_eng, r_inc = s_eng(*args_eng), s_inc(*args_inc)
    assert int(r_eng.e_flag[0]) == int(r_inc.e_flag[0]) == 1, triple
    assert int(r_eng.k[0]) == int(r_inc.k[0]), triple
    zkey = "z1" if m_ == "EADMM" else "z"   # 3-block EADMM sol layout
    np.testing.assert_allclose(r_eng.sol[zkey][0].numpy(),
                               r_inc.sol[zkey][0].numpy(), rtol=0,
                               atol=1e-10)
    u_expected = r_inc.u[0].numpy() / Nu + u_op
    np.testing.assert_allclose(r_eng.u[0].numpy(), u_expected, rtol=0,
                               atol=1e-10)
    ref = eng(jsp)(*args_eng)
    assert int(ref.k[0]) == int(r_eng.k[0]), triple
    np.testing.assert_allclose(r_eng.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=1e-9)


def test_engineering_harmonic_amplitude_scaling():
    """Amplitude inputs (xrs/xrc/urs/urc) scale without the operating-point
    offset: x_eng(t) = xre + xrs sin + xrc cos maps to
    Nx(xre - opx) + (Nx xrs) sin + (Nx xrc) cos."""
    sys0, param, st = tsp.systems.tester_fixture()
    sysd, p, kw, _ = _float_setup(("ellipHMPC", "ADMM", ""), sys0, param,
                                  st)
    n, mdim = len(st["x"]), sysd["B"].shape[1]
    Nx, Nu = np.full(n, 2.0), np.full(mdim, 0.5)
    x_op, u_op = 0.02 * np.ones(n), 0.01 * np.ones(mdim)
    sys_eng = dict(sysd, Nx=Nx, Nu=Nu, x0=x_op, u0=u_op)
    opt = tsp.default_options("ellipHMPC", "ADMM", **kw)
    opt.in_engineering = True
    s_eng = tsp.make_solver(sys_eng, p, formulation="ellipHMPC",
                            method="ADMM", options=opt, device="cpu")
    s_inc = tsp.make_solver(sysd, p, formulation="ellipHMPC",
                            method="ADMM", device="cpu", **kw)
    xrs_i = 0.02 * np.ones(n)     # incremental sine amplitude
    urs_i = 0.05 * np.ones(mdim)
    r_eng = s_eng(np.asarray(st["x"]) / Nx + x_op,
                  np.asarray(st["xr"]) / Nx + x_op,
                  xrs_i / Nx, np.zeros(n),
                  np.asarray(st["ur"]) / Nu + u_op,
                  urs_i / Nu, np.zeros(mdim))
    r_inc = s_inc(st["x"], st["xr"], xrs_i, np.zeros(n),
                  st["ur"], urs_i, np.zeros(mdim))
    assert int(r_eng.k[0]) == int(r_inc.k[0])
    np.testing.assert_allclose(r_eng.sol["z"][0].numpy(),
                               r_inc.sol["z"][0].numpy(), rtol=0,
                               atol=1e-10)


def test_engineering_units_through_scale_out(fixture):
    """An in_engineering solver through shard_map_solver (8 CPU shards)
    and sharded_solver (2) gives the unsharded call's u, in engineering
    units, bit for bit against a separate call of each shard's lanes.
    The JAX package's shard_map_solver calls the raw solve: its u is the
    incremental solve of the unscaled engineering inputs (a reference
    fault the port fixes), while its sharded_solver scales."""
    sys, param, x_op, u_op, Nx, Nu = fixture
    kw = dict(rho=1.0, tol=1e-7, k_max=5000)
    s_eng = _eng_solver(tsp, sys, param, **kw)
    B = 8
    rng = np.random.default_rng(7)
    x_eng = x_op + rng.uniform(-0.1, 0.1, (B, 2))
    xr_eng, ur_eng = np.tile(x_op, (B, 1)), np.tile(u_op, (B, 1))
    plain = s_eng(x_eng, xr_eng, ur_eng)
    assert bool((plain.e_flag == 1).all())
    for wrap, devices in ((tsp.parallel.shard_map_solver, ["cpu"] * 8),
                          (tsp.parallel.sharded_solver, ["cpu"] * 2)):
        res = wrap(s_eng, tsp.parallel.batch_mesh(devices))(
            x_eng, xr_eng, ur_eng)
        assert torch.equal(res.k, plain.k)
        np.testing.assert_allclose(res.u.numpy(), plain.u.numpy(), rtol=0,
                                   atol=1e-12)
        per = B // len(devices)
        for j in range(len(devices)):
            sl = slice(j * per, (j + 1) * per)
            part = s_eng(x_eng[sl], xr_eng[sl], ur_eng[sl])
            assert torch.equal(res.u[sl], part.u)

    j_eng = _eng_solver(jsp, sys, param, **kw)
    j_ref = j_eng(x_eng, xr_eng, ur_eng)
    np.testing.assert_allclose(plain.u.numpy(), np.asarray(j_ref.u),
                               rtol=0, atol=1e-9)
    j_sharded = jsp.parallel.sharded_solver(
        j_eng, jsp.parallel.batch_mesh())(x_eng, xr_eng, ur_eng)
    np.testing.assert_allclose(np.asarray(j_sharded.u), np.asarray(j_ref.u),
                               rtol=0, atol=1e-9)
    j_map = jsp.parallel.shard_map_solver(
        j_eng, jsp.parallel.host_chip_mesh())(x_eng, xr_eng, ur_eng)
    j_inc = jsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                            **kw)(x_eng, xr_eng, ur_eng)
    np.testing.assert_allclose(np.asarray(j_map.u), np.asarray(j_inc.u),
                               rtol=0, atol=1e-9)
    assert np.max(np.abs(np.asarray(j_map.u) - np.asarray(j_ref.u))) > 0.1
