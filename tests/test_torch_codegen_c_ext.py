"""Ports of tests/test_codegen_c_ext.py: the generated plain-C solvers of
the remaining triples (MPCT/ADMM-cs, MPCT/ADMM-semiband,
ellipMPC/ADMM-soc, HMPC/{ADMM,SADMM}-split, ellipHMPC/ADMM), the
time-varying, vector-rho, engineering-units and float builds, generated
by spcies_tpu_torch.codegen, compiled with cc, run through its ctypes
bridge and held against the port's fp64 dense solver on the CPU at the
JAX tests' bars: the same k and e_flag, iterates and u within 1e-10
(1e-9 for engineering units, as there).

Every test generates and loads in its own directory (`outdir`): ctypes
keeps a loaded library by its path."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tests.test_codegen_c_ext import _FLOAT_TRIPLES, _float_setup

import spcies_tpu_torch as tsp
from spcies_tpu_torch.codegen import (generate_embedded_solver,
                                      CompiledCSolver,
                                      CompiledCSemibandSolver,
                                      CompiledCSplitSolver,
                                      CompiledCEllipHmpcSolver)

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread while this module runs: numpy's OpenBLAS threads
    spin-wait for each other, and under the suite's workers a small
    factorization waits for all of them to be scheduled."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture
def outdir(tmp_path):
    return str(tmp_path)


@pytest.fixture(scope="module")
def base():
    return tsp.systems.tester_fixture()


def _dense(sys, p, **kw):
    """The port's fp64 dense solver on the CPU."""
    return tsp.make_solver(sys, p, device="cpu", **kw)


def _compare(sol_c, res, keys, tol=1e-10):
    for key in keys:
        gap = np.max(np.abs(sol_c[key] - np.asarray(res.sol[key][0])))
        assert gap < tol, (key, gap)


def test_c_mpct_cs_matches_torch(base, outdir):
    sys, param, st = base
    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    opts = dict(rho=1e-2, tol=1e-7, k_max=5000)
    generate_embedded_solver(sys, p, formulation="MPCT", method="ADMM",
                             submethod="cs", directory=outdir, **opts)
    s_t = _dense(sys, p, formulation="MPCT", method="ADMM",
                           submethod="cs", **opts)
    c = CompiledCSolver("mpct_admm_cs", n=s_t.n, m=s_t.m, nz=s_t.nz,
                        directory=outdir)
    rng = np.random.default_rng(21)
    for trial in range(3):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s_t(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


@pytest.mark.parametrize("variant", ["hard", "soft", "con_out"])
def test_c_mpct_semiband_matches_torch(base, outdir, variant):
    sys, param, st = base
    sys = dict(sys)
    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    opts = dict(rho=0.5, tol_p=1e-7, tol_d=1e-7, k_max=5000)
    if variant == "soft":
        opts.update(soft_constraints=True, beta=1.0)
    if variant == "con_out":
        n, m = len(st["x"]), len(st["ur"])
        sys["C"] = np.eye(3, n)
        sys["D"] = np.zeros((3, m))
        sys["LBy"] = -0.25 * np.ones(3)
        sys["UBy"] = 0.25 * np.ones(3)
        opts.update(constrained_output=True)
    name = f"mpct_semiband_{variant}"
    generate_embedded_solver(sys, p, formulation="MPCT", method="ADMM",
                             submethod="semiband", directory=outdir,
                             save_name=name, **opts)
    s_t = _dense(sys, p, formulation="MPCT", method="ADMM",
                           submethod="semiband", **opts)
    ing = s_t.ingredients
    c = CompiledCSemibandSolver(name, n=s_t.n, m=s_t.m, nz=ing["nz"],
                                nv=ing["nv"], directory=outdir)
    rng = np.random.default_rng(22)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s_t(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


def test_c_ellipmpc_soc_matches_torch(base, outdir):
    """Runtime-radius SOC variant: the radius is a per-call input, so one
    generated binary serves multiple radii (the reference MEX's 4th
    argument, code_ellipMPC_ADMM_soc_C.c:20)."""
    sys, param, st = base
    p = dict(param)
    p["T"] = np.diag(np.sum(p["T"], axis=1))
    n = len(st["xr"])
    rng = np.random.default_rng(23)
    M = rng.standard_normal((n, n))
    p["P"] = np.eye(n) + 0.1 * (M @ M.T)
    p["c"] = np.asarray(st["xr"])
    opts = dict(rho=15.0, sigma=10.0, tol_p=1e-7, tol_d=1e-7, k_max=5000)
    generate_embedded_solver(sys, p, formulation="ellipMPC", method="ADMM",
                             submethod="soc", directory=outdir, **opts)
    s_t = _dense(sys, p, formulation="ellipMPC", method="ADMM",
                           submethod="soc", **opts)
    ing = s_t.ingredients
    c = CompiledCSplitSolver("ellipmpc_admm_soc", n=s_t.n, m=s_t.m,
                             dim=ing["dim"], n_s=ing["n_s"],
                             has_radius=True, directory=outdir)
    for r_ellip in (0.05, 0.5):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"], r_ellip)
        r = s_t(x0, st["xr"], st["ur"], np.array([r_ellip]))
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "s", "lam", "mu"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


def _hmpc_param(param):
    p = dict(param)
    p.pop("T", None)
    p["w"] = 3 * 1.627 * 0.2
    p["Te"] = 10 * p["N"] * np.asarray(p["Q"])
    p["Th"] = p["Te"]
    p["Se"] = np.asarray(p["R"]).copy()
    p["Sh"] = 0.5 * p["Se"]
    return p


@pytest.mark.parametrize("method,use_soc", [("ADMM", False), ("ADMM", True),
                                            ("SADMM", False)])
def test_c_hmpc_split_matches_torch(base, outdir, method, use_soc):
    sys, param, st = base
    p = _hmpc_param(param)
    opts = dict(rho=2.0, sigma=20.0, tol_p=1e-7, tol_d=1e-7, k_max=5000,
                use_soc=use_soc)
    name = f"hmpc_{method.lower()}_split_{'soc' if use_soc else 'd'}"
    generate_embedded_solver(sys, p, formulation="HMPC", method=method,
                             submethod="split", directory=outdir,
                             save_name=name, **opts)
    s_t = _dense(sys, p, formulation="HMPC", method=method,
                           submethod="split", **opts)
    ing = s_t.ingredients
    c = CompiledCSplitSolver(name, n=s_t.n, m=s_t.m, dim=ing["dim"],
                             n_s=ing["n_s"], directory=outdir)
    rng = np.random.default_rng(24)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s_t(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "s", "lam", "mu"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


@pytest.mark.parametrize("use_soc", [False, True])
def test_c_elliphmpc_matches_torch(base, outdir, use_soc):
    sys, param, st = base
    sys = dict(sys)
    n, m = len(st["x"]), len(st["ur"])
    sys["E"] = np.eye(3, n)
    sys["F"] = np.zeros((3, m))
    sys["LBy"] = -0.3 * np.ones(3)
    sys["UBy"] = 0.3 * np.ones(3)
    p = _hmpc_param(param)
    opts = dict(rho=2.0, sigma=0.01, tol_p=1e-7, tol_d=1e-7, k_max=5000,
                use_soc=use_soc)
    name = f"elliphmpc_{'soc' if use_soc else 'd'}"
    generate_embedded_solver(sys, p, formulation="ellipHMPC",
                             directory=outdir, save_name=name, **opts)
    s_t = _dense(sys, p, formulation="ellipHMPC", method="ADMM",
                           **opts)
    ing = s_t.ingredients
    c = CompiledCEllipHmpcSolver(name, n=s_t.n, m=s_t.m,
                                 dim=ing["dim"], n_s=ing["n_s"],
                                 directory=outdir)
    xr, ur = st["xr"], st["ur"]
    zn, zm = np.zeros_like(xr), np.zeros_like(ur)
    rng = np.random.default_rng(25)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        args = (x0, xr, zn, zn, ur, zm, zm)
        u_c, k_c, e_c, sol_c = c(*args)
        r = s_t(*args)
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "s", "lam"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_c_time_varying_matches_torch(base, outdir, formulation):
    """TIME_VARYING C solver (9-input signature, online Alpha/Beta
    Cholesky) vs the port's time-varying engine, on a PERTURBED model so the
    online factorization is genuinely exercised."""
    from spcies_tpu_torch.codegen import CompiledCTvSolver
    sys, param, st = base
    p = dict(param)
    if formulation == "equMPC":
        p.pop("T", None)
    else:
        p = dict(p, T=np.diag(np.sum(np.asarray(p["T"]), axis=1)))
    opts = dict(rho=15.0, tol=1e-7, k_max=5000)
    generate_embedded_solver(sys, p, formulation=formulation,
                             method="ADMM", time_varying=True,
                             directory=outdir, **opts)
    opt = tsp.default_options(formulation, "ADMM", **opts)
    opt.time_varying = True
    s_t = _dense(sys, p, formulation=formulation, method="ADMM",
                           options=opt)
    c = CompiledCTvSolver(f"{formulation.lower()}_admm_tv", n=s_t.n,
                          m=s_t.m, nz=s_t.nz, directory=outdir)
    n, m = s_t.n, s_t.m
    rng = np.random.default_rng(26)
    LB = np.concatenate([sys["LBx"], sys["LBu"]])
    UB = np.concatenate([sys["UBx"], sys["UBu"]])
    for trial in range(2):
        A = np.asarray(sys["A"]) * (1.0 + 0.05 * trial)
        B = np.asarray(sys["B"]) * (1.0 - 0.03 * trial)
        Qd = np.diag(np.asarray(param["Q"])) * (1.0 + 0.1 * trial)
        Rd = np.diag(np.asarray(param["R"]))
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"], A, B, Qd, Rd,
                                 LB, UB)
        r = s_t(x0, st["xr"], st["ur"], A, B, Qd, Rd, LB, UB)
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_c_time_varying_fista_matches_torch(base, outdir, formulation):
    """TIME_VARYING FISTA C solver vs the port's time-varying dual-FISTA
    engine on a perturbed model."""
    from spcies_tpu_torch.codegen import CompiledCTvFistaSolver
    sys, param, st = base
    p = dict(param)
    if formulation == "equMPC":
        p.pop("T", None)
    else:
        p = dict(p, T=np.diag(np.sum(np.asarray(p["T"]), axis=1)))
    opts = dict(tol=1e-7, k_max=5000)
    generate_embedded_solver(sys, p, formulation=formulation,
                             method="FISTA", time_varying=True,
                             directory=outdir, **opts)
    opt = tsp.default_options(formulation, "FISTA", **opts)
    opt.time_varying = True
    s_t = _dense(sys, p, formulation=formulation, method="FISTA",
                           options=opt)
    c = CompiledCTvFistaSolver(f"{formulation.lower()}_fista_tv",
                               n=s_t.n, m=s_t.m, N=s_t.N,
                               nz=s_t.nz, directory=outdir)
    rng = np.random.default_rng(27)
    LB = np.concatenate([sys["LBx"], sys["LBu"]])
    UB = np.concatenate([sys["UBx"], sys["UBu"]])
    for trial in range(2):
        A = np.asarray(sys["A"]) * (1.0 + 0.05 * trial)
        B = np.asarray(sys["B"]) * (1.0 - 0.03 * trial)
        Qd = np.diag(np.asarray(param["Q"])) * (1.0 + 0.1 * trial)
        Rd = np.diag(np.asarray(param["R"]))
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"], A, B, Qd, Rd,
                                 LB, UB)
        r = s_t(x0, st["xr"], st["ur"], A, B, Qd, Rd, LB, UB)
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "lam"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


def test_c_vector_rho_matches_torch(base, outdir):
    """Vector-rho static C solver (the reference's non-SCALAR_RHO path,
    cons_laxMPC_ADMM_C.m:119-130) vs the port's dense engine."""
    from spcies_tpu_torch.codegen import generate_c_solver
    sys, param, st = base
    p = dict(param)
    p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    n, m, N = len(st["x"]), len(st["ur"]), int(p["N"])
    rho_vec = 15.0 * (1.0 + 0.5 * np.sin(np.arange(N * (n + m))))
    opts = dict(rho=rho_vec, tol=1e-7, k_max=5000)
    generate_c_solver(sys, p, formulation="laxMPC", directory=outdir,
                      save_name="laxmpc_admm_vrho", **opts)
    src = open(f"{outdir}/laxmpc_admm_vrho.c").read()
    assert "RHOV" in src and "#define RHO " not in src
    s_t = _dense(sys, p, formulation="laxMPC", method="ADMM",
                           **opts)
    c = CompiledCSolver("laxmpc_admm_vrho", n=s_t.n, m=s_t.m,
                        nz=s_t.nz, directory=outdir)
    rng = np.random.default_rng(28)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s_t(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))


def test_c_engineering_units_matches_torch(outdir):
    """in_engineering static C solver: scaled inputs, de-scaled u output
    (code_laxMPC_ADMM_C.c:82-115, :642-651) vs the port's dense engineering path on
    the Duffing plant (t03 workflow)."""
    from spcies_tpu_torch.codegen import generate_c_solver
    from spcies_tpu_torch.systems import duffing_to_ss, scale_ss
    from spcies_tpu_torch.utils import linalg
    x_op = np.array([0.0, 1.0])
    u_op = np.array([0.0])
    Ac, Bc = duffing_to_ss(x_op, u_op, alpha=-1.0, beta=1.0, delta=0.3,
                           gamma=1.0)
    A, B = linalg.c2d_zoh(Ac, Bc, 0.1)
    Nx, Nu = np.array([2.0, 0.5]), np.array([4.0])
    sys = dict(scale_ss(A, B, UBx=x_op + 0.5, LBx=x_op - 0.5,
                        UBu=u_op + 1.0, LBu=u_op - 1.0,
                        x0=x_op, u0=u_op, Nx=Nx, Nu=Nu))
    param = dict(Q=np.diag([1.0, 10.0]), R=np.eye(1),
                 T=np.diag([5.0, 50.0]), N=12)
    opt = tsp.default_options("laxMPC", "ADMM", rho=1.0, tol=1e-7,
                             k_max=5000)
    opt.in_engineering = True
    generate_c_solver(sys, param, formulation="laxMPC", options=opt,
                      directory=outdir, save_name="laxmpc_admm_eng")
    s_t = _dense(sys, param, formulation="laxMPC", method="ADMM",
                           options=opt)
    c = CompiledCSolver("laxmpc_admm_eng", n=s_t.n, m=s_t.m,
                        nz=s_t.nz, directory=outdir)
    x_eng = x_op + np.array([0.05, -0.1])
    u_c, k_c, e_c, sol_c = c(x_eng, x_op, u_op)
    r = s_t(x_eng, x_op, u_op)
    assert e_c == int(r.e_flag[0]) == 1
    assert k_c == int(r.k[0])
    _compare(sol_c, r, ("z", "v", "lam"))
    # u returned in ENGINEERING units by both paths
    assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


def test_phase_timers(base, outdir):
    """Generated C returns the reference's four phase timers
    (update/solve/polish/run, docs/timing.md) with run = sum of phases."""
    sys, param, st = base
    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    opts = dict(rho=1e-2, tol=1e-7, k_max=5000)
    generate_embedded_solver(sys, p, formulation="MPCT", method="ADMM",
                             submethod="cs", directory=outdir,
                             save_name="mpct_cs_timers", **opts)
    s_t = _dense(sys, p, formulation="MPCT", method="ADMM",
                           submethod="cs", **opts)
    c = CompiledCSolver("mpct_cs_timers", n=s_t.n, m=s_t.m, nz=s_t.nz,
                        directory=outdir)
    _, _, _, sol = c(st["x"], st["xr"], st["ur"])
    for key in ("update_time_ms", "solve_time_ms", "polish_time_ms",
                "run_time_ms"):
        assert sol[key] >= 0.0
    assert sol["run_time_ms"] > 0.0
    total = (sol["update_time_ms"] + sol["solve_time_ms"]
             + sol["polish_time_ms"])
    assert abs(sol["run_time_ms"] - total) < 0.05 * max(sol["run_time_ms"],
                                                        1e-3)


def test_c_float_precision(base, outdir):
    """precision='float' emits a single-precision solver (reference
    precision option, Spcies_options.m:66): converges, and matches the
    fp64 optimum to fp32-class accuracy."""
    from spcies_tpu_torch.codegen import generate_c_solver
    sys, param, st = base
    p = dict(param)
    p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                             k_max=5000)
    opt.precision = "float"
    generate_c_solver(sys, p, formulation="laxMPC", options=opt,
                      directory=outdir, save_name="laxmpc_admm_f32")
    src = open(f"{outdir}/laxmpc_admm_f32.c").read()
    assert "float" in src and "double" not in src
    c = CompiledCSolver("laxmpc_admm_f32", n=6, m=2, nz=80,
                        directory=outdir, precision="float")
    s64 = _dense(sys, p, formulation="laxMPC", method="ADMM",
                         rho=15.0, tol=1e-4, k_max=5000)
    u_c, k_c, e_c, sol_c = c(st["x"], st["xr"], st["ur"])
    r = s64(st["x"], st["xr"], st["ur"])
    assert e_c == 1
    assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-3


def test_cl_demo_executable(base, outdir):
    """Pure-C closed-loop demo (main_cl_in_C.c analogue): generates,
    compiles and runs a standalone executable that regulates the plant to
    the steady-state reference."""
    import subprocess
    from spcies_tpu_torch.codegen import generate_cl_demo
    sys, param, st = base
    p = dict(param)
    p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    exe = generate_cl_demo(sys, p, formulation="laxMPC",
                           x_init=np.asarray(st["x"]) * 3.0, steps=25,
                           directory=outdir, rho=15.0, tol=1e-5,
                           k_max=2000)
    out = subprocess.run([exe], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    last = [l for l in out.stdout.splitlines() if l.startswith("final")][0]
    final_err = float(last.split("=")[1])
    assert final_err < 1e-2
    assert out.stdout.count("t=") == 25


def test_override_and_const_are_static(base, outdir):
    """override=False picks an unused <name>_vN (find_unused_file_name.m);
    const_are_static=False emits plain `const` arrays (dec_var.m)."""
    import os
    from spcies_tpu_torch.codegen import generate_c_solver
    sys, param, st = base
    p = dict(param)
    p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                             k_max=1000)
    opt.override = False
    opt.const_are_static = False
    d = os.path.join(outdir, "ov")
    p1 = generate_c_solver(sys, p, formulation="laxMPC", options=opt,
                           directory=d, compile=False)
    p2 = generate_c_solver(sys, p, formulation="laxMPC", options=opt,
                           directory=d, compile=False)
    assert p1.endswith("laxmpc_admm.c")
    assert p2.endswith("laxmpc_admm_v2.c")
    src = open(p2).read()
    assert "static const" not in src and "const double" in src


def test_dispatcher_rejects_unknown(base):
    sys, param, _ = base
    with pytest.raises(ValueError):
        generate_embedded_solver(sys, param, formulation="noMPC")


def test_c_equmpc_engineering_units(base, outdir):
    """equMPC + in_engineering C generation (regression: the ingredients
    must carry the scaling fields)."""
    from spcies_tpu_torch.codegen import generate_c_solver
    sys, param, st = base
    n, m = len(st["x"]), len(st["ur"])
    # operating-point offsets exercise the scale/de-scale path without
    # changing the (already feasible) incremental problem's conditioning
    x_op, u_op = 0.01 * np.ones(n), 0.02 * np.ones(m)
    sys = dict(sys, Nx=np.ones(n), Nu=np.ones(m), x0=x_op, u0=u_op)
    p = dict(param)
    p.pop("T", None)
    opt = tsp.default_options("equMPC", "ADMM", rho=15.0, tol=1e-7,
                             k_max=5000)
    opt.in_engineering = True
    generate_c_solver(sys, p, formulation="equMPC", options=opt,
                      directory=outdir, save_name="equmpc_eng")
    s_t = _dense(sys, p, formulation="equMPC", method="ADMM",
                           options=opt)
    c = CompiledCSolver("equmpc_eng", n=s_t.n, m=s_t.m, nz=s_t.nz,
                        directory=outdir)
    x0 = np.asarray(st["x"]) * 0.5 + x_op
    u_c, k_c, e_c, sol_c = c(x0, st["xr"] + x_op, st["ur"] + u_op)
    r = s_t(x0, st["xr"] + x_op, st["ur"] + u_op)
    assert e_c == int(r.e_flag[0]) == 1
    assert k_c == int(r.k[0])
    assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


# ---------------------------------------------------------------------------
# precision='float' across every generated triple (reference precision
# option, Spcies_options.m:66; dec_var.m type map): each fp32 C solver
# must converge and match the port's fp64 optimum to fp32-class accuracy.
# ---------------------------------------------------------------------------

def _make_bridge(triple, name, s_t, outdir, precision="double"):
    """Select the matching ctypes bridge class for a generated triple."""
    from spcies_tpu_torch.codegen import (CompiledCFistaSolver,
                                    CompiledCMpctEadmmSolver,
                                    CompiledCHmpcSolver)
    f, m_, sm = triple
    ing = s_t.ingredients
    if f in ("laxMPC", "equMPC", "ellipMPC") and m_ == "ADMM" and not sm:
        return CompiledCSolver(name, n=s_t.n, m=s_t.m, nz=s_t.nz,
                               directory=outdir, precision=precision)
    if m_ == "FISTA":
        return CompiledCFistaSolver(name, n=s_t.n, m=s_t.m, N=s_t.N,
                                    nz=s_t.nz, directory=outdir,
                                    precision=precision)
    if m_ == "EADMM":
        return CompiledCMpctEadmmSolver(name, n=s_t.n, m=s_t.m,
                                        N=s_t.N, directory=outdir,
                                        precision=precision)
    if (f, sm) == ("MPCT", "cs"):
        return CompiledCSolver(name, n=s_t.n, m=s_t.m, nz=s_t.nz,
                               directory=outdir, precision=precision)
    if (f, sm) == ("MPCT", "semiband"):
        return CompiledCSemibandSolver(name, n=s_t.n, m=s_t.m,
                                       nz=ing["nz"],
                                       nv=ing.get("nv", ing["nz"]),
                                       directory=outdir,
                                       precision=precision)
    if (f, sm) == ("ellipMPC", "soc"):
        return CompiledCSplitSolver(name, n=s_t.n, m=s_t.m,
                                    dim=ing["dim"], n_s=ing["n_s"],
                                    has_radius=True, directory=outdir,
                                    precision=precision)
    if f == "ellipHMPC":
        return CompiledCEllipHmpcSolver(name, n=s_t.n, m=s_t.m,
                                        dim=ing["dim"], n_s=ing["n_s"],
                                        directory=outdir,
                                        precision=precision)
    if sm == "split":
        return CompiledCSplitSolver(name, n=s_t.n, m=s_t.m,
                                    dim=ing["dim"], n_s=ing["n_s"],
                                    directory=outdir, precision=precision)
    return CompiledCHmpcSolver(name, n=s_t.n, m=s_t.m,
                               dim=ing["dim"], n_s=ing["n_s"],
                               directory=outdir, precision=precision)


@pytest.mark.parametrize("triple", _FLOAT_TRIPLES,
                         ids=["-".join(filter(None, t))
                              for t in _FLOAT_TRIPLES])
def test_c_float_precision_all_triples(base, outdir, triple):
    f, m_, sm = triple
    sys0, param, st = base
    sysd, p, kw, u_tol = _float_setup(triple, sys0, param, st)
    name = ("f32_" + "_".join(filter(None, triple))).lower()

    opt = tsp.default_options(f, m_, sm, **kw)
    opt.precision = "float"
    generate_embedded_solver(sysd, p, formulation=f, method=m_,
                             submethod=sm, directory=outdir,
                             save_name=name, options=opt)
    src = open(f"{outdir}/{name}.c").read()
    assert "double" not in src, "float build must be fully retyped"

    s_t = _dense(sysd, p, formulation=f, method=m_,
                           submethod=sm, **kw)
    c = _make_bridge(triple, name, s_t, outdir, precision="float")

    if f == "ellipHMPC":
        zeros_n = np.zeros(s_t.n)
        zeros_m = np.zeros(s_t.m)
        args = (st["x"], st["xr"], zeros_n, zeros_n,
                st["ur"], zeros_m, zeros_m)
    elif (f, sm) == ("ellipMPC", "soc"):
        u_c, k_c, e_c, sol_c = c(st["x"], st["xr"], st["ur"], 0.5)
        r = s_t(st["x"], st["xr"], st["ur"], np.array([0.5]))
        assert e_c == 1 and int(r.e_flag[0]) == 1
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < u_tol, triple
        return
    else:
        args = (st["x"], st["xr"], st["ur"])
    u_c, k_c, e_c, sol_c = c(*args)
    r = s_t(*args)
    assert e_c == 1, (triple, k_c)
    assert int(r.e_flag[0]) == 1
    assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < u_tol, triple


# ---------------------------------------------------------------------------
# in_engineering across every generated triple (the reference bakes
# engineering-units scaling into every formulation's generated solver,
# e.g. cons_MPCT_EADMM_C.m:109, code_HMPC_ADMM_C.c scaling blocks,
# code_ellipMPC_ADMM_C.c): scaled inputs on entry, de-scaled u on exit,
# matched against the port's engineering path at the fp64 contract.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("triple", _FLOAT_TRIPLES,
                         ids=["-".join(filter(None, t))
                              for t in _FLOAT_TRIPLES])
def test_c_engineering_units_all_triples(base, outdir, triple):
    f, m_, sm = triple
    sys0, param, st = base
    sysd, p, kw, _ = _float_setup(triple, sys0, param, st)
    n = len(st["x"])
    mdim = sysd["B"].shape[1]
    Nx, Nu = np.full(n, 1.5), np.full(mdim, 0.8)
    x_op, u_op = 0.01 * np.ones(n), 0.02 * np.ones(mdim)
    sysd = dict(sysd, Nx=Nx, Nu=Nu, x0=x_op, u0=u_op)
    kw = dict(kw)
    # tight tolerances so both paths iterate to the same exit
    for key in ("tol", "tol_p", "tol_d"):
        if key in kw:
            kw[key] = 1e-7
    name = ("eng_" + "_".join(filter(None, triple))).lower()

    opt = tsp.default_options(f, m_, sm, **kw)
    opt.in_engineering = True
    generate_embedded_solver(sysd, p, formulation=f, method=m_,
                             submethod=sm, directory=outdir,
                             save_name=name, options=opt)
    src = open(f"{outdir}/{name}.c").read()
    assert "NXV" in src and "OPU" in src

    opt_j = tsp.default_options(f, m_, sm, **kw)
    opt_j.in_engineering = True
    s_t = _dense(sysd, p, formulation=f, method=m_,
                           submethod=sm, options=opt_j)
    c = _make_bridge(triple, name, s_t, outdir)

    # engineering-unit inputs that map to the tester-fixture incremental
    # scenario: x_eng = x_incr / Nx + op (amplitudes carry no offset)
    x0e = np.asarray(st["x"]) / Nx + x_op
    xre = np.asarray(st["xr"]) / Nx + x_op
    ure = np.asarray(st["ur"]) / Nu + u_op
    if f == "ellipHMPC":
        za = np.zeros(n)
        zu = np.zeros(mdim)
        args = (x0e, xre, za, za, ure, zu, zu)
        u_c, k_c, e_c, sol_c = c(*args)
        r = s_t(*args)
    elif (f, sm) == ("ellipMPC", "soc"):
        u_c, k_c, e_c, sol_c = c(x0e, xre, ure, 0.5)
        r = s_t(x0e, xre, ure, np.array([0.5]))
    else:
        u_c, k_c, e_c, sol_c = c(x0e, xre, ure)
        r = s_t(x0e, xre, ure)
    assert e_c == 1 and int(r.e_flag[0]) == 1, (triple, k_c)
    assert k_c == int(r.k[0]), triple
    # u returned in ENGINEERING units by both paths
    assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-9, triple


def test_c_ellipmpc_vector_rho_matches_torch(base, outdir):
    """Vector-rho ellipMPC C (the reference's non-SCALAR_RHO path,
    cons_ellipMPC_ADMM_C.m SCALAR_RHO block): per-entry RHOV on the stage
    rows, scalar RHO_T on the P-weighted terminal block."""
    from spcies_tpu_torch.codegen import generate_c_solver
    sys, param, st = base
    p = dict(param)
    p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
    n = len(st["x"])
    p["P"] = np.eye(n)
    p["c"] = np.asarray(st["xr"])
    p["r"] = 0.5
    nm = n + len(st["ur"])
    N = int(p["N"])
    nz = N * nm
    rho_vec = 15.0 * (1.0 + 0.5 * np.sin(np.arange(nz)))
    rho_vec[nz - n:] = 20.0       # terminal block must be constant
    opts = dict(rho=rho_vec, tol=1e-7, k_max=5000)
    generate_c_solver(sys, p, formulation="ellipMPC", directory=outdir,
                      save_name="ellipmpc_vrho", **opts)
    src = open(f"{outdir}/ellipmpc_vrho.c").read()
    assert "RHOV" in src and "RHO_T" in src
    s_t = _dense(sys, p, formulation="ellipMPC", method="ADMM",
                           **opts)
    c = CompiledCSolver("ellipmpc_vrho", n=s_t.n, m=s_t.m,
                        nz=s_t.nz, directory=outdir)
    rng = np.random.default_rng(29)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s_t(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))


def test_c_mpct_semiband_vector_rho_matches_torch(base, outdir):
    """Vector-rho MPCT-semiband C (reference non-SCALAR_RHO path,
    cons_MPCT_ADMM_semiband_C.m) incl. the soft-prox beta/rho[r] offsets."""
    sys, param, st = base
    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    n, mdim, N = len(st["x"]), len(st["ur"]), int(p["N"])
    nv = (N + 1) * (n + mdim)
    rng = np.random.default_rng(30)
    rho_vec = 0.3 + 0.4 * rng.random(nv)
    opts = dict(rho=rho_vec, tol_p=1e-7, tol_d=1e-7, k_max=5000,
                soft_constraints=True, beta=1.0)
    generate_embedded_solver(sys, p, formulation="MPCT", method="ADMM",
                             submethod="semiband", directory=outdir,
                             save_name="mpct_semiband_vrho", **opts)
    src = open(f"{outdir}/mpct_semiband_vrho.c").read()
    assert "RHOV" in src and "BRV" in src
    s_t = _dense(sys, p, formulation="MPCT", method="ADMM",
                           submethod="semiband", **opts)
    ing = s_t.ingredients
    c = CompiledCSemibandSolver("mpct_semiband_vrho", n=s_t.n,
                                m=s_t.m, nz=ing["nz"], nv=ing["nv"],
                                directory=outdir)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s_t(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))
        assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-10


@pytest.mark.parametrize("method", ["ADMM", "FISTA"])
def test_c_time_varying_engineering_units(base, outdir, method):
    """TIME_VARYING + in_engineering C (the reference combines both:
    code_laxMPC_ADMM_C.c:82-115 scales signals AND the per-call bounds,
    :93-97) vs the port's TV engineering path."""
    from spcies_tpu_torch.codegen import (CompiledCTvSolver,
                                    CompiledCTvFistaSolver)
    sys0, param, st = base
    p = dict(param, T=np.diag(np.sum(np.asarray(param["T"]), axis=1)))
    n, m = len(st["x"]), len(st["ur"])
    Nx, Nu = np.full(n, 1.5), np.full(m, 0.8)
    x_op, u_op = 0.01 * np.ones(n), 0.02 * np.ones(m)
    sysd = dict(sys0, Nx=Nx, Nu=Nu, x0=x_op, u0=u_op)
    kw = (dict(rho=15.0, tol=1e-7, k_max=5000) if method == "ADMM"
          else dict(tol=1e-7, k_max=5000))
    name = f"laxmpc_{method.lower()}_tv_eng"
    opt = tsp.default_options("laxMPC", method, **kw)
    opt.in_engineering = True
    generate_embedded_solver(sysd, p, formulation="laxMPC", method=method,
                             time_varying=True, directory=outdir,
                             save_name=name, options=opt)
    src = open(f"{outdir}/{name}.c").read()
    assert "NXV" in src and "LBs[" in src
    opt_j = tsp.default_options("laxMPC", method, **kw)
    opt_j.in_engineering = True
    opt_j.time_varying = True
    s_t = _dense(sysd, p, formulation="laxMPC", method=method,
                           options=opt_j)
    if method == "ADMM":
        c = CompiledCTvSolver(name, n=n, m=m, nz=s_t.nz,
                              directory=outdir)
    else:
        c = CompiledCTvFistaSolver(name, n=n, m=m, N=s_t.N,
                                   nz=s_t.nz, directory=outdir)
    A = np.asarray(sys0["A"]) * 1.03
    B = np.asarray(sys0["B"])
    Qd = np.diag(np.asarray(param["Q"]))
    Rd = np.diag(np.asarray(param["R"]))
    # engineering-unit signals and bounds
    x0e = np.asarray(st["x"]) / Nx + x_op
    xre = np.asarray(st["xr"]) / Nx + x_op
    ure = np.asarray(st["ur"]) / Nu + u_op
    LBi = np.concatenate([sys0["LBx"], sys0["LBu"]])
    UBi = np.concatenate([sys0["UBx"], sys0["UBu"]])
    sc = np.concatenate([Nx, Nu])
    opv = np.concatenate([x_op, u_op])
    LBe, UBe = LBi / sc + opv, UBi / sc + opv
    u_c, k_c, e_c, sol_c = c(x0e, xre, ure, A, B, Qd, Rd, LBe, UBe)
    r = s_t(x0e, xre, ure, A, B, Qd, Rd, LBe, UBe)
    assert e_c == int(r.e_flag[0]) == 1
    assert k_c == int(r.k[0])
    keys = ("z", "v", "lam") if method == "ADMM" else ("z", "lam")
    _compare(sol_c, r, keys)
    assert np.max(np.abs(u_c - np.asarray(r.u[0]))) < 1e-9
