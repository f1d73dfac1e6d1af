"""The port's embedded-C generator (spcies_tpu_torch.codegen) against the
JAX package's: every generator writes the JAX emitter's files byte for
byte from the same sys, param and options; and ports of
tests/test_codegen_c.py, the compiled C held against the port's fp64
dense solver on the CPU at the JAX tests' bars (the same k and e_flag,
iterates and u within 1e-10), with test_fuzz_differential.py's
generated-C case, test_api_misc.py's sp_utils parity and Problem.generate_c
arm, and test_option_registry.py's override / const_are_static case.

Each test that compiles and loads a library uses its own directory:
ctypes keeps a loaded library by its path, so a library generated again
under the same path in one process would not be loaded again."""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
import spcies_tpu.codegen as jcg
from tests.test_codegen_c_ext import _FLOAT_TRIPLES, _float_setup
from tests.test_fuzz_differential import DIMS, _random_system

import spcies_tpu_torch as tsp
import spcies_tpu_torch.codegen as tcg
from spcies_tpu_torch.codegen import (generate_c_solver, clear_generated,
                                      CompiledCSolver)

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


# ---------------------------------------------------------------------------
# byte identity: each case runs once with (spcies_tpu, its codegen) and
# once with (spcies_tpu_torch, its codegen) into the same directory
# ---------------------------------------------------------------------------

def _tid(triple):
    return "-".join(filter(None, triple))


def _eng_sys(sysd, st):
    """The engineering-units scaling of test_codegen_c_ext.py's
    all-triples sweep."""
    n = len(st["x"])
    mdim = sysd["B"].shape[1]
    return dict(sysd, Nx=np.full(n, 1.5), Nu=np.full(mdim, 0.8),
                x0=0.01 * np.ones(n), u0=0.02 * np.ones(mdim))


def _triple_case(triple, attrs=(), eng=False, **extra):
    """generate_embedded_solver on a triple at _float_setup's settings,
    with Options attributes `attrs` set and solver options `extra`
    (constrained_output adds test_codegen_c_ext.py's three outputs)."""
    def run(sp, cg, d, name):
        sys0, param, st = sp.systems.tester_fixture()
        sysd, p, kw, _ = _float_setup(triple, sys0, param, st)
        if eng:
            sysd = _eng_sys(sysd, st)
        if extra.get("constrained_output"):
            n, m = len(st["x"]), len(st["ur"])
            sysd = dict(sysd, C=np.eye(3, n), D=np.zeros((3, m)),
                        LBy=-0.25 * np.ones(3), UBy=0.25 * np.ones(3))
        opt = sp.default_options(*triple, **dict(kw, **extra))
        for key, val in dict(attrs, in_engineering=eng).items():
            setattr(opt, key, val)
        return cg.generate_embedded_solver(
            sysd, p, formulation=triple[0], method=triple[1],
            submethod=triple[2], directory=d, save_name=name, options=opt,
            compile=False)
    return run


def _tv_case(formulation, method, eng=False):
    def run(sp, cg, d, name):
        sys0, param, st = sp.systems.tester_fixture()
        p = dict(param)
        if formulation == "equMPC":
            p.pop("T")
        else:
            p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
        sysd = _eng_sys(sys0, st) if eng else sys0
        kw = dict(tol=1e-7, k_max=5000)
        if method == "ADMM":
            kw["rho"] = 15.0
        opt = sp.default_options(formulation, method, **kw)
        opt.in_engineering = eng
        return cg.generate_embedded_solver(
            sysd, p, formulation=formulation, method=method,
            time_varying=True, directory=d, save_name=name, options=opt,
            compile=False)
    return run


def _vrho_case(formulation):
    def run(sp, cg, d, name):
        sys0, param, st = sp.systems.tester_fixture()
        p = dict(param)
        n, m, N = len(st["x"]), len(st["ur"]), int(p["N"])
        if formulation == "MPCT":
            p["T"] = 10.0 * np.asarray(p["Q"])
            p["S"] = np.asarray(p["R"]).copy()
            rho = 0.3 + 0.4 * np.random.default_rng(30).random(
                (N + 1) * (n + m))
            return cg.generate_embedded_solver(
                sys0, p, formulation="MPCT", method="ADMM",
                submethod="semiband", directory=d, save_name=name, rho=rho,
                tol_p=1e-7, tol_d=1e-7, k_max=5000, soft_constraints=True,
                beta=1.0, compile=False)
        p["T"] = np.diag(np.sum(np.asarray(p["T"]), axis=1))
        rho = 15.0 * (1.0 + 0.5 * np.sin(np.arange(N * (n + m))))
        if formulation == "ellipMPC":
            p.update(P=np.eye(n), c=np.asarray(st["xr"]), r=0.5)
            rho[N * (n + m) - n:] = 20.0
        return cg.generate_c_solver(sys0, p, formulation=formulation,
                                    directory=d, save_name=name, rho=rho,
                                    tol=1e-7, k_max=5000, compile=False)
    return run


def _static_case(sp, cg, d, name):
    sys0, param, _ = sp.systems.tester_fixture()
    opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                             k_max=100)
    opt.const_are_static = False
    opt.override = False
    paths = [cg.generate_embedded_solver(
        sys0, param, formulation="laxMPC", method="ADMM", options=opt,
        directory=d, save_name=name, compile=False) for _ in range(2)]
    assert paths[1].endswith(f"{name}_v2.c")
    return paths[1]


def _cl_demo_case(sp, cg, d, name):
    sys0, param, st = sp.systems.tester_fixture()
    p = dict(param, T=np.diag(np.sum(np.asarray(param["T"]), axis=1)))
    return cg.generate_cl_demo(sys0, p, formulation="laxMPC",
                               x_init=np.asarray(st["x"]) * 3.0, steps=25,
                               directory=d, save_name=name, rho=15.0,
                               tol=1e-5, k_max=2000, compile=False)


def _var_decl_case(sp, cg, d, name):
    rng = np.random.default_rng(3)
    for i, value in enumerate((rng.standard_normal((3, 4)),
                               rng.standard_normal((2, 2, 3)),
                               np.array([1.0, np.inf, -np.inf]))):
        cg.c_emitter.gen_var_declaration(f"V{i}", value, directory=d,
                                         save_name=f"{name}{i}",
                                         static=bool(i % 2))
    return cg.c_emitter.gen_var_declaration("KSC", 0.1, as_define=True,
                                            directory=d, save_name=name)


BYTE_CASES = {}
for _t in _FLOAT_TRIPLES:
    BYTE_CASES[_tid(_t)] = _triple_case(_t)
    BYTE_CASES[f"float-{_tid(_t)}"] = _triple_case(
        _t, attrs={"precision": "float"})
    BYTE_CASES[f"eng-{_tid(_t)}"] = _triple_case(_t, eng=True)
for _t in (("HMPC", "ADMM", ""), ("HMPC", "ADMM", "split"),
           ("HMPC", "SADMM", "split"), ("ellipHMPC", "ADMM", "")):
    BYTE_CASES[f"soc-{_tid(_t)}"] = _triple_case(_t, use_soc=True)
BYTE_CASES["semiband-soft"] = _triple_case(
    ("MPCT", "ADMM", "semiband"), soft_constraints=True, beta=1.0)
BYTE_CASES["semiband-con_out"] = _triple_case(
    ("MPCT", "ADMM", "semiband"), constrained_output=True)
for _f in ("laxMPC", "equMPC"):
    for _m in ("ADMM", "FISTA"):
        BYTE_CASES[f"tv-{_f}-{_m}"] = _tv_case(_f, _m)
for _m in ("ADMM", "FISTA"):
    BYTE_CASES[f"tv-eng-laxMPC-{_m}"] = _tv_case("laxMPC", _m, eng=True)
for _f in ("laxMPC", "ellipMPC", "MPCT"):
    BYTE_CASES[f"vrho-{_f}"] = _vrho_case(_f)
BYTE_CASES["const_are_static"] = _static_case
BYTE_CASES["cl_demo"] = _cl_demo_case
BYTE_CASES["gen_var_declaration"] = _var_decl_case


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_generated_bytes_equal(case, tmp_path):
    """The port's generator writes the JAX generator's files byte for
    byte: the same names (.c, .h, a demo's main) and the same bytes."""
    d = str(tmp_path / "gen")
    name = case.replace("-", "_").lower()
    BYTE_CASES[case](jsp, jcg, d, name)
    want = _files(d)
    clear_generated(d)
    BYTE_CASES[case](tsp, tcg, d, name)
    got = _files(d)
    assert want and sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f


# ---------------------------------------------------------------------------
# ports of tests/test_codegen_c.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    return sys, param, status


OPTS = dict(rho=15.0, tol=1e-7, k_max=5000)


def _dense(sys, p, **kw):
    """The port's fp64 dense solver on the CPU."""
    return tsp.make_solver(sys, p, device="cpu", **kw)


def _compare(sol_c, r, keys, tol=1e-10):
    for key in keys:
        gap = np.max(np.abs(sol_c[key] - r.sol[key][0].numpy()))
        assert gap < tol, (key, gap)


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_c_solver_matches_torch(fixture, formulation, tmp_path):
    sys, param, st = fixture
    outdir = str(tmp_path)
    p = dict(param)
    if formulation == "equMPC":
        p.pop("T")
    c_path = generate_c_solver(sys, p, formulation=formulation,
                               directory=outdir, **OPTS)
    assert c_path.endswith(".c")
    s = _dense(sys, p, formulation=formulation, method="ADMM", **OPTS)
    assert s.dtype == torch.float64
    c = CompiledCSolver(f"{formulation.lower()}_admm", n=s.n, m=s.m,
                        nz=s.nz, directory=outdir)
    rng = np.random.default_rng(5)
    for trial in range(3):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))
        assert np.max(np.abs(u_c - r.u[0].numpy())) < 1e-10
        assert sol_c["run_time_ms"] > 0.0


def test_generated_source_is_selfcontained(fixture, tmp_path):
    """The emitted C must carry its own data (static const) and compile
    with no includes beyond libc."""
    sys, param, st = fixture
    c_path = generate_c_solver(sys, param, formulation="laxMPC",
                               directory=str(tmp_path), **OPTS)
    src = open(c_path).read()
    assert "static const double ALPHA" in src
    assert "static const double BETAINV" in src
    for inc in ("math.h", "string.h", "time.h"):
        assert f"#include <{inc}>" in src
    assert "extern" not in src


def test_clear_generated(fixture, tmp_path):
    sys, param, st = fixture
    d = str(tmp_path / "gen")
    generate_c_solver(sys, param, formulation="laxMPC", directory=d, **OPTS)
    assert os.path.isdir(d)
    clear_generated(d)
    assert not os.path.isdir(d)


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
def test_c_fista_solver_matches_torch(fixture, formulation, tmp_path):
    from spcies_tpu_torch.codegen import (generate_c_fista_solver,
                                          CompiledCFistaSolver)
    sys, param, st = fixture
    outdir = str(tmp_path)
    p = dict(param)
    if formulation == "equMPC":
        p.pop("T")
    opts = dict(tol=1e-7, k_max=5000)
    generate_c_fista_solver(sys, p, formulation=formulation,
                            directory=outdir, **opts)
    s = _dense(sys, p, formulation=formulation, method="FISTA", **opts)
    c = CompiledCFistaSolver(f"{formulation.lower()}_fista", n=s.n, m=s.m,
                             N=s.N, nz=s.nz, directory=outdir)
    rng = np.random.default_rng(6)
    for trial in range(3):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "lam"))
        assert np.max(np.abs(u_c - r.u[0].numpy())) < 1e-10


def test_c_ellipmpc_solver_matches_torch(fixture, tmp_path):
    """ellipMPC-ADMM C backend against the port's dense solver with an
    ACTIVE terminal constraint (small r), so the projection branch runs."""
    sys, param, st = fixture
    outdir = str(tmp_path)
    p = dict(param)
    n = len(np.asarray(st["xr"]))
    rng = np.random.default_rng(11)
    M = rng.standard_normal((n, n))
    p["P"] = np.eye(n) + 0.1 * (M @ M.T)
    p["c"] = np.asarray(st["xr"])
    p["r"] = 0.05
    c_path = generate_c_solver(sys, p, formulation="ellipMPC",
                               directory=outdir, **OPTS)
    src = open(c_path).read()
    assert "PINVHALF" in src and "RADIUS" in src
    s = _dense(sys, p, formulation="ellipMPC", method="ADMM", **OPTS)
    c = CompiledCSolver("ellipmpc_admm", n=s.n, m=s.m, nz=s.nz,
                        directory=outdir)
    projected = 0
    for trial in range(3):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "v", "lam"))
        d = sol_c["v"][-s.n:] - p["c"]
        val = d @ (p["P"] @ d)
        assert val <= p["r"] ** 2 + 1e-8
        if val > 0.5 * p["r"] ** 2:
            projected += 1
    assert projected >= 1


def test_c_mpct_eadmm_solver_matches_torch(fixture, tmp_path):
    from spcies_tpu_torch.codegen import (generate_c_mpct_eadmm_solver,
                                          CompiledCMpctEadmmSolver)
    sys, param, st = fixture
    outdir = str(tmp_path)
    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    opts = dict(rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000)
    generate_c_mpct_eadmm_solver(sys, p, directory=outdir, **opts)
    s = _dense(sys, p, formulation="MPCT", method="EADMM", **opts)
    c = CompiledCMpctEadmmSolver("mpct_eadmm", n=s.n, m=s.m, N=s.N,
                                 directory=outdir)
    rng = np.random.default_rng(7)
    for trial in range(3):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z1", "z2", "z3", "lam"))
        assert np.max(np.abs(u_c - r.u[0].numpy())) < 1e-10


@pytest.mark.parametrize("use_soc", [False, True])
def test_c_hmpc_solver_matches_torch(fixture, use_soc, tmp_path):
    from spcies_tpu_torch.codegen import (generate_c_hmpc_solver,
                                          CompiledCHmpcSolver)
    sys, param, st = fixture
    outdir = str(tmp_path)
    p = dict(param)
    p.pop("T", None)
    p["w"] = 3 * 1.627 * 0.2
    p["Te"] = 10 * p["N"] * np.asarray(p["Q"])
    p["Th"] = p["Te"]
    p["Se"] = np.asarray(p["R"]).copy()
    p["Sh"] = 0.5 * p["Se"]
    opts = dict(rho=2.0, tol_p=1e-7, tol_d=1e-7, k_max=5000,
                use_soc=use_soc)
    name = f"hmpc_admm_{'soc' if use_soc else 'd'}"
    generate_c_hmpc_solver(sys, p, directory=outdir, save_name=name, **opts)
    s = _dense(sys, p, formulation="HMPC", method="ADMM", **opts)
    ing = s.ingredients
    c = CompiledCHmpcSolver(name, n=s.n, m=s.m, dim=ing["dim"],
                            n_s=ing["n_s"], directory=outdir)
    rng = np.random.default_rng(9)
    for trial in range(2):
        x0 = np.asarray(st["x"]) * rng.uniform(-2.0, 2.0)
        u_c, k_c, e_c, sol_c = c(x0, st["xr"], st["ur"])
        r = s(x0, st["xr"], st["ur"])
        assert e_c == int(r.e_flag[0]) == 1
        assert k_c == int(r.k[0])
        _compare(sol_c, r, ("z", "s", "lam"))
        assert np.max(np.abs(u_c - r.u[0].numpy())) < 1e-10


# ---------------------------------------------------------------------------
# the other codegen tests of the JAX suite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", DIMS[:2])
def test_fuzz_c_codegen_matches(n, m, seed, tmp_path):
    """Port of test_fuzz_differential.py::test_fuzz_c_codegen_matches:
    the generated C on a random plant against the port's dense solver."""
    sys, param, x0, xr, ur = _random_system(400 + seed, n, m)
    param = dict(param, T=2.0 * np.asarray(param["Q"]))
    opts = dict(rho=1.0, tol=1e-7, k_max=20000)
    d = str(tmp_path)
    generate_c_solver(sys, param, formulation="laxMPC", directory=d,
                      **opts)
    s = _dense(sys, param, formulation="laxMPC", method="ADMM", **opts)
    c = CompiledCSolver("laxmpc_admm", n=s.n, m=s.m, nz=s.nz, directory=d)
    u_c, k_c, e_c, sol_c = c(x0, xr, ur)
    r = s(x0, xr, ur)
    assert e_c == int(r.e_flag[0]) == 1
    assert k_c == int(r.k[0])
    assert np.max(np.abs(u_c - r.u[0].numpy())) < 1e-10


def test_sp_utils_parity():
    """Port of test_api_misc.py::test_sp_utils_parity (CSR/CSC round trips,
    sparse matvec, LDL factor and solve), each result also equal to the
    JAX package's helper's."""
    from spcies_tpu.utils import linalg as jlinalg
    from spcies_tpu_torch.utils import linalg
    rng = np.random.default_rng(11)
    M = rng.standard_normal((6, 8))
    M[np.abs(M) < 0.7] = 0.0
    val, col, ptr = linalg.full2csr(M)
    x = rng.standard_normal(8)
    np.testing.assert_allclose(linalg.csr_matvec(val, col, ptr, x), M @ x,
                               atol=1e-12)
    val_c, row_c, cptr = linalg.full2csc(M)
    val_t, col_t, ptr_t = linalg.full2csr(M.T)
    np.testing.assert_array_equal(val_c, val_t)
    np.testing.assert_array_equal(row_c, col_t)
    np.testing.assert_array_equal(cptr, ptr_t)
    for a, b in zip((val, col, ptr, val_c, row_c, cptr),
                    (*jlinalg.full2csr(M), *jlinalg.full2csc(M))):
        np.testing.assert_array_equal(a, b)

    A = rng.standard_normal((7, 7))
    W = A @ A.T + 7 * np.eye(7)
    L, d = linalg.ldl_factor(W)
    np.testing.assert_allclose(L @ np.diag(d) @ L.T, W, atol=1e-10)
    b = rng.standard_normal(7)
    np.testing.assert_allclose(linalg.ldl_solve(L, d, b),
                               np.linalg.solve(W, b), atol=1e-10)
    np.testing.assert_array_equal(linalg.ldl_solve(L, d, b),
                                  jlinalg.ldl_solve(L, d, b))


def test_problem_recipe_generate_c(tmp_path):
    """Port of test_api_misc.py::test_problem_recipe's generate_c arm."""
    sys, param, st = tsp.systems.tester_fixture()
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=500)
    prob = tsp.Problem(sys=dict(sys), param=dict(param), options=opt)
    c_path = prob.generate_c(directory=str(tmp_path), compile=False)
    assert c_path.endswith(".c") and os.path.exists(c_path)


def test_override_and_const_are_static_consumed(tmp_path):
    """Port of test_option_registry.py::
    test_override_and_const_are_static_consumed."""
    sys, param, st = tsp.systems.tester_fixture()
    from spcies_tpu_torch.codegen import generate_embedded_solver
    opt = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=100)
    opt.const_are_static = False
    generate_embedded_solver(sys, param, formulation="laxMPC",
                             method="ADMM", options=opt,
                             directory=str(tmp_path), save_name="ovr",
                             compile_mex=False)
    src = (tmp_path / "ovr.c").read_text()
    assert "static const" not in src and "const" in src
    opt2 = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                               k_max=100)
    opt2.override = False
    generate_embedded_solver(sys, param, formulation="laxMPC",
                             method="ADMM", options=opt2,
                             directory=str(tmp_path), save_name="ovr",
                             compile_mex=False)
    assert (tmp_path / "ovr_v2.c").exists()
