"""The dense laxMPC-ADMM engine of the PyTorch port (masked loop, delta
form, relaxation, genHist, straggler polish) against the JAX package's
dense engine in fp64 — same per-lane k and e_flag, iterates within 1e-9 —
plus ports of tests/test_laxmpc_admm.py."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import laxmpc_admm_oracle
from tests.golden.laxmpc_admm_golden import Z_OPT

import spcies_tpu_torch as tsp

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

SOLVER_OPTS = dict(rho=15.0, tol=1e-7, k_max=5000)  # test_laxMPC_ADMM.m:6-8


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    # the reference test diagonalizes the terminal cost
    # (tests/test_laxMPC_ADMM.m:15): T = diag(sum(T, 2))
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    return sys, param, status


def _pair(sys, param, precision="double", debug=0, **kw):
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("laxMPC", "ADMM", **kw)
        o.precision = precision
        o.debug = debug
        out.append(pkg.make_solver(sys, param, formulation="laxMPC",
                                   method="ADMM", options=o, **_on_cpu(pkg)))
    return out


def _batch(st, B, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-scale, scale, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _assert_parity(rj, rt, keys=("z", "v", "lam", "r_p", "r_d"), atol=1e-9):
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=atol)
    for key in keys:
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("relax_alpha", [1.0, 1.8])
@pytest.mark.parametrize("freeze", [True, False])
def test_dense_fp64_parity(fixture, relax_alpha, freeze):
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, relax_alpha=relax_alpha,
                     freeze_converged=freeze, **SOLVER_OPTS)
    x = _batch(st, 8, 0)
    _assert_parity(s_j(*x), s_t(*x))


def test_dense_fp64_parity_flagship():
    """The flagship configuration of the driver entry
    (__graft_entry__._flagship): raw tester fixture, rho 15, tol 1e-4."""
    sys, param, st = tsp.systems.tester_fixture()
    s_j, s_t = _pair(sys, param, rho=15.0, tol=1e-4, k_max=1000)
    x = _batch(st, 16, 0)
    _assert_parity(s_j(*x), s_t(*x))


def test_vs_oracle(fixture):
    """Same iterates as the dense numpy oracle to 1e-9, exact k."""
    sys, param, st = fixture
    _, s_t = _pair(sys, param, **SOLVER_OPTS)
    res = s_t(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = laxmpc_admm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **SOLVER_OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z", "v", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_vs_golden_optimum(fixture):
    """z* within 1e-4 of the reference's hardcoded optimum
    (tests/spcies_tester.m:261 tol_opt)."""
    sys, param, st = fixture
    _, s_t = _pair(sys, param, **SOLVER_OPTS)
    res = s_t(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z"][0].numpy() - Z_OPT)) <= 1e-4


def test_batched_masking_matches_solo(fixture):
    """Each lane of a heterogeneous batch matches its solo solve exactly
    (freeze-masked termination preserves per-lane k and iterates)."""
    sys, param, st = fixture
    _, s_t = _pair(sys, param, **SOLVER_OPTS)
    x0s, xr, ur = _batch(st, 5, 0)
    batched = s_t(x0s, xr, ur)
    ks = []
    for i in range(5):
        solo = s_t(x0s[i], st["xr"], st["ur"])
        ks.append(int(solo.k[0]))
        assert int(batched.k[i]) == int(solo.k[0])
        assert int(batched.e_flag[i]) == int(solo.e_flag[0])
        np.testing.assert_allclose(batched.sol["z"][i].numpy(),
                                   solo.sol["z"][0].numpy(), rtol=0,
                                   atol=1e-12)
    assert len(set(ks)) > 1, "test should cover heterogeneous exit"


def test_warm_start_reduces_iterations(fixture):
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, **SOLVER_OPTS)
    cold = s_t(st["x"], st["xr"], st["ur"])
    warm = s_t(st["x"], st["xr"], st["ur"],
               init=(cold.sol["z"], cold.sol["v"], cold.sol["lam"]))
    assert int(warm.k[0]) < int(cold.k[0])
    assert int(warm.e_flag[0]) == 1
    cold_j = s_j(st["x"], st["xr"], st["ur"])
    warm_j = s_j(st["x"], st["xr"], st["ur"],
                 init=(cold_j.sol["z"], cold_j.sol["v"], cold_j.sol["lam"]))
    _assert_parity(warm_j, warm)


def test_fixed_iters_mode(fixture):
    """Benchmark mode runs exactly k iterations without convergence
    checks, with the JAX engine's iterates."""
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, **SOLVER_OPTS)
    x = _batch(st, 4, 1)
    rt = s_t(*x, fixed_iters=50)
    assert np.all(rt.k.numpy() == 50)
    _assert_parity(s_j(*x, fixed_iters=50), rt)


def test_unconverged_flag(fixture):
    """k_max exhaustion returns e_flag = -1 with the current iterate
    (code_laxMPC_ADMM_C.c:622-631)."""
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, rho=15.0, tol=1e-12, k_max=10)
    rt = s_t(st["x"], st["xr"], st["ur"])
    assert int(rt.e_flag[0]) == -1
    assert int(rt.k[0]) == 10
    _assert_parity(s_j(st["x"], st["xr"], st["ur"]), rt)


@pytest.mark.parametrize("level", [1, 2])
def test_genhist_traces(fixture, level):
    """options.debug = 1/2 records residual (and full iterate) traces per
    iteration, frozen at each lane's exit — the JAX traces to 1e-9."""
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, debug=level, rho=15.0, tol=1e-4, k_max=200)
    x = _batch(st, 3, 2)
    rt, rj = s_t(*x), s_j(*x)
    keys = ("hRp", "hRd") + (("hZ", "hV", "hLam") if level == 2 else ())
    for key in keys:
        assert key in rt.sol, key
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
    assert ("hZ" in rt.sol) == (level == 2)
    if level == 2:
        hV = rt.sol["hV"][0].numpy()
        assert hV.shape == (200, s_t.nz)
        k = int(rt.k[0])
        np.testing.assert_array_equal(hV[k - 1], rt.sol["v"][0].numpy())


def test_genhist2_requires_freeze(fixture):
    sys, param, st = fixture
    o = tsp.default_options("laxMPC", "ADMM", rho=15.0,
                            freeze_converged=False)
    o.debug = 2
    s = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=o, device="cpu")
    with pytest.raises(ValueError, match="freeze_converged"):
        s(st["x"], st["xr"], st["ur"])


def test_bf16_delta_accuracy(fixture):
    """The bf16 delta path preserves iteration counts and meets 1e-4-class
    accuracy vs the fp64 solve."""
    sys, param, st = fixture
    o = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                            k_max=1000, bf16_delta=True)
    o.precision = "float"
    s_bf = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                           options=o, device="cpu")
    s_64 = tsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                           rho=15.0, tol=1e-4, k_max=1000, device="cpu")
    x = _batch(st, 16, 3)
    r_bf, r_64 = s_bf(*x), s_64(*x)
    assert np.all(r_bf.e_flag.numpy() == 1)
    k_bf, k_64 = r_bf.k.numpy().astype(float), r_64.k.numpy().astype(float)
    assert np.max(np.abs(k_bf - k_64) / k_64) < 0.25
    assert np.max(np.abs(r_bf.u.numpy() - r_64.u.numpy())) < 5e-4


def test_over_relaxation(fixture):
    """relax_alpha != 1 reaches the same optimum in fewer iterations."""
    sys, param, st = fixture
    _, s_plain = _pair(sys, param, rho=15.0, tol=1e-6, k_max=5000)
    _, s_relax = _pair(sys, param, rho=15.0, tol=1e-6, k_max=5000,
                       relax_alpha=1.8)
    rp = s_plain(st["x"], st["xr"], st["ur"])
    rr = s_relax(st["x"], st["xr"], st["ur"])
    assert int(rp.e_flag[0]) == int(rr.e_flag[0]) == 1
    assert int(rr.k[0]) < int(rp.k[0])
    assert np.max(np.abs(rr.u[0].numpy() - rp.u[0].numpy())) < 1e-5


def test_straggler_polish_fixes_fp32_floor():
    """A mid-transient state whose fp32 iteration floors max|z - v| just
    above tol=1e-4 (captured on the bench problem, full dlqr T): with
    straggler_polish, lanes that exhaust k_max continue in compensated
    f32x2 and converge; already-converged lanes are untouched."""
    sys, param, st = tsp.systems.tester_fixture()
    p30 = dict(param)
    p30["N"] = 30
    x_hard = np.array([0.18785244226455688, 0.28975582122802734,
                       0.1878533512353897, 0.19296741485595703,
                       0.12776263058185577, 0.1929691731929779])
    xb = np.stack([np.asarray(st["x"]), x_hard])
    xr = np.tile(st["xr"], (2, 1))
    ur = np.tile(st["ur"], (2, 1))

    def solve(polish):
        o = tsp.default_options("laxMPC", "ADMM", rho=10.0, tol=1e-4,
                                k_max=1000, relax_alpha=1.9,
                                straggler_polish=polish)
        o.precision = "float"
        s = tsp.make_solver(sys, p30, formulation="laxMPC", method="ADMM",
                            options=o, device="cpu")
        return s(xb, xr, ur)

    r0 = solve(0)
    assert int(r0.e_flag[1]) == -1          # the floor, reproduced
    assert int(r0.e_flag[0]) == 1
    r1 = solve(2000)
    assert int(r1.e_flag[1]) == 1           # polished lane converges
    assert int(r1.k[1]) > 1000              # counted total iterations
    assert float(r1.sol["r_p"][1]) <= 1e-4
    assert int(r1.k[0]) == int(r0.k[0])
    np.testing.assert_array_equal(r1.sol["z"][0].numpy(),
                                  r0.sol["z"][0].numpy())
    np.testing.assert_array_equal(r1.sol["lam"][0].numpy(),
                                  r0.sol["lam"][0].numpy())


def test_straggler_polish_continues_exact_recursion(fixture):
    """The compensated continuation consumes the PREPARED iterate z_next:
    a polished run from a tiny k_max lands on the same solution and the
    same total k as one uninterrupted long run (fp64), and on the JAX
    package's polished result."""
    sys, param, st = fixture
    x = _batch(st, 4, 3)

    def solve(pkg, k_max, polish):
        s = pkg.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                            rho=15.0, tol=1e-9, k_max=k_max,
                            straggler_polish=polish, **_on_cpu(pkg))
        return s(*x)

    ref = solve(tsp, 20000, 0)
    pol = solve(tsp, 50, 20000)
    assert np.all(pol.e_flag.numpy() == 1)
    np.testing.assert_allclose(pol.sol["z"].numpy(), ref.sol["z"].numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(pol.k.numpy(), ref.k.numpy())
    _assert_parity(solve(jsp, 50, 20000), pol)


def test_polish_with_history_mirrors_reference(fixture):
    """Mirrored reference behaviour (spcies_tpu/solvers/admm.py:163): with
    straggler_polish and genHist together, polished lanes report k past
    k_max while the traces stay sized [B, k_max]."""
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, debug=1, rho=15.0, tol=1e-9, k_max=50,
                     straggler_polish=20000)
    x = _batch(st, 2, 4)
    rt, rj = s_t(*x), s_j(*x)
    assert np.all(rt.k.numpy() > 50)
    assert tuple(rt.sol["hRp"].shape) == (2, 50)
    _assert_parity(rj, rt)
