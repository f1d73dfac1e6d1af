"""The closed-loop rollout of the PyTorch port (spcies_tpu_torch.runtime)
on the CPU: the seven tests of tests/test_rollout.py on device="cpu"; the
JAX package's rollout in fp64 (per-step, per-lane k and e_flag equal,
trajectories within 1e-9) cold, carried and shifted; the fused fp32
rollout (the plain version of the box-ADMM kernel on CPU tensors) against
a host loop of the same solver's requests, bit for bit; step 0's zero
iterates against init=None; and the refusals (warm starts of another
shape, the shift at N < 2)."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.runtime import closed_loop_rollout as jax_rollout

import spcies_tpu_torch as tsp
from spcies_tpu_torch.runtime import (closed_loop_rollout, shift_dual_stages,
                                      shift_stagewise)

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


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    return sys, param, status


def _plant(sys):
    return np.asarray(sys["A"]), np.asarray(sys["B"])


def _x0s(st, B, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))


def test_rollout_regulates_and_matches_host_loop(fixture):
    sys, param, st = fixture
    solver = tsp.make_solver(sys, param, formulation="laxMPC",
                             method="ADMM", rho=15.0, tol=1e-9, k_max=5000,
                             device="cpu")
    A, B = _plant(sys)
    x0 = np.stack([np.asarray(st["x"]), 0.5 * np.asarray(st["x"])])
    n_steps = 30

    out = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                              n_steps=n_steps, warm_start=False)
    assert tuple(out["xs"].shape) == (n_steps + 1, 2, A.shape[0])
    assert tuple(out["us"].shape) == (n_steps, 2, B.shape[1])
    assert bool(torch.all(out["e_flags"] == 1))

    # converges toward the consistent steady state (xr, ur) of the fixture
    xr = np.asarray(st["xr"])
    err0 = np.max(np.abs(out["xs"][0].numpy() - xr))
    errT = np.max(np.abs(out["xs"][-1].numpy() - xr))
    assert errT < 0.2 * err0

    # cold-start rollout == host-driven loop of individual solves
    x = np.array(x0, float)
    for t in range(n_steps):
        u = solver(x, st["xr"], st["ur"]).u.numpy()
        np.testing.assert_allclose(u, out["us"][t].numpy(), rtol=0,
                                   atol=1e-12)
        x = x @ A.T + u @ B.T
        np.testing.assert_allclose(x, out["xs"][t + 1].numpy(), rtol=0,
                                   atol=1e-12)


def test_warm_start_saves_iterations(fixture):
    sys, param, st = fixture
    solver = tsp.make_solver(sys, param, formulation="laxMPC",
                             method="ADMM", rho=15.0, tol=1e-7, k_max=5000,
                             device="cpu")
    A, B = _plant(sys)
    cold = closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                               n_steps=10, warm_start=False)
    warm = closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                               n_steps=10, warm_start=True)
    assert int(warm["ks"][1:].sum()) < int(cold["ks"][1:].sum())
    assert bool(torch.all(warm["e_flags"] == 1))
    # warm start changes the iterate path, not the solution
    np.testing.assert_allclose(warm["xs"].numpy(), cold["xs"].numpy(),
                               rtol=0, atol=1e-4)


def _bench_solver(sys, param, form="laxMPC", **kw):
    """The bench's closed-loop settings (bench.py:388-445) at N=30."""
    p = dict(param, N=30)
    if form == "equMPC":
        p.pop("T")
        kw = dict(dict(rho=2.0, tol=1e-4, k_max=5000), **kw)
    else:
        kw = dict(dict(rho=10.0, tol=1e-4, k_max=2000, relax_alpha=1.9),
                  **kw)
    return tsp.make_solver(sys, p, formulation=form, method="ADMM",
                           device="cpu", **kw)


def test_shift_warm_start_beats_carry(fixture):
    """warm_start='shift' needs at least 30 % fewer iterations than cold
    after step 0 at the serving tolerance, and reaches the same
    trajectory."""
    sys, param, st = fixture
    solver = _bench_solver(sys, param)
    A, B = _plant(sys)
    x0 = 2.0 * np.asarray(st["x"])
    cold = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                               n_steps=8, warm_start=False)
    shift = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                                n_steps=8, warm_start="shift")
    k_cold, k_shift = int(cold["ks"][1:].sum()), int(shift["ks"][1:].sum())
    assert k_shift < 0.7 * k_cold, (k_shift, k_cold)
    assert bool(torch.all(shift["e_flags"] == 1))
    np.testing.assert_allclose(shift["xs"].numpy(), cold["xs"].numpy(),
                               rtol=0, atol=1e-3)


def test_shift_warm_start_equmpc(fixture):
    """The shift handles the no-terminal-block layout (equMPC) too."""
    sys, param, st = fixture
    solver = _bench_solver(sys, param, form="equMPC")
    A, B = _plant(sys)
    x0 = 2.0 * np.asarray(st["x"])
    cold = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                               n_steps=8, warm_start=False)
    shift = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                                n_steps=8, warm_start="shift")
    assert int(shift["ks"][1:].sum()) < 0.7 * int(cold["ks"][1:].sum())
    assert bool(torch.all(shift["e_flags"] == 1))


def _mpct_param(param):
    p = dict(param)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    return p


def test_shift_warm_start_unsupported_layout_raises(fixture):
    """A solver whose warm start the rollout carries but whose decision
    vector is not stagewise (MPCT-ADMM-cs) refuses 'shift' with a typed
    error instead of mis-shifting."""
    sys, param, st = fixture
    solver = tsp.make_solver(sys, _mpct_param(param), formulation="MPCT",
                             method="ADMM", submethod="cs", tol=1e-5,
                             k_max=2000, device="cpu")
    A, B = _plant(sys)
    with pytest.raises(ValueError, match="stagewise"):
        closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                            n_steps=3, warm_start="shift")


def test_rollout_fista_dual_warm_start(fixture):
    sys, param, st = fixture
    solver = tsp.make_solver(sys, param, formulation="laxMPC",
                             method="FISTA", tol=1e-7, k_max=5000,
                             device="cpu")
    A, B = _plant(sys)
    out = closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                              n_steps=30, warm_start=True)
    assert bool(torch.all(out["e_flags"] == 1))
    xr = np.asarray(st["xr"])
    errT = np.max(np.abs(out["xs"][-1].numpy() - xr))
    err0 = np.max(np.abs(out["xs"][0].numpy() - xr))
    assert errT < 0.2 * err0


def test_rollout_process_noise_shape(fixture):
    sys, param, st = fixture
    solver = tsp.make_solver(sys, param, formulation="laxMPC",
                             method="ADMM", rho=15.0, tol=1e-6, k_max=2000,
                             device="cpu")
    A, B = _plant(sys)
    rng = np.random.default_rng(0)
    noise = 1e-3 * rng.standard_normal((5, 1, A.shape[0]))
    out = closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                              n_steps=5, process_noise=noise)
    # propagation includes the disturbance exactly
    x1 = (out["xs"][0].numpy() @ A.T + out["us"][0].numpy() @ B.T
          + noise[0])
    np.testing.assert_allclose(out["xs"][1].numpy(), x1, rtol=0, atol=1e-12)


@pytest.mark.parametrize("warm_start", [False, True, "shift"])
@pytest.mark.parametrize("form", ["laxMPC", "equMPC"])
def test_dense_fp64_matches_jax_rollout(fixture, form, warm_start):
    """The port's fp64 dense rollout gives the JAX package's per-step,
    per-lane k and e_flag, and its trajectories within 1e-9."""
    sys, param, st = fixture
    p = dict(param)
    if form == "equMPC":
        p.pop("T")
    kw = dict(rho=10.0, tol=1e-6, k_max=2000, relax_alpha=1.6)
    s_j = jsp.make_solver(sys, p, formulation=form, method="ADMM", **kw)
    s_t = tsp.make_solver(sys, p, formulation=form, method="ADMM",
                          device="cpu", **kw)
    A, B = _plant(sys)
    x0 = _x0s(st, 4, 0)
    args = (A, B, x0, st["xr"], st["ur"])
    oj = jax_rollout(s_j, *args, n_steps=6, warm_start=warm_start)
    ot = closed_loop_rollout(s_t, *args, n_steps=6, warm_start=warm_start)
    np.testing.assert_array_equal(ot["ks"].numpy(), np.asarray(oj["ks"]))
    np.testing.assert_array_equal(ot["e_flags"].numpy(),
                                  np.asarray(oj["e_flags"]))
    for key in ("xs", "us"):
        np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]),
                                   rtol=0, atol=1e-9, err_msg=key)


def _fused_bench_solver(sys, param):
    """laxMPC-ADMM at the bench's closed-loop settings on the fused backend
    in fp32, exact-k: on CPU tensors the kernel's plain version runs."""
    o = tsp.default_options("laxMPC", "ADMM", rho=10.0, tol=1e-4,
                            k_max=1000, relax_alpha=1.9, tile_b=8,
                            check_every=16, exact_k=True)
    o.precision = "float"
    return tsp.make_solver(sys, dict(param, N=30), formulation="laxMPC",
                           method="ADMM", options=o, backend="fused",
                           device="cpu")


@pytest.mark.parametrize("warm_start", [True, "shift"])
def test_fused_rollout_matches_host_loop(fixture, warm_start):
    """The fused fp32 rollout is a host loop of the same solver's requests
    with the same (shifted) inits, bit for bit."""
    sys, param, st = fixture
    solver = _fused_bench_solver(sys, param)
    A, B = _plant(sys)
    x0 = _x0s(st, 8, 1)
    out = closed_loop_rollout(solver, A, B, x0, st["xr"], st["ur"],
                              n_steps=4, warm_start=warm_start)
    assert bool(torch.all(out["e_flags"] == 1))
    At, Bt = (torch.as_tensor(a, dtype=torch.float32) for a in (A, B))
    x = torch.as_tensor(x0, dtype=torch.float32)
    init = None
    for t in range(4):
        res = solver(x, st["xr"], st["ur"], init=init)
        x = x @ At.T + res.u @ Bt.T
        assert torch.equal(res.u, out["us"][t])
        assert torch.equal(x, out["xs"][t + 1])
        assert torch.equal(res.k, out["ks"][t])
        keys = ("z", "v", "lam")
        if warm_start == "shift":
            init = tuple(shift_stagewise(res.sol[k], solver.n, solver.m,
                                         solver.N, terminal=True)
                         for k in keys)
        else:
            init = tuple(res.sol[k] for k in keys)
    # the shifted carry saves iterations after step 0
    if warm_start == "shift":
        assert float(out["ks"][1:].float().mean()) < 0.7 * float(
            out["ks"][0].float().mean())


def _zero_init(res):
    keys = ("z", "v", "lam") if "v" in res.sol else ("lam",) * 3
    return tuple(torch.zeros_like(res.sol[k]) for k in keys)


@pytest.mark.parametrize("kind", ["dense-admm", "fused-admm", "dense-fista"])
def test_zero_init_matches_none(fixture, kind):
    """Step 0 runs with init=None; the JAX package passes zero iterates
    (its init0). Both give the same bits."""
    sys, param, st = fixture
    if kind == "fused-admm":
        solver = _fused_bench_solver(sys, param)
    else:
        method = "ADMM" if kind == "dense-admm" else "FISTA"
        solver = tsp.make_solver(sys, param, formulation="laxMPC",
                                 method=method, tol=1e-6, k_max=2000,
                                 device="cpu")
    x = (_x0s(st, 8, 2), st["xr"], st["ur"])
    none = solver(*x)
    zero = solver(*x, init=_zero_init(none))
    assert torch.equal(none.u, zero.u) and torch.equal(none.k, zero.k)
    for key, val in none.sol.items():
        if key != "times_ms":       # the request's phase times
            assert torch.equal(val, zero.sol[key]), key


def _soc_param(param):
    p = dict(param)
    p["P"] = np.eye(np.asarray(p["Q"]).shape[0])
    p["c"] = np.zeros(p["P"].shape[0])
    p["r"] = 0.5
    return p


@pytest.mark.parametrize("family", ["MPCT-EADMM", "ellipMPC-ADMM-soc"])
def test_warm_start_of_another_shape_is_refused(fixture, family):
    """MPCT-EADMM warm-starts from (z1, z2, z3, lam) and ellipMPC-ADMM-soc
    from (z, s, lam, mu): the rollout carries neither, and says so."""
    sys, param, st = fixture
    if family == "MPCT-EADMM":
        solver = tsp.make_solver(sys, _mpct_param(param),
                                 formulation="MPCT", method="EADMM",
                                 tol=1e-5, k_max=2000, device="cpu")
    else:
        solver = tsp.make_solver(sys, _soc_param(param),
                                 formulation="ellipMPC", method="ADMM",
                                 submethod="soc", device="cpu")
    A, B = _plant(sys)
    for ws in (True, "shift"):
        with pytest.raises(ValueError, match="warm start of .*laxMPC-ADMM"):
            closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                                n_steps=2, warm_start=ws)


def test_cold_rollout_runs_a_family_it_does_not_carry(fixture):
    """Cold start runs every solver of the plain (x0, xr, ur) signature:
    MPCT-EADMM regulates toward the reference."""
    sys, param, st = fixture
    solver = tsp.make_solver(sys, _mpct_param(param), formulation="MPCT",
                             method="EADMM", tol=1e-5, k_max=5000,
                             device="cpu")
    A, B = _plant(sys)
    out = closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                              n_steps=3, warm_start=False)
    assert bool(torch.all(out["e_flags"] == 1))
    assert tuple(out["xs"].shape) == (4, 1, A.shape[0])


def test_shift_needs_two_stages(fixture):
    """The stagewise shift misaligns at N < 2 in the JAX package; the port
    refuses it, before any solve."""
    sys, param, st = fixture
    solver = tsp.make_solver(sys, dict(param, N=1), formulation="laxMPC",
                             method="ADMM", tol=1e-6, k_max=500,
                             device="cpu")
    A, B = _plant(sys)
    with pytest.raises(ValueError, match="at least 2 stages"):
        closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                            n_steps=2, warm_start="shift")
    with pytest.raises(ValueError, match="N=1"):
        shift_stagewise(torch.zeros((1, solver.nz)), solver.n, solver.m, 1,
                        terminal=True)
    # the carry and the cold start run at N=1
    for ws in (False, True):
        out = closed_loop_rollout(solver, A, B, st["x"], st["xr"], st["ur"],
                                  n_steps=2, warm_start=ws)
        assert bool(torch.all(out["e_flags"] == 1))


def test_dual_shift_and_arguments(fixture):
    lam = torch.arange(12.0).reshape(1, 12)
    assert shift_dual_stages(lam, 3, 4).tolist() == [
        [3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 9.0, 10.0, 11.0]]
    sys, param, st = fixture
    solver = tsp.make_solver(sys, param, formulation="laxMPC",
                             method="ADMM", device="cpu")
    with pytest.raises(ValueError, match="warm_start"):
        closed_loop_rollout(solver, *_plant(sys), st["x"], st["xr"],
                            st["ur"], n_steps=1, warm_start="both")
