"""MPCT-EADMM in the PyTorch port: ports of tests/test_mpct_eadmm.py (golden
optimum, numpy oracle, artificial reference, batched masking, rho override,
and the fused backend against the dense engine, with check_every, exact-k
and the fp32 requirement), the JAX dense engine's k and iterates in fp64,
the debug traces, and error probes."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.oracle import mpct_eadmm_oracle
from tests.golden.mpct_eadmm_golden import Z1_OPT

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import fused_eadmm as fk

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

OPTS = dict(rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000)


@pytest.fixture(scope="module")
def fixture():
    sys, param, status = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = 10.0 * np.asarray(param["Q"])   # test_MPCT_EADMM.m:14
    param["S"] = np.asarray(param["R"]).copy()   # test_MPCT_EADMM.m:15
    return sys, param, status


@pytest.fixture(scope="module")
def solver(fixture):
    sys, param, _ = fixture
    return tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                           **OPTS, device="cpu")


def _batch(st, B, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-scale, scale, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def test_vs_golden(solver, fixture):
    _, _, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    assert int(res.e_flag[0]) == 1
    assert np.max(np.abs(res.sol["z1"][0].numpy() - Z1_OPT)) <= 1e-4


def test_vs_oracle(solver, fixture):
    sys, param, st = fixture
    res = solver(st["x"], st["xr"], st["ur"])
    u_o, k_o, e_o, sol_o = mpct_eadmm_oracle(
        sys, param, st["x"], st["xr"], st["ur"], **OPTS)
    assert int(res.e_flag[0]) == e_o == 1
    assert int(res.k[0]) == k_o
    for key in ("z1", "z2", "z3", "lam"):
        assert np.max(np.abs(res.sol[key][0].numpy() - sol_o[key])) < 1e-9
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_artificial_reference_is_steady_state(solver, fixture):
    """(x_s, u_s) = z2 satisfies x_s = A x_s + B u_s at convergence."""
    sys, _, st = fixture
    z2 = solver(st["x"], st["xr"], st["ur"]).sol["z2"][0].numpy()
    n = solver.n
    resid = np.asarray(sys["A"]) @ z2[:n] + np.asarray(sys["B"]) @ z2[n:] \
        - z2[:n]
    assert np.max(np.abs(resid)) < 1e-6


def test_batched_masking(solver, fixture):
    _, _, st = fixture
    x0s, xr, ur = _batch(st, 4, 7)
    batched = solver(x0s, xr, ur)
    for i in range(4):
        solo = solver(x0s[i], st["xr"], st["ur"])
        assert int(batched.k[i]) == int(solo.k[0])
        np.testing.assert_allclose(batched.sol["z1"][i].numpy(),
                                   solo.sol["z1"][0].numpy(), rtol=0,
                                   atol=1e-12)


def test_rho_scalar_override(fixture):
    """rho= collapses to rho_base=rho, rho_mult=1
    (compute_MPCT_EADMM_ingredients.m:76-79)."""
    sys, param, st = fixture
    s = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                        rho=2.0, tol=1e-5, k_max=5000, device="cpu")
    assert np.all(s.ingredients["rho"] == 2.0)
    res = s(st["x"], st["xr"], st["ur"])
    u_o, k_o, _, _ = mpct_eadmm_oracle(
        sys, param, st["x"], st["xr"], st["ur"],
        rho_base=2.0, rho_mult=1.0, tol=1e-5, k_max=5000)
    assert int(res.k[0]) == k_o
    assert np.max(np.abs(res.u[0].numpy() - u_o)) < 1e-9


def test_dense_fp64_parity(fixture):
    """The JAX dense engine's per-lane k and e_flag, iterates within 1e-9,
    warm start included."""
    sys, param, st = fixture
    s_j, s_t = (pkg.make_solver(sys, param, formulation="MPCT",
                                method="EADMM", **OPTS, **_on_cpu(pkg))
                for pkg in (jsp, tsp))
    x = _batch(st, 8, 2)
    keys = ("z1", "z2", "z3", "lam", "r_pf", "r_z2", "r_z3")

    def parity(rj, rt):
        np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
        np.testing.assert_array_equal(rt.e_flag.numpy(),
                                      np.asarray(rj.e_flag))
        for key in keys:
            np.testing.assert_allclose(rt.sol[key].numpy(),
                                       np.asarray(rj.sol[key]), rtol=0,
                                       atol=1e-9, err_msg=key)

    rt, rj = s_t(*x), s_j(*x)
    parity(rj, rt)
    # a warm start from a looser solve
    loose = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                            **dict(OPTS, tol=1e-3), device="cpu")(*x)
    init = tuple(loose.sol[key] for key in ("z1", "z2", "z3", "lam"))
    warm_t = s_t(*x, init=init)
    assert np.all(warm_t.k.numpy() < rt.k.numpy())
    parity(s_j(*x, init=tuple(a.numpy() for a in init)), warm_t)


@pytest.mark.parametrize("debug", [1, 2])
def test_debug_traces_and_fixed_iters(fixture, debug):
    """genHist traces hRpf/hRz2/hRz3 and fixed_iters, as the JAX dense
    engine records them."""
    sys, param, st = fixture
    out = []
    for pkg in (jsp, tsp):
        o = pkg.default_options("MPCT", "EADMM", **dict(OPTS, k_max=400))
        o.debug = debug
        out.append(pkg.make_solver(sys, param, formulation="MPCT",
                                   method="EADMM", options=o, **_on_cpu(pkg))(
            *_batch(st, 3, 3)))
    rj, rt = out
    for key in ("hRpf", "hRz2", "hRz3"):
        assert tuple(rt.sol[key].shape) == (3, 400)
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
    s = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                        **OPTS, device="cpu")
    r = s(*_batch(st, 3, 3), fixed_iters=7)
    assert np.all(r.k.numpy() == 7) and np.all(r.e_flag.numpy() == 1)
    np.testing.assert_allclose(r.sol["r_pf"].numpy(),
                               rt.sol["hRpf"][:, 6].numpy(), rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# fused backend (kernels/fused_eadmm.py; on the CPU its plain version)
# ---------------------------------------------------------------------------

FUSED_KW = dict(rho_base=2.0, rho_mult=20.0, tol=1e-5, k_max=3000)


def _solver(sys, param, backend, **kw):
    o = tsp.default_options("MPCT", "EADMM", tile_b=8, **{**FUSED_KW, **kw})
    o.precision = "float"
    return tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                           backend=backend, options=o, device="cpu")


def test_fused_matches_dense(fixture):
    """The fused backend against the fp32 dense engine: per-lane k within
    5 (the fused C2m/C2t fold contracts in another order than the dense
    couple()/a2t chain, so exits at the tolerance boundary may shift by a
    few iterations) and fp32-roundoff iterates, as
    tests/test_mpct_eadmm.py:101 holds the JAX kernel; a warm start from
    the dense solution exits within 20 iterations."""
    sys, param, st = fixture
    s_f, s_d = (_solver(sys, param, be) for be in ("fused", "dense"))
    x = _batch(st, 8, 21, scale=1.5)
    rf, rd = s_f(*x), s_d(*x)
    assert np.all(rf.e_flag.numpy() == 1)
    assert np.max(np.abs(rf.k.numpy().astype(np.int64)
                         - rd.k.numpy().astype(np.int64))) <= 5
    for key in ("z1", "z2", "z3"):
        gap = np.max(np.abs(rf.sol[key].numpy() - rd.sol[key].numpy()))
        assert gap < 25 * 1e-5, (key, gap)
    gap = np.max(np.abs(rf.sol["lam"].numpy() - rd.sol["lam"].numpy()))
    assert gap < 100 * 1e-5, ("lam", gap)
    assert np.max(np.abs(rf.u.numpy() - rd.u.numpy())) < 25 * 1e-5
    rws = s_f(*x, init=tuple(rd.sol[key] for key in ("z1", "z2", "z3",
                                                      "lam")))
    assert int(rws.k.max()) <= 20


def test_fused_check_every(fixture):
    """check_every > 1 free-runs windows: every lane converges, k at window
    granularity (>= dense k - 5), u within 25e-5 of the dense engine."""
    sys, param, st = fixture
    s_f = _solver(sys, param, "fused", check_every=4)
    s_d = _solver(sys, param, "dense")
    x = _batch(st, 8, 22, scale=1.5)
    rf, rd = s_f(*x), s_d(*x)
    assert np.all(rf.e_flag.numpy() == 1)
    assert np.all(rf.k.numpy() % 4 == 0)
    assert np.all(rf.k.numpy().astype(np.int64)
                  >= rd.k.numpy().astype(np.int64) - 5)
    assert np.max(np.abs(rf.u.numpy() - rd.u.numpy())) < 25 * 1e-5


def test_fused_exact_k_bit_identical(fixture):
    """exact_k: bit-identical to the checked mode (snapshot + replay),
    including the k_max-capped path."""
    sys, param, st = fixture
    x = _batch(st, 8, 23)
    for kw in ({}, dict(tol=1e-13, k_max=19)):
        r1 = _solver(sys, param, "fused", **kw)(*x)
        r2 = _solver(sys, param, "fused", check_every=8, exact_k=True,
                     **kw)(*x)
        assert torch.equal(r1.k, r2.k) and torch.equal(r1.e_flag, r2.e_flag)
        for key in ("z1", "z2", "z3", "lam", "r_pf", "r_z2", "r_z3"):
            assert torch.equal(r1.sol[key], r2.sol[key]), key


def test_fused_batch_padding_and_no_launch(fixture):
    """A batch that is not a multiple of tile_b is padded and sliced; on
    the CPU the fused solver launches nothing."""
    sys, param, st = fixture
    s_f = _solver(sys, param, "fused", check_every=8, exact_k=True)
    before = fk.fused_eadmm_solve.launches
    r5 = s_f(*_batch(st, 5, 1))
    assert fk.fused_eadmm_solve.launches == before
    assert tuple(r5.u.shape) == (5, 2)
    assert tuple(r5.sol["lam"].shape) == (5, s_f.ingredients["nrow"])
    r8 = s_f(*_batch(st, 8, 1))
    for key in ("z1", "lam"):
        torch.testing.assert_close(r5.sol[key], r8.sol[key][:5], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("probe,exc,match", [
    (dict(backend="fused", precision="double"), ValueError, "fp32"),
    (dict(backend="fused", fixed_iters=5), ValueError, "fixed_iters"),
    (dict(backend="banded"), ValueError, "dense and fused"),
    (dict(backend="fused", debug=1), ValueError, "genHist"),
])
def test_error_probes(fixture, probe, exc, match):
    sys, param, st = fixture
    probe = dict(probe)
    o = tsp.default_options("MPCT", "EADMM", **FUSED_KW)
    o.precision = probe.pop("precision", "float")
    o.debug = probe.pop("debug", 0)
    fixed = probe.pop("fixed_iters", None)
    with pytest.raises(exc, match=match):
        s = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                            options=o, **probe, device="cpu")
        s(*_batch(st, 8, 0), fixed_iters=fixed)
