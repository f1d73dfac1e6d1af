"""The fused dual-FISTA kernel's plain PyTorch version (the path CPU tensors
take through kernels/fused_fista.py) against the JAX package's fused
backend run in Pallas interpret mode, mode for mode — the ten cases of
tests/test_fused_fista.py — and against the JAX dense engine in fp64;
plus the wrapper's dispatch, validation and build plumbing, which need no
GPU."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import _build
from spcies_tpu_torch.kernels import fused_fista as fk

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

# fp32 iterates: the two frameworks sum the products in different orders,
# and each iteration adds about one fp32 ulp to the gap between the runs.
# On this fixture max|dz| reaches 2.4e-6 after at most 108 iterations, so z
# and res are held to 1e-5, or 2e-7 per iteration run where that is more.
# lam's entries reach 23 here (z's stay below 3), and its ulp grows with
# it: lam is held to that bound times max(1, max|lam|).
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7


@pytest.fixture(scope="module")
def fixture():
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(np.asarray(param["T"]), axis=1))
    return sys, param, st


def _param(param, formulation):
    if formulation == "equMPC":
        param = dict(param)
        param.pop("T", None)
    return param


def _fused_pair(formulation, sys, param, tol=1e-5, k_max=3000, **kw):
    """(JAX fused in interpret mode, port fused) at fp32."""
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options(formulation, "FISTA", tol=tol, k_max=k_max,
                                tile_b=kw.pop("tile_b", 8), **extra, **kw)
        o.precision = "float"
        out.append(pkg.make_solver(sys, _param(param, formulation),
                                   formulation=formulation, method="FISTA",
                                   backend="fused", options=o, **_on_cpu(pkg)))
    return out


def _dense(pkg, formulation, sys, param, precision="float", tol=1e-5,
           k_max=3000, **kw):
    o = pkg.default_options(formulation, "FISTA", tol=tol, k_max=k_max, **kw)
    o.precision = precision
    return pkg.make_solver(sys, _param(param, formulation),
                           formulation=formulation, method="FISTA",
                           options=o, **_on_cpu(pkg))


def _data(st, B, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _assert_parity(rj, rt, iters, moved=()):
    """k and e_flag exactly, iterates within the drift bound above after
    `iters` iterations. Lanes in `moved` may end one iteration apart; they
    are held to k within one and u within 1e-4, the solution's accuracy at
    tol 1e-5."""
    kj, kt = np.asarray(rj.k), rt.k.numpy()
    same = np.ones(kj.shape, bool)
    same[list(moved)] = False
    np.testing.assert_array_equal(kt[same], kj[same])
    assert np.all(np.abs(kt - kj) <= 1)
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    atol = max(ATOL_FP32, ATOL_PER_ITER * iters)
    lam_scale = max(1.0, float(np.abs(np.asarray(rj.sol["lam"])).max()))
    for key, tol in (("z", atol), ("res", atol), ("lam", atol * lam_scale)):
        np.testing.assert_allclose(rt.sol[key].numpy()[same],
                                   np.asarray(rj.sol[key])[same], rtol=0,
                                   atol=tol, err_msg=key)
    np.testing.assert_allclose(rt.u.numpy()[same], np.asarray(rj.u)[same],
                               rtol=0, atol=atol)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-4)


def _iters(res, check_every=1):
    """Iterations a run made: the last lane's k plus one window."""
    return int(res.k.max()) + check_every


# laxMPC with restart: the restart test res > res_prev compares two nearly
# equal residuals on these lanes, and the sum-order gap between the
# frameworks flips it, so the lane's exit moves by one iteration
# (B=8, seed 0: lane 2; seed 3: lane 0). equMPC and restart off agree on
# every lane.
MOVED = {("laxMPC", True, 0): (2,), ("laxMPC", True, 3): (0,)}


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
@pytest.mark.parametrize("restart", [False, True])
def test_fused_fista_matches_jax(fixture, formulation, restart):
    """Checked mode against the JAX fused kernel, which in turn equals the
    JAX dense engine bit for bit (tests/test_fused_fista.py:44)."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair(formulation, sys, param, restart=restart)
    x = _data(st, 8)
    rt = s_t(*x)
    _assert_parity(s_j(*x), rt, _iters(rt),
                   MOVED.get((formulation, restart, 0), ()))
    # the port's own dense engine runs the same recursion
    rd = _dense(tsp, formulation, sys, param, restart=restart)(*x)
    assert torch.equal(rd.k, rt.k)


def test_fused_fista_check_every(fixture):
    """Free-running mode: k at check granularity, equal to the JAX fused
    kernel's; it converges to the same tolerance, k_fused >= k_dense (the
    residual sequence is identical before convergence, so the first tested
    crossing comes at or after the dense one), u within 1e-4 of dense."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair("laxMPC", sys, param, check_every=4)
    x = _data(st, 8, seed=3)
    rt = s_t(*x)
    _assert_parity(s_j(*x), rt, _iters(rt, 4))
    rd = _dense(tsp, "laxMPC", sys, param)(*x)
    assert np.all(rt.e_flag.numpy() == 1)
    assert np.all(rt.k.numpy() >= rd.k.numpy())
    assert np.all(rt.k.numpy() % 4 == 0)
    assert np.all(rt.sol["res"].numpy() <= 1e-5)
    np.testing.assert_allclose(rt.u.numpy(), rd.u.numpy(), rtol=0, atol=1e-4)


def test_fused_fista_warm_start_and_fixed_iters(fixture):
    sys, param, st = fixture
    s_j, s_t = _fused_pair("laxMPC", sys, param)
    x = _data(st, 8, seed=4)
    rd = _dense(tsp, "laxMPC", sys, param)(*x)
    warm_t = s_t(*x, init=(rd.sol["lam"],))
    assert int(warm_t.k.max()) <= 2
    warm_j = s_j(*x, init=(rd.sol["lam"].numpy(),))
    _assert_parity(warm_j, warm_t, 2)
    rfix = s_t(*x, fixed_iters=7)
    np.testing.assert_array_equal(rfix.k.numpy(), 7)
    np.testing.assert_array_equal(rfix.e_flag.numpy(), 1)
    _assert_parity(s_j(*x, fixed_iters=7), rfix, 7)
    rdix = _dense(tsp, "laxMPC", sys, param)(*x, fixed_iters=7)
    np.testing.assert_allclose(rfix.sol["z"].numpy(), rdix.sol["z"].numpy(),
                               rtol=0, atol=ATOL_FP32)


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
@pytest.mark.parametrize("restart", [False, True])
def test_fused_fista_exact_k(fixture, formulation, restart):
    """exact_k free-run (window snapshot, window-minimum exit,
    per-iteration replay with the checked mode's momentum masking): the
    checked mode's k, e_flag and iterates, including the restart branch
    and the k_max-capped path."""
    sys, param, st = fixture
    x = _data(st, 8, seed=3)
    s_j, s_t = _fused_pair(formulation, sys, param, restart=restart,
                           check_every=8, exact_k=True)
    rt = s_t(*x)
    _assert_parity(s_j(*x), rt, _iters(rt, 8),
                   MOVED.get((formulation, restart, 3), ()))
    _, s_c = _fused_pair(formulation, sys, param, restart=restart)
    rc = s_c(*x)
    assert torch.equal(rt.k, rc.k)
    for key in ("z", "lam", "res"):
        assert torch.equal(rt.sol[key], rc.sol[key]), key
    # k_max-capped path (tol unreachable): exact cap parity
    s_j2, s_t2 = _fused_pair(formulation, sys, param, tol=1e-13, k_max=21,
                             restart=restart, check_every=8, exact_k=True)
    rt2 = s_t2(*x)
    assert np.all(rt2.k.numpy() == 21) and np.all(rt2.e_flag.numpy() == -1)
    _assert_parity(s_j2(*x), rt2, 24)


def test_fused_fista_batch_padding(fixture):
    """A batch that is not a multiple of tile_b is padded and sliced."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair("equMPC", sys, param, check_every=8, exact_k=True)
    x = _data(st, 5, seed=1)
    rt = s_t(*x)
    assert tuple(rt.u.shape) == (5, 2) and tuple(rt.sol["lam"].shape) == (
        5, 60)
    _assert_parity(s_j(*x), rt, _iters(rt, 8))


def _fp64_kernel_args(formulation, sys, param, x):
    """Kernel arguments built in fp64 from the port's ingredients, with
    the warm-start prologue and the padding of the fused backend."""
    p = _param(param, formulation)
    opt = tsp.default_options(formulation, "FISTA")
    if formulation == "laxMPC":
        mod = tsp.formulations.laxmpc
        ing = mod.laxmpc_fista_ingredients(sys, p, opt)
        q_ref_of, b_of = mod._q_ref, mod._fista_b_lax
    else:
        mod = tsp.formulations.equmpc
        ing = mod.equmpc_fista_ingredients(sys, p, opt)
        q_ref_of, b_of = mod._equmpc_q_ref, mod._b_equ
    d = torch.float64
    x0, xr, ur = (torch.as_tensor(a, dtype=d) for a in x)
    nz, nlam = ing["nz"], ing["N"] * ing["n"]
    nzp, nlamp = fk.round_up(nz, fk.COL_PAD), fk.round_up(nlam, fk.COL_PAD)
    G = torch.as_tensor(ing["G"], dtype=d)
    Winv = torch.as_tensor(ing["Winv"], dtype=d)
    hinv = torch.as_tensor(ing["hinv_diag"], dtype=d)
    LB = torch.as_tensor(ing["LB_z"], dtype=d)
    UB = torch.as_tensor(ing["UB_z"], dtype=d)
    q_ref, b = q_ref_of(ing, xr, ur, d), b_of(ing, x0, xr, d)
    z0 = torch.minimum(torch.maximum(-hinv * q_ref, LB), UB)
    r0 = b - z0 @ G.T
    y = r0 @ Winv.T
    q1 = q_ref - y @ G
    pz, pl = (0, nzp - nz), (0, nlamp - nlam)
    G_pad = F.pad(G, (0, nzp - nz, 0, nlamp - nlam))
    args = (F.pad(q1, pz), F.pad(z0, pz), F.pad(r0, pl), F.pad(y, pl),
            F.pad(y, pl), G_pad, G_pad.T.contiguous(),
            F.pad(Winv.T, (0, nlamp - nlam, 0, nlamp - nlam)),
            F.pad(hinv, pz)[None], F.pad(LB, pz)[None], F.pad(UB, pz)[None])
    return args, nz, nlam


@pytest.mark.parametrize("formulation", ["laxMPC", "equMPC"])
@pytest.mark.parametrize("check_every,exact_k,restart", [
    (1, False, False), (8, True, False), (8, True, True)])
def test_plain_version_fp64_matches_jax_dense(fixture, formulation,
                                              check_every, exact_k,
                                              restart):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates within 1e-9; pad entries
    stay exactly 0."""
    sys, param, st = fixture
    x = _data(st, 8, seed=5)
    args, nz, nlam = _fp64_kernel_args(formulation, sys, param, x)
    z, y, lam, k, e, res = fk.fused_fista_reference(
        *args, tol=1e-7, k_max=3000, restart=restart, tile_b=8,
        check_every=check_every, exact_k=exact_k)
    rj = _dense(jsp, formulation, sys, param, precision="double", tol=1e-7,
                restart=restart)(*x)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(e.numpy(), np.asarray(rj.e_flag))
    for got, key, w in ((z, "z", nz), (y, "lam", nlam)):
        np.testing.assert_allclose(got[:, :w].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
        assert torch.all(got[:, w:] == 0)
    np.testing.assert_allclose(res.numpy(), np.asarray(rj.sol["res"]),
                               rtol=0, atol=1e-9)


def test_wrapper_takes_plain_version_on_cpu(fixture):
    """For CPU tensors the wrapper returns the plain version's results and
    launches nothing."""
    sys, param, st = fixture
    args, _, _ = _fp64_kernel_args("laxMPC", sys, param, _data(st, 8, 6))
    args = tuple(a.float().contiguous() for a in args)
    kw = dict(tol=1e-5, k_max=500, tile_b=8, check_every=8, exact_k=True,
              restart=True)
    before = fk.fused_fista_solve.launches
    got = fk.fused_fista_solve(*args, **kw)
    want = fk.fused_fista_reference(*args, **kw)
    assert fk.fused_fista_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_solver_on_cpu_launches_nothing(fixture):
    sys, param, st = fixture
    _, s_t = _fused_pair("equMPC", sys, param)
    before = fk.fused_fista_solve.launches
    res = s_t(*_data(st, 8, 0))
    assert fk.fused_fista_solve.launches == before
    assert np.all(res.e_flag.numpy() == 1)
    assert s_t.stage_layout == ("stagewise", False)


def test_wrapper_rejects_bad_arguments():
    q = torch.zeros((8, 64))
    r = torch.zeros((8, 32))
    G, GT, W = torch.zeros((32, 64)), torch.zeros((64, 32)), torch.zeros(
        (32, 32))
    row = torch.zeros((1, 64))
    kw = dict(tol=1e-4, k_max=10, tile_b=8)
    ok = (q, q, r, r, r, G, GT, W, row, row, row)

    def call(**repl):
        names = ("q1", "z0", "r0", "y0", "lam0", "G", "GT", "W", "hinv",
                 "lb", "ub")
        a = dict(zip(names, ok), **repl)
        return fk.fused_fista_solve(*(a[n] for n in names), **kw)

    with pytest.raises(ValueError, match="q1 and z0"):
        call(z0=torch.zeros((8, 32)))
    with pytest.raises(ValueError, match="r0, y0 and lam0"):
        call(y0=torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="G_pad"):
        call(GT=torch.zeros((32, 64)))
    with pytest.raises(ValueError, match="hinv_pad"):
        call(lb=torch.zeros((1, 32)))
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_fista_solve(q[:6], q[:6], r[:6], r[:6], r[:6], G, GT, W,
                             row, row, row, **kw)
    with pytest.raises(ValueError, match="one device"):
        call(q1=torch.empty((8, 64), device="meta"))
    meta = [t.to("meta") for t in ok]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_fista_solve(*meta, **kw)
    # the launch path refuses what the kernel does not take, before any
    # build
    with pytest.raises(TypeError, match="float32"):
        fk._launch(*(t.double() for t in ok), restart=False, check_every=1,
                   fixed_iters=0, exact_k=False, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fk._launch(q.T.contiguous().T, *ok[1:], restart=False,
                   check_every=1, fixed_iters=0, exact_k=False, **kw)


def test_launch_geometry():
    # the N=30 shapes: nz 240 (laxMPC) or 234 (equMPC) pad to 256 columns,
    # nlam 180 to 192; one thread per column of the wider. A block of 32
    # lanes holds its state and a ring of 16-row slabs in 215 KB of shared
    # memory
    for B in (8192, 32768):
        kw = dict(tile_b=256, check_every=8, exact_k=True, fixed_iters=0,
                  k_max=4000)
        plan = fk.launch_plan(B, 256, 192, **kw)
        assert plan == dict(lanes=32, blocks=B // 32, threads=256,
                            smem=fk.shared_bytes(256, 192, 32),
                            refill=False)
        assert fk.launch_geometry(B, 256, 192, **kw) == (B // 32, 256,
                                                         plan["smem"])
    assert fk.shared_bytes(256, 192, 32) == 4 * (
        2 * 16 * 256 + 16 + (2 * 256 + 2 * 192) * 32 + (192 + 256) * 36
        + 8 * 2 * 32 + 32 + 4 + 4 * 32)
    assert fk.launch_geometry(16, 96, 160, tile_b=8, check_every=8,
                              exact_k=False, fixed_iters=0,
                              k_max=10)[:2] == (2, 160)
    assert fk.launch_geometry(512, 96, 64, tile_b=256, check_every=8,
                              exact_k=False, fixed_iters=50,
                              k_max=10)[0] == 64
    # 512 columns of both widths need more than the default 48 KiB of
    # shared memory, which the launch opts into
    assert fk.launch_geometry(8, 512, 512, tile_b=8, check_every=1,
                              exact_k=False, fixed_iters=0,
                              k_max=10)[2] > 48 * 1024
    bad = [
        dict(B=64, nzp=250, nlamp=64, tile_b=8),     # not whole warps
        dict(B=64, nzp=96, nlamp=70, tile_b=8),
        dict(B=64, nzp=1056, nlamp=64, tile_b=8),    # beyond every build
        dict(B=64, nzp=96, nlamp=1056, tile_b=8),
        dict(B=60, nzp=96, nlamp=64, tile_b=12),     # tile not whole blocks
        dict(B=48, nzp=96, nlamp=64, tile_b=32),     # batch not whole tiles
        dict(B=256, nzp=96, nlamp=64, tile_b=256, check_every=8),  # drain
        dict(B=64, nzp=96, nlamp=64, tile_b=8, k_max=0),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            fk.launch_geometry(b["B"], b["nzp"], b["nlamp"],
                               tile_b=b["tile_b"],
                               check_every=b.get("check_every", 1),
                               exact_k=False, fixed_iters=0,
                               k_max=b.get("k_max", 10))


def test_free_run_plain_version_drains_per_tile(fixture):
    """Plain free-run: converged lanes keep iterating until their tile is
    done, so with tile_b=16 the early lanes carry later iterates than with
    tile_b=8, while their k and res stay frozen at their exit."""
    sys, param, st = fixture
    args, _, _ = _fp64_kernel_args("laxMPC", sys, param, _data(st, 16, 3))
    args = tuple(a.float().contiguous() for a in args)
    kw = dict(tol=1e-5, k_max=3000, check_every=4)
    z8, _, _, k8, e8, r8 = fk.fused_fista_reference(*args, tile_b=8, **kw)
    z16, _, _, k16, e16, r16 = fk.fused_fista_reference(*args, tile_b=16,
                                                         **kw)
    assert torch.equal(k8, k16) and torch.equal(e8, e16)
    assert torch.equal(r8, r16) and bool((r8 <= 1e-5).all())
    # a tile of 8 whose slowest lane ends with the 16-lane tile's slowest
    # carries the same iterates; the other tile stopped earlier (here the
    # second: its slowest lane ends at 84, the first tile's at 92)
    last = k8.reshape(2, 8).amax(dim=1)
    assert last.tolist() == [92, 84]
    assert torch.equal(z8[:8], z16[:8])
    assert bool(((z8[8:] - z16[8:]).abs().amax(dim=1) > 0).all())


def test_build_is_lazy_and_content_addressed():
    # importing the package built nothing
    assert _build.build_record("fused_fista") is None
    d = _build.source_digest("fused_fista")
    assert d == _build.source_digest("fused_fista") and len(d) == 16
    assert d != _build.source_digest("fused_admm")
    assert (_build.CSRC / "fused_fista.cu").read_text().count(
        "extern \"C\" int fused_fista_launch(") == 1
    # the C signature the wrapper binds: 19 pointers, 7 + 1 + 5 scalars,
    # the stream
    assert len(fk.FUSED_FISTA_ARGTYPES) == 33
    src = (_build.CSRC / "fused_fista.cu").read_text()
    # the builds the wrapper plans for are the source's
    assert '#include "tile_product.cuh"' in src
    for lanes, (slab, blocks) in fk.BUILDS.items():
        assert f"#define FI_SLAB_{lanes} {slab}\n" in src
        assert f"#define FI_BLOCKS_{lanes} {blocks}\n" in src
    # the window-minimum exit of exact-k is the mode loop's
    assert "tp::run_modes<L, true>(" in src
    # no tensor-core product and no library product in the launched source
    assert "mma" not in src and "cublas" not in src.lower()
    # the one-column-per-thread parent stays beside it, for the timing tool
    assert (_build.CSRC / "variants" / "fused_fista_parent.cu").is_file()


@pytest.mark.parametrize("B,lanes", [(8192, 32), (4096, 32), (2048, 16),
                                     (1024, 8), (64, 8)])
def test_lanes_chosen_per_batch(B, lanes):
    """The widest build that divides the batch and still gives half of the
    132 SMs a block, as kernels/stage.py picks it; every build fits shared
    memory at the N=30 widths, and 512 x 512 at 8 lanes."""
    plan = fk.launch_plan(B, 256, 192, tile_b=8, check_every=8,
                          exact_k=True, fixed_iters=0, k_max=4000)
    assert plan["lanes"] == lanes and not plan["refill"]
    for L in fk.BUILDS:
        assert fk.shared_bytes(256, 192, L) <= 232448
    assert fk.shared_bytes(512, 512, 8) <= 232448


@pytest.mark.parametrize("lanes,kw", [
    (64, {}),                              # no such build
    (32, dict(nzp=352)),                   # above 320 columns
    (16, dict(B=8200)),                    # not whole blocks
    (16, dict(nzp=512, nlamp=512)),        # beyond shared memory
])
def test_named_builds_are_refused(lanes, kw):
    a = {**dict(B=8192, nzp=256, nlamp=192), **kw}
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(a["B"], a["nzp"], a["nlamp"], tile_b=8,
                       check_every=8, exact_k=True, fixed_iters=0,
                       k_max=4000, lanes=lanes)
