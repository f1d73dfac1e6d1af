"""The fused ellipMPC-ADMM kernel's plain PyTorch version (the path CPU
tensors take through kernels/fused_ellip.py) against the JAX package's
fused kernel run in Pallas interpret mode, mode for mode (checked,
free-run, exact-k, fixed_iters, the k_max-capped path, a warm start, a
non-identity P), at the kernel's own arguments, and against the JAX dense
engine in fp64; plus the slab layout, the wrapper's dispatch, validation
and build plumbing, which need no GPU."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.kernels.fused_ellip import fused_ellip_solve as jax_kernel

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import _build
from spcies_tpu_torch.kernels import fused_ellip as fk
from spcies_tpu_torch.solvers.fused_backend import FusedEllipADMMSolve

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


# fp32 iterates: the two frameworks sum the [nz] x [nz, nz] product in
# different orders, and each iteration adds about one fp32 ulp to the gap
# between the runs, so iterates and residuals are held to 1e-5, or 2e-7
# per iteration run where that is more; lam (entries up to about 10 here)
# to that bound times max|lam|.
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7
KW = dict(rho=15.0, tol=1e-4, k_max=3000)


@pytest.fixture(scope="module")
def fixture():
    """The tester plant with the bench's ellipsoid (P = I, c = xr) of
    radius 0.5 (test_ellipMPC_ADMM.m:15-20 with r = 0.5)."""
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    param["P"] = np.eye(len(st["xr"]))
    param["c"] = np.asarray(st["xr"])
    param["r"] = 0.5
    return sys, param, st


def _ellipsoid(param, st, seed=3):
    """A random SPD P and a centre c != xr, radius 0.4: the ball binds on
    every lane of _data's inputs."""
    rng = np.random.default_rng(seed)
    n = len(st["xr"])
    L = rng.normal(0.0, 0.3, (n, n))
    return dict(param, P=L @ L.T + 0.5 * np.eye(n),
                c=np.asarray(st["xr"]) + rng.normal(0.0, 0.1, n), r=0.4)


def _fused_pair(sys, param, **kw):
    """(JAX fused in interpret mode, port fused) at fp32."""
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("ellipMPC", "ADMM", tile_b=8,
                                **{**KW, **kw, **extra})
        o.precision = "float"
        out.append(pkg.make_solver(sys, param, formulation="ellipMPC",
                                   method="ADMM", backend="fused", options=o,
                                   **_on_cpu(pkg)))
    return out


def _data(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


KEYS = ("z", "v", "r_p", "r_d")


def _assert_parity(rj, rt, iters, moved=(), step=1):
    """k and e_flag exactly, iterates within the drift bound above after
    `iters` iterations. Lanes in `moved` may end `step` iterations apart;
    they are held to k within that and u within 1e-4."""
    kj, kt = np.asarray(rj.k), rt.k.numpy()
    same = np.ones(kj.shape, bool)
    same[list(moved)] = False
    np.testing.assert_array_equal(kt[same], kj[same])
    assert np.all(np.abs(kt - kj) <= step)
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    atol = max(ATOL_FP32, ATOL_PER_ITER * iters)
    lam_scale = max(1.0, float(np.abs(np.asarray(rj.sol["lam"])).max()))
    for key in KEYS:
        np.testing.assert_allclose(rt.sol[key].numpy()[same],
                                   np.asarray(rj.sol[key])[same], rtol=0,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(rt.sol["lam"].numpy()[same],
                               np.asarray(rj.sol["lam"])[same], rtol=0,
                               atol=atol * lam_scale, err_msg="lam")
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-4)


# Lane 6 of seed 0 ends at the tolerance boundary: at k=418 its r_d is
# 9.9987e-5 in the JAX run and just above 1e-4 here (tol 1e-4), so it
# exits one iteration later. The free-run mode tests at k=420, away from
# it.
MOVED = {"checked": (6,), "exact-k": (6,)}
MODES = {
    "checked": {},
    "free-run": dict(check_every=4),
    "exact-k": dict(check_every=8, exact_k=True),
    "fixed_iters": {},
    "capped": dict(tol=1e-13, k_max=19),
    "capped-exact-k": dict(tol=1e-13, k_max=19, check_every=8,
                           exact_k=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_version_matches_jax_fused(fixture, mode):
    """Every mode of the kernel's plain version against the JAX fused
    kernel on the same inputs: per-lane k and e_flag, and the fp32
    iterates within the drift bound; fixed_iters returns residuals of
    3.4e38."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair(sys, param, **MODES[mode])
    x = _data(st, 8, 0)
    fixed = 60 if mode == "fixed_iters" else None
    rt = s_t(*x, fixed_iters=fixed)
    if mode.startswith("capped"):
        assert np.all(rt.k.numpy() == 19) and np.all(rt.e_flag.numpy() == -1)
    else:
        assert np.all(rt.e_flag.numpy() == 1)
    if fixed:
        assert np.all(rt.k.numpy() == 60)
        assert np.all(rt.sol["r_p"].numpy() == np.float32(3.4e38))
    _assert_parity(s_j(*x, fixed_iters=fixed), rt, int(rt.k.max()) + 8,
                   MOVED.get(mode, ()))


@pytest.mark.parametrize("mode", ["checked", "exact-k"])
def test_nonidentity_P_matches_jax_fused(fixture, mode):
    """A random SPD P and c != xr, where the P_half coordinates are not
    trivial and the ball binds: the JAX fused kernel's k and iterates."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair(sys, _ellipsoid(param, st), **MODES[mode])
    x = _data(st, 8, 0)
    rt = s_t(*x)
    assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8)


def test_warm_start_matches_jax_fused(fixture):
    """A warm start from the port's fp64 dense solution: the prologue's
    P_half / P products on v0 and lam0, held to the JAX kernel's result."""
    sys, param, st = fixture
    param = _ellipsoid(param, st)
    x = _data(st, 8, 4)
    rd = tsp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                         rho=15.0, tol=1e-3, k_max=3000, device="cpu")(*x)
    init = tuple(rd.sol[key].float() for key in ("z", "v", "lam"))
    s_j, s_t = _fused_pair(sys, param)
    rt = s_t(*x, init=init)
    assert bool((rt.k < s_t(*x).k).all())
    # lane 5 ends at the tolerance boundary: at k=269 its r_d is 9.99868e-5
    # here and 1.00076e-4 in the JAX run, which exits one iteration later
    _assert_parity(s_j(*x, init=tuple(a.numpy() for a in init)), rt,
                   int(rt.k.max()) + 8, moved=(5,))


def _jax_layout(args, t0, n, width=128):
    """The port kernel's arguments in the JAX kernel's form: columns
    padded to `width`, the n x n pinvh block inside a [width, width]
    PINVH, and the slab as a segT row."""
    z1, v0, lam0, M2, pinvh, lb, ub, c = args
    pad = width - z1.shape[1]
    PINVH = torch.zeros((width, width))
    PINVH[t0:t0 + n, t0:t0 + n] = pinvh
    segT = torch.zeros((1, width))
    segT[0, t0:t0 + n] = 1.0
    return ([F.pad(a, (0, pad)) for a in (z1, v0, lam0)]
            + [F.pad(M2, (0, pad, 0, pad)), PINVH]
            + [F.pad(a, (0, pad)) for a in (lb, ub)] + [segT, F.pad(c, (0,
                                                                        pad))])


def test_kernel_level_inputs_match_jax(fixture):
    """The wrapper against the JAX kernel on the same arrays, built by the
    port's adapter (with a random warm start's v and lam) and laid out as
    the JAX kernel takes them; the pad columns stay exactly 0."""
    sys, param, st = fixture
    _, s_t = _fused_pair(sys, _ellipsoid(param, st), check_every=8,
                         exact_k=True)
    fused = s_t.raw_fn
    x = [torch.as_tensor(a, dtype=torch.float32) for a in _data(st, 8, 5)]
    rng = np.random.default_rng(5)
    nz = fused.nz
    init = (None,
            torch.as_tensor(rng.normal(0, 0.1, (8, nz)), dtype=torch.float32),
            torch.as_tensor(rng.normal(0, 1.0, (8, nz)), dtype=torch.float32))
    *kin, _ = fused.prepare(*x, init=init)
    args = (*kin, *fused.operator)
    kw = dict(fused.kernel_kw)
    got = fk.fused_ellip_solve(*args, **kw)
    t0 = kw.pop("t0")
    kw.pop("r_ball")
    want = jax_kernel(*(a.numpy() for a in _jax_layout(args, t0, fused.n)),
                      r_ball=float(s_t.ingredients["r"]), interpret=True,
                      **kw)
    # lane 6 ends at the tolerance boundary and exits one iteration later
    # here (k 453 against 452)
    same = np.arange(8) != 6
    kj = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy()[same], kj[same])
    assert abs(int(got[3][6]) - int(kj[6])) <= 1
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    atol = ATOL_PER_ITER * (int(got[3].max()) + 8)
    nzp = got[0].shape[1]
    for a, b, scale in zip(got[:3], want[:3], (1, 1, 40)):
        np.testing.assert_allclose(a.numpy()[same],
                                   np.asarray(b)[same, :nzp], rtol=0,
                                   atol=atol * scale)
        assert torch.all(a[:, fused.t0 + fused.n:] == 0)


def _fp64(sys, param, x, **kw):
    """The kernel's arguments in fp64 from the port's fp64 ingredients."""
    opt = tsp.default_options("ellipMPC", "ADMM", tile_b=8, **{**KW, **kw})
    ing = tsp.formulations.ellipmpc.ellipmpc_admm_ingredients(sys, param,
                                                               opt)
    fused = FusedEllipADMMSolve(
        ing, opt, "cpu", dtype=torch.float64,
        make_q_ref=lambda xr, ur: tsp.formulations.ellipmpc._ellipmpc_q_ref(
            ing, xr, ur, torch.float64))
    *kin, _ = fused.prepare(*(torch.as_tensor(a) for a in x))
    return (*kin, *fused.operator), fused


@pytest.mark.parametrize("check_every,exact_k,ellipsoid",
                         [(1, False, False), (8, True, False),
                          (1, False, True)])
def test_plain_version_fp64_matches_jax_dense(fixture, check_every, exact_k,
                                              ellipsoid):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates, mapped back out of the
    P_half coordinates, within 1e-9; pad entries stay exactly 0."""
    sys, param, st = fixture
    if ellipsoid:
        param = _ellipsoid(param, st)
    x = _data(st, 8, 5)
    args, fused = _fp64(sys, param, x)
    kw = dict(fused.kernel_kw, tol_p=1e-7, tol_d=1e-7, k_max=5000,
              check_every=check_every, exact_k=exact_k)
    z, v, lam, k, e, r_p, r_d = fk.fused_ellip_reference(*args, **kw)
    rj = jsp.make_solver(sys, param, formulation="ellipMPC", method="ADMM",
                         rho=15.0, tol=1e-7, k_max=5000)(*x)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(e.numpy(), np.asarray(rj.e_flag))
    pos = torch.as_tensor(fused.pos)
    for got, key in ((fused._from_t(z[:, pos]), "z"),
                     (fused._from_t(v[:, pos]), "v"), (lam[:, pos], "lam"),
                     (r_p, "r_p"), (r_d, "r_d")):
        np.testing.assert_allclose(got.numpy(), np.asarray(rj.sol[key]),
                                   rtol=0, atol=1e-9, err_msg=key)
    for a in (z, v, lam):
        assert torch.all(a[:, fused.t0 + fused.n:] == 0)


def test_slab_layout_changes_nothing(fixture):
    """The slab moved to the next warp boundary (the layout the adapter
    takes when the terminal columns would straddle a warp) gives the same
    results bit for bit: the columns between are zero pads."""
    sys, param, st = fixture
    args, fused = _fp64(sys, _ellipsoid(param, st), _data(st, 8, 6))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, check_every=8, exact_k=True)
    t0, n, ns = fused.t0, fused.n, fused.ns
    assert fk.slab_start(ns, n) == t0 == ns           # 74: in warp 2
    t1 = 96                                           # the next warp
    old = np.concatenate([np.arange(ns), t0 + np.arange(n)])
    new = torch.as_tensor(np.concatenate([np.arange(ns), t1 + np.arange(n)]))
    old = torch.as_tensor(old)

    def move(a, square=False):
        out = torch.zeros(a.shape[:-1] + (128,)) if not square else \
            torch.zeros((128, 128))
        if square:
            out[new[:, None], new] = a[old[:, None], old]
        else:
            out[..., new] = a[..., old]
        return out

    z1, v0, lam0, M2, pinvh, lb, ub, c = args
    moved = (move(z1), move(v0), move(lam0), move(M2, square=True), pinvh,
             move(lb), move(ub), move(c))
    a = fk.fused_ellip_reference(*args, **kw)
    b = fk.fused_ellip_reference(*moved, **dict(kw, t0=t1))
    for i in (3, 4, 5, 6):
        assert torch.equal(a[i], b[i]), i
    for i in (0, 1, 2):
        assert torch.equal(a[i][:, old], b[i][:, new]), i
    assert fk.slab_start(234, 6) == 234                # N=30: warp 7
    assert fk.slab_start(60, 6) == 64                  # 60..65 straddles


def test_free_run_plain_version_drains_per_tile(fixture):
    """Plain free-run: converged lanes keep iterating until their tile is
    done, so with tile_b=16 the early tile's lanes carry later iterates
    than with tile_b=8, while k and the residuals stay at their exit."""
    sys, param, st = fixture
    args, fused = _fp64(sys, param, _data(st, 16, 4))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, check_every=4, exact_k=False)
    kw.pop("tile_b")
    o8 = fk.fused_ellip_reference(*args, tile_b=8, **kw)
    o16 = fk.fused_ellip_reference(*args, tile_b=16, **kw)
    for i in (3, 4, 5, 6):
        assert torch.equal(o8[i], o16[i]), i
    slow = o8[3].reshape(2, 8).amax(dim=1)
    early, late = (0, 1) if slow[0] < slow[1] else (1, 0)
    rows = slice(8 * late, 8 * late + 8)
    assert torch.equal(o8[0][rows], o16[0][rows])
    rows = slice(8 * early, 8 * early + 8)
    assert bool(((o8[0][rows] - o16[0][rows]).abs().amax(dim=1) > 0).all())


def test_wrapper_takes_plain_version_on_cpu(fixture):
    """For CPU tensors the wrapper returns the plain version's results and
    launches nothing."""
    sys, param, st = fixture
    args, fused = _fp64(sys, param, _data(st, 8, 6))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, k_max=500)
    before = fk.fused_ellip_solve.launches
    got = fk.fused_ellip_solve(*args, **kw)
    want = fk.fused_ellip_reference(*args, **kw)
    assert fk.fused_ellip_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    t = torch.zeros((8, 64))
    ok = (t, t, t, torch.zeros((64, 64)), torch.zeros((6, 6)),
          *(torch.zeros((1, 64)),) * 3)
    kw = dict(t0=40, rho=5.0, r_ball=0.5, tol_p=1e-4, tol_d=1e-4, k_max=10,
              tile_b=8)

    def call(i, repl, **extra):
        a = list(ok)
        a[i] = repl
        return fk.fused_ellip_solve(*a, **{**kw, **extra})

    with pytest.raises(ValueError, match="share one shape"):
        call(1, torch.zeros((8, 32)))
    with pytest.raises(ValueError, match="pinvh square"):
        call(4, torch.zeros((6, 5)))
    with pytest.raises(ValueError, match="M2_pad"):
        call(3, torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="outside"):
        call(0, t, t0=60)
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_ellip_solve(*(a[:6] for a in ok[:3]), *ok[3:], **kw)
    with pytest.raises(ValueError, match="one device"):
        call(0, torch.empty((8, 64), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_ellip_solve(*(a.to("meta") for a in ok), **kw)
    # the launch path refuses what the kernel does not take, before any
    # build
    lk = dict(kw, check_every=1, exact_k=False, fixed_iters=0)
    with pytest.raises(TypeError, match="float32"):
        fk._launch(*(a.double() for a in ok), **lk)
    with pytest.raises(ValueError, match="contiguous"):
        fk._launch(t.T.contiguous().T, *ok[1:], **lk)
    with pytest.raises(ValueError, match="one warp"):
        fk._launch(*ok, **dict(lk, t0=30))


def test_launch_geometry():
    # the N=30 shape: nz = 240 pads to 256 columns, slab 234..239. Exact-k,
    # the main path, keeps one block of 32 lanes: its state and the 32-row
    # slabs of M2 take all but 27 KB of the shared memory a block can have
    for B in (8192, 32768):
        kw = dict(tile_b=256, check_every=8, exact_k=True, fixed_iters=0)
        plan = fk.launch_plan(B, 256, 234, 6, **kw)
        assert plan == dict(lanes=32, blocks=B // 32, threads=256,
                            smem=fk.shared_bytes(256, 6, 32), refill=False)
        assert fk.launch_geometry(B, 256, 234, 6, **kw) == (B // 32, 256,
                                                            plan["smem"])
    assert fk.shared_bytes(256, 6, 32) == 4 * (
        2 * 32 * 256 + 16 + 256 * (4 * 32 + 4) + 8 * 2 * 32 + 4 + 3 * 32
        + 2 * 6 * 36 + 36)
    # plain free-run and the checked mode refill persistent blocks, one an
    # SM at 32 lanes
    for ce in (1, 8):
        plan = fk.launch_plan(8192, 256, 234, 6, tile_b=8, check_every=ce,
                              exact_k=False, fixed_iters=0)
        assert (plan["lanes"], plan["blocks"], plan["refill"]) == (32, 132,
                                                                   True)
    # 512 columns fit the 227 KB a block can opt into, at 16 lanes at most
    plan = fk.launch_plan(8192, 512, 0, 6, tile_b=8, check_every=1,
                          exact_k=False, fixed_iters=0)
    assert plan["lanes"] == 16 and 48 * 1024 < plan["smem"] <= 232448
    # plain free-run drains per group of 8 lanes; fixed_iters does not care
    # and keeps a block of L lanes
    assert fk.launch_geometry(16, 96, 74, 6, tile_b=8, check_every=4,
                              exact_k=False, fixed_iters=0)[:2] == (2, 96)
    assert fk.launch_geometry(256, 96, 74, 6, tile_b=256, check_every=8,
                              exact_k=False, fixed_iters=50)[0] == 32
    assert not fk.launch_plan(256, 96, 74, 6, tile_b=256, check_every=8,
                              exact_k=False, fixed_iters=50)["refill"]
    bad = [
        dict(nzp=250),                    # not whole warps
        dict(nzp=1056),                   # beyond every build (1024)
        dict(t0=60),                      # slab straddles warps 1 and 2
        dict(n=33, t0=0),                 # slab wider than a warp
        dict(t0=92),                      # slab beyond the width
        dict(tile_b=12, B=48),            # tile not whole blocks
        dict(tile_b=32, B=48),            # batch not whole tiles
        dict(tile_b=256, B=256, check_every=8),   # drain per block
    ]
    for b in bad:
        g = {**dict(B=64, nzp=96, t0=74, n=6, tile_b=8, check_every=1),
             **b}
        with pytest.raises(ValueError):
            fk.launch_geometry(g["B"], g["nzp"], g["t0"], g["n"],
                               tile_b=g["tile_b"],
                               check_every=g["check_every"], exact_k=False,
                               fixed_iters=0)


@pytest.mark.parametrize("B,exact_k,lanes", [
    (8192, True, 32), (2048, True, 16), (1024, True, 8),
    (8192, False, 32), (2048, False, 16), (64, False, 8),
])
def test_lanes_chosen_per_batch(B, exact_k, lanes):
    """The widest build that still gives half of the 132 SMs a block, as
    kernels/stage.py picks it; every build fits shared memory."""
    plan = fk.launch_plan(B, 256, 234, 6, tile_b=256 if exact_k else 8,
                          check_every=8, exact_k=exact_k, fixed_iters=0)
    assert plan["lanes"] == lanes and plan["refill"] == (not exact_k)
    for L in fk.BUILDS:
        assert fk.shared_bytes(256, 6, L) <= 232448


@pytest.mark.parametrize("lanes,kw", [
    (64, {}),                              # no such build
    (32, dict(nzp=352, t0=320)),           # above 320 columns
    (16, dict(B=8200)),                    # exact-k: not whole blocks
])
def test_named_builds_are_refused(lanes, kw):
    a = {**dict(B=8192, nzp=256, t0=234), **kw}
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(a["B"], a["nzp"], a["t0"], 6, tile_b=8,
                       check_every=8, exact_k=True, fixed_iters=0,
                       lanes=lanes)


def test_build_is_lazy_and_content_addressed():
    # importing the package built nothing
    assert _build.build_record("fused_ellip") is None
    d = _build.source_digest("fused_ellip")
    assert d == _build.source_digest("fused_ellip") and len(d) == 16
    assert d != _build.source_digest("fused_soc")
    src = (_build.CSRC / "fused_ellip.cu").read_text()
    assert src.count("extern \"C\" int fused_ellip_launch(") == 1
    assert f"NSNAP = {fk.SNAP_LEAVES};" in src
    # the C signature the wrapper binds: 17 pointers, 8 + 5 + 4 scalars,
    # the stream
    assert len(fk.FUSED_ELLIP_ARGTYPES) == 35
    # the builds the wrapper plans for are the source's
    assert '#include "tile_product.cuh"' in src
    for lanes, (slab, blocks) in fk.BUILDS.items():
        assert f"#define EL_SLAB_{lanes} {slab}\n" in src
        assert f"#define EL_BLOCKS_{lanes} {blocks}\n" in src
        assert f"launch<{lanes}, true>(p, " in src
    # no tensor-core product and no library product in the launched source
    assert "mma" not in src and "cublas" not in src.lower()
    # the one-column-per-thread parent stays beside it, for the timing tool
    assert (_build.CSRC / "variants" / "fused_ellip_parent.cu").is_file()
