"""The fused single-split cone-ADMM kernel's plain PyTorch version (the path
CPU tensors take through kernels/fused_hmpc.py) against the JAX package's
fused kernel run in Pallas interpret mode, mode for mode (checked,
free-run, exact-k, the k_max-capped path, a warm start; diamond and
shifted-SOC cones; HMPC and ellipHMPC), exact-k against the checked mode
bit for bit, and against the JAX dense engine in fp64; plus the cone
layout and the wrapper's dispatch, validation and build plumbing, which
need no GPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.formulations import hmpc as th
from spcies_tpu_torch.kernels import _build
from spcies_tpu_torch.kernels import fused_hmpc as fk
from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.solvers.fused_backend import FusedHMPCSolve

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
# and each iteration adds about one fp32 ulp to the gap between the runs,
# so iterates and residuals are held to 1e-5, or 2e-7 per iteration run
# where that is more; the dual lam to that bound times its largest entry.
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7
KW = dict(rho=2.0, tol_p=1e-5, tol_d=1e-5, k_max=3000)
ELLIP_KW = dict(rho=2.0, sigma=0.01, tol_p=1e-5, tol_d=1e-5, k_max=3000)


@pytest.fixture(scope="module")
def fixture():
    """The HMPC tester fixture (tests/test_hmpc.py:14-25) and the
    ellipHMPC one (tests/test_elliphmpc.py:15-31)."""
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    param.pop("T", None)
    param["w"] = 3 * 1.627 * 0.2
    param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
    param["Th"] = param["Te"]
    param["Se"] = np.asarray(param["R"]).copy()
    param["Sh"] = 0.5 * param["Se"]
    sys_e = dict(sys, E=np.eye(3, len(st["x"])), F=np.zeros((3, 2)),
                 LBy=-0.3 * np.ones(3), UBy=0.3 * np.ones(3))
    return sys, sys_e, param, st


def _data(st, B, seed, ellip=False):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    xr, ur = np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))
    if not ellip:
        return x0, xr, ur
    # decomposed references: offset (xr, ur) and per-lane sine amplitudes
    amp = np.zeros_like(xr)
    amp[:, :3] = rng.uniform(0.0, 0.2, (B, 1))
    zu = np.zeros_like(ur)
    return x0, xr, amp, 0.5 * amp, ur, zu, zu


def _fused(pkg, sys, param, ellip=False, **kw):
    """The fused solver of `pkg` at fp32; the JAX kernel in interpret
    mode."""
    f = "ellipHMPC" if ellip else "HMPC"
    extra = dict(pallas_interpret=True) if pkg is jsp else {}
    o = pkg.default_options(f, "ADMM", tile_b=8,
                            **{**(ELLIP_KW if ellip else KW), **kw, **extra})
    o.precision = "float"
    return pkg.make_solver(sys, param, formulation=f, method="ADMM",
                           backend="fused", options=o, **_on_cpu(pkg))


def _fused_pair(sys, param, ellip=False, **kw):
    """(JAX fused in interpret mode, port fused) at fp32."""
    return [_fused(pkg, sys, param, ellip, **kw) for pkg in (jsp, tsp)]


KEYS = ("z", "s", "r_p", "r_d")


def _assert_parity(rj, rt, iters, moved=(), step=1):
    """k and e_flag exactly, iterates within the drift bound above after
    `iters` iterations. Lanes in `moved` may end one check apart (`step`
    iterations); they are held to that and to u within 1e-4."""
    kj, kt = np.asarray(rj.k), rt.k.numpy()
    same = np.ones(kj.shape, bool)
    same[list(moved)] = False
    np.testing.assert_array_equal(kt[same], kj[same])
    assert np.all(np.abs(kt - kj) <= step)
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    atol = max(ATOL_FP32, ATOL_PER_ITER * iters)
    for key in KEYS:
        np.testing.assert_allclose(rt.sol[key].numpy()[same],
                                   np.asarray(rj.sol[key])[same], rtol=0,
                                   atol=atol, err_msg=key)
    scale = max(1.0, float(np.abs(np.asarray(rj.sol["lam"])).max()))
    np.testing.assert_allclose(rt.sol["lam"].numpy()[same],
                               np.asarray(rj.sol["lam"])[same], rtol=0,
                               atol=atol * scale, err_msg="lam")
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-4)


MODES = {
    "checked": {},
    "free-run": dict(check_every=4),
    "exact-k": dict(check_every=8, exact_k=True),
    "capped": dict(tol_p=1e-13, tol_d=1e-13, k_max=19),
}


# every mode with diamonds, the SOC projection in checked and exact-k mode;
# the capped exact-k path equals the capped checked one bit for bit
# (test_exact_k_bit_identical_to_checked)
@pytest.mark.parametrize("mode,use_soc", [
    *((mode, False) for mode in MODES), ("checked", True),
    ("exact-k", True)])
def test_plain_version_matches_jax_fused(fixture, mode, use_soc):
    """Each mode of the kernel's plain version against the JAX fused
    kernel on the same inputs: per-lane k and e_flag, and the fp32 iterates
    within the drift bound."""
    sys, _, param, st = fixture
    s_j, s_t = _fused_pair(sys, param, use_soc=use_soc, **MODES[mode])
    x = _data(st, 8, 7)
    rt = s_t(*x)
    if mode == "capped":
        assert np.all(rt.k.numpy() == 19) and np.all(rt.e_flag.numpy() == -1)
    else:
        assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8)


@pytest.mark.parametrize("mode", ["checked", "free-run", "exact-k"])
def test_elliphmpc_matches_jax_fused(fixture, mode):
    """ellipHMPC: output-mode box rows, 3 cones with sigma-tightened D-set
    bounds and the 7 decomposed references, against the JAX fused kernel."""
    _, sys_e, param, st = fixture
    s_j, s_t = _fused_pair(sys_e, param, ellip=True, **MODES[mode])
    x = _data(st, 8, 9, ellip=True)
    rt = s_t(*x)
    assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8)


def test_warm_start_matches_jax_fused(fixture):
    """A warm start from the port's fp64 dense solution: the prologue's
    z1 from (s, lam), held to the JAX kernel's result."""
    sys, _, param, st = fixture
    x = _data(st, 8, 24)
    rd = tsp.make_solver(sys, param, formulation="HMPC", method="ADMM",
                         **dict(KW, k_max=60), device="cpu")(*x)
    init = tuple(rd.sol[key].float() for key in ("z", "s", "lam"))
    s_j, s_t = _fused_pair(sys, param)
    rt = s_t(*x, init=init)
    assert bool((rt.k < s_t(*x).k).all())
    _assert_parity(s_j(*x, init=tuple(a.numpy() for a in init)), rt,
                   int(rt.k.max()) + 8)


@pytest.mark.parametrize("use_soc", [False, True])
def test_exact_k_bit_identical_to_checked(fixture, use_soc):
    """exact_k (window snapshots + replay) equals the checked mode bit for
    bit (k, e_flag, every iterate), including the k_max-capped path, as
    tests/test_hmpc.py:385 holds the JAX kernel."""
    sys, _, param, st = fixture
    x = _data(st, 8, 17)
    for cap in ({}, dict(tol_p=1e-13, tol_d=1e-13, k_max=19)):
        r1 = _fused(tsp, sys, param, use_soc=use_soc, **cap)(*x)
        r2 = _fused(tsp, sys, param, use_soc=use_soc, check_every=8,
                    exact_k=True, **cap)(*x)
        assert torch.equal(r1.k, r2.k) and torch.equal(r1.e_flag, r2.e_flag)
        for key, val in r1.sol.items():
            if torch.is_tensor(val):
                assert torch.equal(val, r2.sol[key]), key


def _fp64(sys, param, x, ellip=False, **kw):
    """The kernel's arguments in fp64 from the port's fp64 ingredients."""
    f = "ellipHMPC" if ellip else "HMPC"
    opt = tsp.default_options(f, "ADMM", tile_b=8,
                              **{**(ELLIP_KW if ellip else KW), **kw})
    if ellip:
        opt.solver["box_constraints"] = False
    ing = th.hmpc_common_ingredients(sys, param, opt, split=False)
    M1, M2 = th.single_split_kkt(ing, opt.solver["rho"])
    maker = th.elliphmpc_q_maker if ellip else th.hmpc_q_maker
    sigma = opt.solver.get("sigma", 0.0) if ellip else 0.0
    fused = FusedHMPCSolve(ing, opt, "cpu", M1, M2,
                           make_q=maker(ing, torch.float64, "cpu"),
                           lby=ing["LBy"] + sigma, uby=ing["UBy"] - sigma,
                           dtype=torch.float64)
    *kin, _ = fused.prepare(*(torch.as_tensor(a) for a in x))
    return (*kin, *fused.operator), fused


@pytest.mark.parametrize("case,check_every,exact_k", [
    ("diamond", 1, False), ("diamond", 8, True), ("soc", 1, False),
    ("ellip", 8, True)])
def test_plain_version_fp64_matches_jax_dense(fixture, case, check_every,
                                              exact_k):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates within 1e-9; pad entries
    stay exactly 0."""
    sys, sys_e, param, st = fixture
    ellip = case == "ellip"
    kw = dict(use_soc=case == "soc", tol_p=1e-7, tol_d=1e-7, k_max=5000)
    x = _data(st, 8, 5, ellip=ellip)
    args, fused = _fp64(sys_e if ellip else sys, param, x, ellip=ellip,
                        **kw)
    kk = dict(fused.kernel_kw, tol_p=1e-7, tol_d=1e-7, k_max=5000,
              check_every=check_every, exact_k=exact_k)
    z, s, lam, k, e, r_p, r_d = fk.fused_hmpc_reference(*args, **kk)
    f = "ellipHMPC" if ellip else "HMPC"
    rj = jsp.make_solver(sys_e if ellip else sys, param, formulation=f,
                         method="ADMM",
                         **{**(ELLIP_KW if ellip else KW), **kw})(*x)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(e.numpy(), np.asarray(rj.e_flag))
    pos = torch.as_tensor(fused.pos)
    for got, key in ((z[:, :fused.dim], "z"), (s[:, pos], "s"),
                     (lam[:, pos], "lam"), (r_p, "r_p"), (r_d, "r_d")):
        np.testing.assert_allclose(got.numpy(), np.asarray(rj.sol[key]),
                                   rtol=0, atol=1e-9, err_msg=key)
    pad = np.setdiff1d(np.arange(args[1].shape[1]), fused.pos)
    assert torch.all(s[:, pad] == 0) and torch.all(lam[:, pad] == 0)
    assert torch.all(z[:, fused.dim:] == 0)


def test_free_run_plain_version_drains_per_tile(fixture):
    """Plain free-run: converged lanes keep iterating until their tile is
    done, so with tile_b=16 the early tile's lanes carry later iterates
    than with tile_b=8, while k and the residuals stay at their exit."""
    sys, _, param, st = fixture
    x0, xr, ur = _data(st, 16, 4)
    x0[:8] *= 0.05          # an easy first tile: it drains long before
    xr[:8] = 0.0            # the second
    args, fused = _fp64(sys, param, (x0, xr, ur))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, check_every=4)
    kw.pop("tile_b")
    o8 = fk.fused_hmpc_reference(*args, tile_b=8, **kw)
    o16 = fk.fused_hmpc_reference(*args, tile_b=16, **kw)
    for i in (3, 4, 5, 6):
        assert torch.equal(o8[i], o16[i]), i
    slow = o8[3].reshape(2, 8).amax(dim=1)
    early, late = (0, 1) if slow[0] < slow[1] else (1, 0)
    rows = slice(8 * late, 8 * late + 8)
    assert torch.equal(o8[0][rows], o16[0][rows])
    rows = slice(8 * early, 8 * early + 8)
    assert bool(((o8[0][rows] - o16[0][rows]).abs().amax(dim=1) > 0).all())


@pytest.mark.parametrize("n_cones,warps,g", [(1, 1, 1), (3, 1, 3),
                                             (8, 1, 8), (10, 1, 10),
                                             (11, 2, 6), (16, 2, 8),
                                             (24, 3, 8)])
def test_cone_layout(n_cones, warps, g):
    """Cones fill as few warps as hold them, evenly; a cone's three lanes
    lie in one warp at c, g + c, 2g + c, and no two slots share a lane."""
    assert fk.cone_layout(n_cones) == (warps, g)
    cols = fk.cone_columns(warps, g, 64)
    assert cols.shape == (warps * g, 3)
    assert len(np.unique(cols)) == cols.size
    assert np.all(cols // 32 == cols[:, :1] // 32)
    assert np.all(cols >= 64) and np.all(cols < 64 + 32 * warps)
    np.testing.assert_array_equal(cols[:, 1] - cols[:, 0], g)


def test_wrapper_takes_plain_version_on_cpu(fixture):
    """For CPU tensors the wrapper returns the plain version's results and
    launches nothing."""
    sys, _, param, st = fixture
    args, fused = _fp64(sys, param, _data(st, 8, 6))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, k_max=500, check_every=8, exact_k=True)
    before = fk.fused_hmpc_solve.launches
    got = fk.fused_hmpc_solve(*args, **kw)
    want = fk.fused_hmpc_reference(*args, **kw)
    assert fk.fused_hmpc_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    z = torch.zeros((8, 64))
    s = torch.zeros((8, 96))
    row = torch.zeros((1, 96))
    ok = (z, s, s, torch.zeros((64, 96)), torch.zeros((96, 64)), row, row,
          row)
    kw = dict(rho=1.0, tol_p=1e-4, tol_d=1e-4, k_max=10, use_soc=False,
              cone0=64, cone_g=8, tile_b=8)

    def call(i, repl, **extra):
        a = list(ok)
        a[i] = repl
        return fk.fused_hmpc_solve(*a, **{**kw, **extra})

    with pytest.raises(ValueError, match="share one shape"):
        call(2, torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="CT must be"):
        call(3, torch.zeros((96, 64)))
    with pytest.raises(ValueError, match="CT must be"):
        call(5, torch.zeros((1, 64)))
    with pytest.raises(ValueError, match="whole warps"):
        call(0, z, cone0=48)
    with pytest.raises(ValueError, match="cones"):
        call(0, z, cone_g=11)
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_hmpc_solve(*(a[:6] for a in ok[:3]), *ok[3:], **kw)
    with pytest.raises(ValueError, match="one device"):
        call(0, torch.empty((8, 64), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_hmpc_solve(*(a.to("meta") for a in ok), **kw)
    # the launch path refuses what the kernel does not take, before any
    # build
    lk = dict(kw, check_every=1, exact_k=False)
    with pytest.raises(TypeError, match="float32"):
        fk._launch(*(a.double() for a in ok), **lk)
    with pytest.raises(ValueError, match="contiguous"):
        fk._launch(z.T.contiguous().T, *ok[1:], **lk)


def test_launch_geometry():
    # the N=30 shapes: z 258 -> 288; s 234 box rows -> 256 and one warp of
    # 8 diamonds (288), or two warps of 8 SOCs (320); ellipHMPC 90 -> 96
    # and one warp of 3 cones (128). Plain free-run refills persistent
    # blocks; each shape takes the widest build whose shared memory fits.
    for (dim_p, ns_p, cone0, g), lanes in (((288, 288, 256, 8), 32),
                                           ((288, 320, 256, 8), 16),
                                           ((288, 128, 96, 3), 32)):
        for B in (8192, 32768):
            kw = dict(tile_b=8, check_every=8, exact_k=False)
            plan = fk.launch_plan(B, dim_p, ns_p, cone0, g, **kw)
            per_sm = min(fk.BUILDS[lanes][1],
                         233472 // (plan["smem"] + 1024))
            assert plan == dict(
                lanes=lanes, blocks=132 * per_sm, threads=max(dim_p, ns_p),
                smem=fk.shared_bytes(dim_p, ns_p, lanes), refill=True)
            assert plan["smem"] <= 232448
            assert fk.launch_geometry(B, dim_p, ns_p, cone0, g, **kw) == (
                plan["blocks"], plan["threads"], plan["smem"])
            # exact-k keeps one block per L lanes
            ek = fk.launch_plan(B, dim_p, ns_p, cone0, g, tile_b=256,
                                check_every=8, exact_k=True)
            assert not ek["refill"] and ek["blocks"] * ek["lanes"] == B
    # at 32 lanes the diamond shape's state and its 32-row slabs take all
    # but 4 KB of a block's shared memory
    assert fk.shared_bytes(288, 288, 32) == 4 * (
        2 * 32 * 288 + 16 + 288 * 32 * 3 + 288 * 36 + 9 * 2 * 32 + 4 + 64)
    bad = [
        dict(dim_p=120),                  # not whole warps
        dict(ns_p=1056, cone0=1024),      # beyond every build (1024)
        dict(cone0=40),                   # cones off a warp boundary
        dict(cone0=128),                  # no cone warp
        dict(g=0),                        # an empty warp of cones
        dict(tile_b=12, B=48),            # tile not whole groups of 8
        dict(tile_b=32, B=48),            # batch not whole tiles
        dict(tile_b=256, B=256, check_every=8),   # drain per group
    ]
    for b in bad:
        a = {**dict(B=64, dim_p=96, ns_p=128, cone0=96, g=3, tile_b=8,
                    check_every=1), **b}
        with pytest.raises(ValueError):
            fk.launch_geometry(a["B"], a["dim_p"], a["ns_p"], a["cone0"],
                               a["g"], tile_b=a["tile_b"],
                               check_every=a["check_every"], exact_k=False)


# (batch, dim_p, ns_p, cone0, mode) -> lanes a block the dispatch picks: the
# families' batches at the diamond, use_soc and ellipHMPC shapes, a request
# of 64 lanes, and exact-k, which keeps one block per L lanes
DISPATCH = {(8192, 288, 288, 256, "free-run"): 32,
            (32768, 288, 320, 256, "free-run"): 16,
            (8192, 288, 128, 96, "checked"): 32,
            (64, 288, 288, 256, "free-run"): 8,
            (4096, 288, 288, 256, "exact-k"): 32,
            (512, 288, 288, 256, "exact-k"): 8,
            (8192, 512, 512, 480, "free-run"): 16}


@pytest.mark.parametrize("shape", sorted(DISPATCH))
def test_dispatch_by_shape(shape):
    B, dim_p, ns_p, cone0, mode = shape
    kw = dict(tile_b=8 if mode != "exact-k" else 256,
              check_every={"checked": 1}.get(mode, 8),
              exact_k=mode == "exact-k")
    plan = fk.launch_plan(B, dim_p, ns_p, cone0, 8, **kw)
    assert plan["lanes"] == DISPATCH[shape]
    assert plan["smem"] == fk.shared_bytes(dim_p, ns_p, plan["lanes"])
    assert plan["smem"] <= 232448 and plan["refill"] == (mode != "exact-k")
    # with refill every slot has a group to start with; without, one block
    # per L lanes
    slots = plan["blocks"] * plan["lanes"] // 8
    assert (slots <= B // 8 if plan["refill"]
            else plan["blocks"] * plan["lanes"] == B)


@pytest.mark.parametrize("lanes,kw", [
    (64, {}),                              # no such build
    (4, {}),
    (32, dict(ns_p=320)),                  # use_soc: 241,488 bytes
    (32, dict(dim_p=384, ns_p=384, cone0=352)),   # above 320 columns
    (16, dict(B=8200, exact_k=True)),      # exact-k: not whole blocks
])
def test_named_builds_are_refused(lanes, kw):
    a = {**dict(B=8192, dim_p=288, ns_p=288, cone0=256, exact_k=False),
         **kw}
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(a["B"], a["dim_p"], a["ns_p"], a["cone0"], 8,
                       tile_b=8, check_every=8 if a["exact_k"] else 1,
                       exact_k=a["exact_k"], lanes=lanes)


@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_plain_free_run_takes_tile_8_at_every_lanes(lanes):
    kw = dict(check_every=8, exact_k=False, lanes=lanes)
    plan = fk.launch_plan(8200, 288, 288, 256, 8, tile_b=8, **kw)
    # refill takes whole groups of 8 lanes, not whole blocks
    assert plan["lanes"] == lanes and plan["refill"]
    assert plan["blocks"] <= -(-8200 // lanes)
    with pytest.raises(ValueError, match="plain free-run"):
        fk.launch_plan(8192, 288, 288, 256, 8, tile_b=256, **kw)


def _group_runs(args, kw, perm):
    """The plain version on all groups of 8 lanes at once, on each group
    alone, and on the groups in the order `perm`."""
    z1, s0, lam0, *ops = args
    B = z1.shape[0]
    whole = fk.fused_hmpc_reference(z1, s0, lam0, *ops, **kw)
    alone = [fk.fused_hmpc_reference(z1[g:g + 8], s0[g:g + 8],
                                     lam0[g:g + 8], *ops, **kw)
             for g in range(0, B, 8)]
    rows = torch.cat([torch.arange(8 * g, 8 * g + 8) for g in perm])
    moved = fk.fused_hmpc_reference(z1[rows], s0[rows], lam0[rows], *ops,
                                    **kw)
    return whole, alone, rows, moved


@pytest.mark.parametrize("check_every", [1, 4])
def test_groups_do_not_depend_on_their_neighbours(fixture, check_every):
    """What refill relies on: in the checked mode and plain free-run
    (tile_b 8) each group of 8 lanes gets the same bits solved alone, in
    another order of the groups, or beside other groups."""
    sys, _, param, st = fixture
    x0, xr, ur = _data(st, 32, 12)
    x0[8:16] *= 0.05                # groups of unlike iteration counts
    xr[8:16] = 0.0
    args, fused = _fp64(sys, param, (x0, xr, ur))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, tile_b=8, check_every=check_every,
              exact_k=False)
    whole, alone, rows, moved = _group_runs(args, kw, (2, 0, 3, 1))
    assert len(set(whole[3].reshape(4, 8).amax(dim=1).tolist())) > 1
    for g, out in enumerate(alone):
        for a, b in zip(whole, out):
            assert torch.equal(a[8 * g:8 * g + 8], b), g
    for a, b in zip(whole, moved):
        assert torch.equal(a[rows], b)


def test_build_is_lazy_and_content_addressed():
    # importing the package built nothing
    assert _build.build_record("fused_hmpc") is None
    d = _build.source_digest("fused_hmpc")
    assert d == _build.source_digest("fused_hmpc") and len(d) == 16
    assert d != _build.source_digest("fused_split")
    src = (_build.CSRC / "fused_hmpc.cu").read_text()
    assert src.count("extern \"C\" int fused_hmpc_launch(") == 1
    assert f"MAX_G = {fk.MAX_CONES_PER_WARP};" in src
    # the C signature the wrapper binds: 17 pointers, 10 + 4 + 3 scalars,
    # the stream
    assert len(fk.FUSED_HMPC_ARGTYPES) == 35
    # the builds the wrapper plans for are the source's
    assert '#include "tile_product.cuh"' in src
    for lanes, (slab, blocks) in fk.BUILDS.items():
        assert f"#define HM_SLAB_{lanes} {slab}\n" in src
        assert f"#define HM_BLOCKS_{lanes} {blocks}\n" in src
        assert f"launch<{lanes}, true>(p, " in src
    assert f"NARROW = {stage.NARROW};" in src
    assert f"WIDE_SLAB = {stage.WIDE_BUILD[0]};" in src
