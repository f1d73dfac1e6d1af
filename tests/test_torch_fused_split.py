"""The fused two-block split (S)ADMM kernel's plain PyTorch version (the
path CPU tensors take through kernels/fused_split.py) against the JAX
package's fused kernel run in Pallas interpret mode, mode for mode
(checked, free-run, exact-k, the k_max-capped path, a warm start; ADMM and
SADMM; diamond and shifted-SOC cones; box and output mode), exact-k
against the checked mode bit for bit, and against the JAX dense engine in
fp64; plus the wrapper's dispatch, validation and build plumbing, which
need no GPU."""

import re

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.formulations import hmpc as th
from spcies_tpu_torch.kernels import _build
from spcies_tpu_torch.kernels import fused_split as fk
from spcies_tpu_torch.solvers.fused_backend import FusedSplitSolve

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


# fp32 iterates: the two frameworks sum the [P] x [P, P] product in
# different orders, and each iteration adds about one fp32 ulp to the gap
# between the runs, so iterates and residuals are held to 1e-5, or 2e-7
# per iteration run where that is more; the duals lam and mu to that bound
# times their largest entry, plus a few fp32 ulps of the primal block each
# is updated from (mu += rho (s_hat - s) with s of the shifted-SOC pairs
# near their O(1e3) offsets, where one ulp is 6e-5).
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7
ULPS = 4 * float(np.finfo(np.float32).eps)
# rho = sigma = 2, the bench's N=10 split settings (bench.py:267-268).
# use_soc stalls near 4e-4 in fp32 on this fixture in both packages
# (tests/test_hmpc.py:147-150), so its cases run at tol 1e-3.
KW = dict(rho=2.0, sigma=2.0, tol_p=1e-5, tol_d=1e-5, k_max=3000)
SOC_TOL = dict(tol_p=1e-3, tol_d=1e-3)
METHODS = {"ADMM": {}, "SADMM": dict(alpha=0.95)}


@pytest.fixture(scope="module")
def fixture():
    """The HMPC tester fixture (tests/test_hmpc.py:14-25) and its
    coupled-output variant (the three mass positions within +-0.3)."""
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


def _data(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _options(pkg, method, **kw):
    o = pkg.default_options("HMPC", method, "split", tile_b=8,
                            **{**KW, **METHODS[method], **kw})
    o.precision = "float"
    return o


def _fused(pkg, sys, param, method, **kw):
    """The fused solver of `pkg` at fp32; the JAX kernel in interpret
    mode."""
    extra = dict(pallas_interpret=True) if pkg is jsp else {}
    return pkg.make_solver(sys, param, formulation="HMPC", method=method,
                           submethod="split", backend="fused",
                           options=_options(pkg, method, **kw, **extra),
                           **_on_cpu(pkg))


def _fused_pair(sys, param, method, **kw):
    """(JAX fused in interpret mode, port fused) at fp32."""
    return [_fused(pkg, sys, param, method, **kw) for pkg in (jsp, tsp)]


KEYS = ("z", "s", "z_hat", "s_hat", "r_p", "r_d")


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
    for key, primal in (("lam", "z"), ("mu", "s")):
        scale = max(1.0, float(np.abs(np.asarray(rj.sol[key])).max()))
        ulps = ULPS * float(np.abs(np.asarray(rj.sol[primal])).max())
        np.testing.assert_allclose(rt.sol[key].numpy()[same],
                                   np.asarray(rj.sol[key])[same], rtol=0,
                                   atol=atol * scale + ulps, err_msg=key)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-4)


MODES = {
    "checked": {},
    "free-run": dict(check_every=4),
    "exact-k": dict(check_every=8, exact_k=True),
    "capped": dict(tol_p=1e-13, tol_d=1e-13, k_max=19),
}


# every mode with ADMM, SADMM's half-step in checked and exact-k mode; the
# capped exact-k path equals the capped checked one bit for bit
# (test_exact_k_bit_identical_to_checked)
@pytest.mark.parametrize("mode,method", [
    *((mode, "ADMM") for mode in MODES), ("checked", "SADMM"),
    ("exact-k", "SADMM")])
def test_plain_version_matches_jax_fused(fixture, mode, method):
    """Each mode of the kernel's plain version against the JAX fused
    kernel on the same inputs: per-lane k and e_flag, and the fp32 iterates
    within the drift bound."""
    sys, _, param, st = fixture
    s_j, s_t = _fused_pair(sys, param, method, **MODES[mode])
    x = _data(st, 8, 7)
    rt = s_t(*x)
    if mode == "capped":
        assert np.all(rt.k.numpy() == 19) and np.all(rt.e_flag.numpy() == -1)
    else:
        assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8)


@pytest.mark.parametrize("case,method", [("soc", "SADMM"),
                                         ("output", "ADMM")])
def test_soc_and_output_mode_match_jax_fused(fixture, case, method):
    """Shifted-SOC cones (16 in two warps, tol 1e-3) with SADMM, and
    output mode (box rows on the s slab, the whole z slab free) with ADMM,
    in exact-k, against the JAX fused kernel."""
    sys, sys_e, param, st = fixture
    kw = dict(check_every=8, exact_k=True)
    if case == "soc":
        kw.update(use_soc=True, **SOC_TOL)
    s_j, s_t = _fused_pair(sys_e if case == "output" else sys, param,
                           method, **kw)
    x = _data(st, 8, 7)
    rt = s_t(*x)
    assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_warm_start_matches_jax_fused(fixture, method):
    """A warm start from the port's fp64 dense solution: the prologue's
    q_hat from (z, s, lam, mu), held to the JAX kernel's result."""
    sys, _, param, st = fixture
    x = _data(st, 8, 24)
    rd = tsp.make_solver(sys, param, formulation="HMPC", method=method,
                         submethod="split",
                         **dict(KW, **METHODS[method], k_max=40),
                         device="cpu")(*x)
    init = tuple(rd.sol[key].float() for key in ("z", "s", "lam", "mu"))
    s_j, s_t = _fused_pair(sys, param, method)
    rt = s_t(*x, init=init)
    assert bool((rt.k < s_t(*x).k).all())
    _assert_parity(s_j(*x, init=tuple(a.numpy() for a in init)), rt,
                   int(rt.k.max()) + 8, MOVED_WARM[method])


# At the tolerance boundary: warm-started ADMM's lane 7 exits at k=82 in
# the JAX run (r_d 9.984e-6) and at 83 here (r_d 1.0014e-5 at 82).
MOVED_WARM = {"ADMM": (7,), "SADMM": ()}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_exact_k_bit_identical_to_checked(fixture, method):
    """exact_k (window snapshots + replay) equals the checked mode bit for
    bit (k, e_flag, every iterate), including the k_max-capped path, as
    tests/test_hmpc.py:337 holds the JAX kernel."""
    sys, _, param, st = fixture
    x = _data(st, 8, 13)
    for cap in ({}, dict(tol_p=1e-13, tol_d=1e-13, k_max=19)):
        r1 = _fused(tsp, sys, param, method, **cap)(*x)
        r2 = _fused(tsp, sys, param, method, check_every=8, exact_k=True,
                    **cap)(*x)
        assert torch.equal(r1.k, r2.k) and torch.equal(r1.e_flag, r2.e_flag)
        for key, val in r1.sol.items():
            if torch.is_tensor(val):
                assert torch.equal(val, r2.sol[key]), key


def _fp64(sys, param, x, method, **kw):
    """The kernel's arguments in fp64 from the port's fp64 ingredients."""
    opt = tsp.default_options("HMPC", method, "split", tile_b=8,
                              **{**KW, **METHODS[method], **kw})
    ing = th.hmpc_common_ingredients(sys, param, opt, split=True)
    M1, M2 = th.split_kkt(ing, opt.solver["rho"], opt.solver["sigma"])
    fused = FusedSplitSolve(ing, opt, "cpu", M1, M2,
                            make_q=th.hmpc_q_maker(ing, torch.float64, "cpu"),
                            symmetric=method == "SADMM",
                            dtype=torch.float64)
    *kin, _ = fused.prepare(*(torch.as_tensor(a) for a in x))
    return (*kin, *fused.operator), fused


@pytest.mark.parametrize("method,case,check_every,exact_k", [
    ("ADMM", "diamond", 1, False), ("ADMM", "soc", 8, True),
    ("SADMM", "diamond", 8, True), ("SADMM", "output", 1, False)])
def test_plain_version_fp64_matches_jax_dense(fixture, method, case,
                                              check_every, exact_k):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates within 1e-9; pad entries
    stay exactly 0."""
    sys, sys_e, param, st = fixture
    sys = sys_e if case == "output" else sys
    kw = dict(use_soc=case == "soc", tol_p=1e-7, tol_d=1e-7, k_max=5000)
    x = _data(st, 8, 5)
    args, fused = _fp64(sys, param, x, method, **kw)
    kk = dict(fused.kernel_kw, check_every=check_every, exact_k=exact_k)
    zs, lm, aux, k, e, r_p, r_d = fk.fused_split_reference(*args, **kk)
    rj = jsp.make_solver(sys, param, formulation="HMPC", method=method,
                         submethod="split",
                         **{**KW, **METHODS[method], **kw})(*x)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(e.numpy(), np.asarray(rj.e_flag))
    pos = torch.as_tensor(fused.pos)
    dim = fused.dim
    zs, lm, aux = zs[:, pos], lm[:, pos], aux[:, pos]
    for got, key in ((zs[:, :dim], "z"), (zs[:, dim:], "s"),
                     (aux[:, :dim], "z_hat"), (aux[:, dim:], "s_hat"),
                     (lm[:, :dim], "lam"), (lm[:, dim:], "mu"),
                     (r_p, "r_p"), (r_d, "r_d")):
        np.testing.assert_allclose(got.numpy(), np.asarray(rj.sol[key]),
                                   rtol=0, atol=1e-9, err_msg=key)
    pad = np.setdiff1d(np.arange(args[0].shape[1]), fused.pos)
    for a in fk.fused_split_reference(*args, **kk)[:3]:
        assert torch.all(a[:, pad] == 0)


def test_layout_of_the_split_state(fixture):
    """Box mode at N=10: z 98 -> 128 columns, one warp of 8 diamonds
    (P = 160); use_soc: two warps of 8 SOCs (P = 192); output mode: the
    30 box rows from column 128, the cones from 160 (P = 192). The head
    rows clip the stage entries (or the s box rows), free the harmonic
    ones and pin the pads."""
    sys, sys_e, param, st = fixture
    for s, kw, P, cone0 in ((sys, {}, 160, 128),
                            (sys, dict(use_soc=True), 192, 128),
                            (sys_e, {}, 192, 160)):
        args, fused = _fp64(s, param, _data(st, 8, 1), "ADMM", **kw)
        assert args[0].shape[1] == P and fused.kernel_kw["cone0"] == cone0
        lb, ub, scale, iscale = (r[0] for r in args[4:])
        real = torch.zeros(P, dtype=torch.bool)
        real[torch.as_tensor(fused.pos)] = True
        assert torch.all(iscale[~real] == 0) and torch.all(iscale[real] > 0)
        assert torch.all((lb[~real] == 0) & (ub[~real] == 0))
        free = torch.isclose(ub, torch.tensor(3.0e38, dtype=ub.dtype))
        ns, dim = fused.dim - 24, fused.dim
        assert int(free.sum()) == (24 if s is sys else dim)
        assert torch.all(scale[:128] == 2.0) and torch.all(scale[128:] == 2.0)


def test_free_run_plain_version_drains_per_tile(fixture):
    """Plain free-run: converged lanes keep iterating until their tile is
    done, so with tile_b=16 the early tile's lanes carry later iterates
    than with tile_b=8, while k and the residuals stay at their exit."""
    sys, _, param, st = fixture
    x0, xr, ur = _data(st, 16, 4)
    x0[:8] *= 0.05          # an easy first tile: it drains long before
    xr[:8] = 0.0            # the second
    args, fused = _fp64(sys, param, (x0, xr, ur), "ADMM")
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, check_every=4)
    kw.pop("tile_b")
    o8 = fk.fused_split_reference(*args, tile_b=8, **kw)
    o16 = fk.fused_split_reference(*args, tile_b=16, **kw)
    for i in (3, 4, 5, 6):
        assert torch.equal(o8[i], o16[i]), i
    slow = o8[3].reshape(2, 8).amax(dim=1)
    early, late = (0, 1) if slow[0] < slow[1] else (1, 0)
    assert slow[early] < slow[late]
    rows = slice(8 * late, 8 * late + 8)
    assert torch.equal(o8[0][rows], o16[0][rows])
    rows = slice(8 * early, 8 * early + 8)
    assert bool(((o8[0][rows] - o16[0][rows]).abs().amax(dim=1) > 0).all())


def _group_runs(args, kw, perm):
    """The plain version on all groups of 8 lanes at once, on each group
    alone, and on the groups in the order `perm`."""
    aux1, zs0, lm0, *ops = args
    B = aux1.shape[0]
    whole = fk.fused_split_reference(aux1, zs0, lm0, *ops, **kw)
    alone = [fk.fused_split_reference(aux1[g:g + 8], zs0[g:g + 8],
                                      lm0[g:g + 8], *ops, **kw)
             for g in range(0, B, 8)]
    rows = torch.cat([torch.arange(8 * g, 8 * g + 8) for g in perm])
    moved = fk.fused_split_reference(aux1[rows], zs0[rows], lm0[rows], *ops,
                                     **kw)
    return whole, alone, rows, moved


# (method, case): ADMM and SADMM, diamonds, shifted SOCs (tol 1e-3) and
# output mode, and each group cut at k_max 19
GROUP_CASES = [("ADMM", "diamond"), ("SADMM", "diamond"), ("ADMM", "soc"),
               ("SADMM", "output"), ("SADMM", "capped")]


@pytest.mark.parametrize("method,case", GROUP_CASES)
def test_exact_k_groups_do_not_depend_on_their_neighbours(fixture, method,
                                                          case):
    """What refill in exact-k relies on: each group of 8 lanes gets the
    same bits (iterates, k, e_flag, residuals) solved alone, in another
    order of the groups, or beside other groups, though the windows of the
    whole batch run on until its slowest lane is done."""
    sys, sys_e, param, st = fixture
    x0, xr, ur = _data(st, 32, 12)
    x0[8:16] *= 0.05                # groups of unlike iteration counts
    xr[8:16] = 0.0
    kw = {"soc": dict(use_soc=True, **SOC_TOL),
          "capped": dict(tol_p=1e-13, tol_d=1e-13, k_max=19)}.get(case, {})
    args, fused = _fp64(sys_e if case == "output" else sys, param,
                        (x0, xr, ur), method, **kw)
    args = tuple(a.float() for a in args)
    kk = dict(fused.kernel_kw, tile_b=8, check_every=8, exact_k=True)
    whole, alone, rows, moved = _group_runs(args, kk, (2, 0, 3, 1))
    groups = whole[3].reshape(4, 8).amax(dim=1).tolist()
    if case == "capped":
        assert groups == [19] * 4 and bool((whole[4] == -1).all())
    else:
        assert len(set(groups)) > 1 and bool((whole[4] == 1).all())
    for g, out in enumerate(alone):
        for a, b in zip(whole, out):
            assert torch.equal(a[8 * g:8 * g + 8], b), g
    for a, b in zip(whole, moved):
        assert torch.equal(a[rows], b)


def test_wrapper_takes_plain_version_on_cpu(fixture):
    """For CPU tensors the wrapper returns the plain version's results and
    launches nothing."""
    sys, _, param, st = fixture
    args, fused = _fp64(sys, param, _data(st, 8, 6), "SADMM")
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, k_max=500, check_every=8, exact_k=True)
    before = fk.fused_split_solve.launches
    got = fk.fused_split_solve(*args, **kw)
    want = fk.fused_split_reference(*args, **kw)
    assert fk.fused_split_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    t = torch.zeros((8, 96))
    row = torch.zeros((1, 96))
    ok = (t, t, t, torch.zeros((96, 96)), row, row, row, row)
    kw = dict(alpha=1.0, symmetric=False, use_soc=False, dim_p=64,
              cone0=64, cone_g=8, tol_p=1e-4, tol_d=1e-4, k_max=10,
              tile_b=8)

    def call(i, repl, **extra):
        a = list(ok)
        a[i] = repl
        return fk.fused_split_solve(*a, **{**kw, **extra})

    with pytest.raises(ValueError, match="share one shape"):
        call(2, torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="M1P"):
        call(3, torch.zeros((96, 64)))
    with pytest.raises(ValueError, match="M1P"):
        call(4, torch.zeros((1, 64)))
    with pytest.raises(ValueError, match="before the cones"):
        call(0, t, dim_p=96)
    with pytest.raises(ValueError, match="whole warps"):
        call(0, t, cone0=80)
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_split_solve(*(a[:6] for a in ok[:3]), *ok[3:], **kw)
    with pytest.raises(ValueError, match="one device"):
        call(0, torch.empty((8, 96), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_split_solve(*(a.to("meta") for a in ok), **kw)
    # the launch path refuses what the kernel does not take, before any
    # build
    lk = dict(kw, check_every=1, exact_k=False)
    with pytest.raises(TypeError, match="float32"):
        fk._launch(*(a.double() for a in ok), **lk)
    with pytest.raises(ValueError, match="contiguous"):
        fk._launch(t.T.contiguous().T, *ok[1:], **lk)


def test_launch_geometry():
    # the N=30 shapes: z 258 -> 288 and one warp of 8 diamonds (320), or
    # two warps of 8 SOCs (352). Every mode refills persistent blocks; each
    # shape takes the widest build whose shared memory fits.
    for (P, g), lanes in (((320, 8), 32), ((352, 8), 16)):
        for B in (8192, 32768):
            kw = dict(tile_b=256, check_every=8, exact_k=True)
            plan = fk.launch_plan(B, P, 288, 288, g, **kw)
            per_sm = min(fk.BUILDS[lanes][1] if P <= 320 else 1,
                         233472 // (plan["smem"] + 1024))
            assert plan == dict(lanes=lanes, blocks=132 * per_sm, threads=P,
                                smem=fk.shared_bytes(P, lanes), refill=True)
            assert fk.launch_geometry(B, P, 288, 288, g, **kw) == (
                plan["blocks"], plan["threads"], plan["smem"])
    bad = [
        dict(P=120),                       # not whole warps
        dict(P=1056, cone0=1024),          # beyond every build (1024)
        dict(dim_p=80),                    # a z slab not of whole warps
        dict(dim_p=128),                   # the z slab past the cones
        dict(cone0=128),                   # no cone warp
        dict(g=11),                        # more cones than a warp holds
        dict(tile_b=12, B=48),             # tile not whole groups of 8
        dict(tile_b=32, B=48),             # batch not whole tiles
        dict(tile_b=256, B=256, check_every=8),   # drain per group
    ]
    for b in bad:
        a = {**dict(B=64, P=128, dim_p=96, cone0=96, g=8, tile_b=8,
                    check_every=1), **b}
        with pytest.raises(ValueError):
            fk.launch_geometry(a["B"], a["P"], a["dim_p"], a["cone0"],
                               a["g"], tile_b=a["tile_b"],
                               check_every=a["check_every"], exact_k=False)


# (batch, padded width) -> lanes a block the dispatch picks: the HMPC
# families at both batches, the use_soc width, the widest shape of one
# thread a column and a request of 64 lanes
SHAPES = {(8192, 320): 32, (32768, 320): 32, (8192, 352): 16,
          (4096, 512): 16, (64, 320): 8}
PLAN_MODES = {"checked": dict(check_every=1, exact_k=False),
              "free-run": dict(check_every=8, exact_k=False),
              "exact-k": dict(check_every=8, exact_k=True)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_launch_geometry_by_shape(shape):
    B, P = shape
    cone0 = P - 32
    for mode, kw in PLAN_MODES.items():
        tile_b = 8 if mode == "free-run" or B < 256 else 256
        blocks, threads, smem = fk.launch_geometry(
            B, P, 288, cone0, 8, tile_b=tile_b, **kw)
        plan = fk.launch_plan(B, P, 288, cone0, 8, tile_b=tile_b, **kw)
        # refill in every mode: at most one block per L lanes, every slot
        # with a group to start with, one column a thread
        L = plan["lanes"]
        assert L == SHAPES[shape] and plan["refill"], mode
        assert threads == P and 1 <= blocks <= -(-B // L)
        assert blocks * L // 8 <= B // 8
        assert smem == fk.shared_bytes(P, L) <= 232448


def _source_smem(P, lanes):
    """fused_split_smem of csrc/fused_split.cu, its text evaluated."""
    src = (_build.CSRC / "fused_split.cu").read_text()
    body = src[src.index('extern "C" long fused_split_smem('):]
    expr = body[body.index("return") + 6:body.index(";")]
    slab = {8: r"SP_SLAB_8 (\d+)", 16: r"SP_SLAB_16 (\d+)",
            32: r"SP_SLAB_32 (\d+)"}[lanes]
    rows = (int(re.search(r"WIDE_SLAB = (\d+);", src).group(1)) if P > 320
            else int(re.search(r"#define " + slab, src).group(1)))
    expr = expr.replace("tp::ring_bytes(P, slab_rows(P, lanes))",
                        f"(4 * 2 * {rows} * P + 64)")
    expr = re.sub(r"static_cast<long>\(([^)]*)\)", r"\1", expr)
    expr = re.sub(r"(\d)L\b", r"\1", expr).replace("tp::DQ_PAD", "4")
    expr = expr.replace("/", "//")
    return eval(f"({expr})", {}, dict(P=P, lanes=lanes))


@pytest.mark.parametrize("P", [160, 320, 352, 512])
def test_shared_bytes_follow_the_source_formula(P):
    """Python's shared bytes are the C source's (its slab rows, the ring of
    two slabs and its mbarriers, the leaves, dq, the row maxima and the
    masks), and the plan never takes a build past 232,448 bytes."""
    for lanes in (8, 16, 32):
        assert fk.shared_bytes(P, lanes) == _source_smem(P, lanes)
        takes = lanes < 32 or P <= 320
        if fk.shared_bytes(P, lanes) <= 232448 and takes:
            plan = fk.launch_plan(8192, P, P - 64, P - 32, 8, tile_b=256,
                                  check_every=8, exact_k=True, lanes=lanes)
            assert plan["smem"] == fk.shared_bytes(P, lanes)
        else:
            with pytest.raises(ValueError, match="no build"):
                fk.launch_plan(8192, P, P - 64, P - 32, 8, tile_b=256,
                               check_every=8, exact_k=True, lanes=lanes)


@pytest.mark.parametrize("lanes,kw", [
    (64, {}),                              # no such build
    (4, {}),
    (32, dict(P=352)),                     # use_soc: 234,064 bytes
    (32, dict(P=384)),                     # above 320 columns
    # the wide build runs 16 lanes up to its cap of 1024 columns, no wider
    (16, dict(wide=True, P=1056, match="up to 1024")),
])
def test_named_builds_are_refused(lanes, kw):
    a = {**dict(P=320, wide=None, match="no build"), **kw}
    with pytest.raises(ValueError, match=a["match"]):
        fk.launch_plan(8192, a["P"], 288, a["P"] - 32, 8, tile_b=256,
                       check_every=8, exact_k=True, lanes=lanes,
                       wide=a["wide"])


@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_plain_free_run_takes_tile_8_at_every_lanes(lanes):
    for kw in (dict(check_every=8, exact_k=False),
               dict(check_every=8, exact_k=True)):
        plan = fk.launch_plan(8200, 320, 288, 288, 8, tile_b=8, lanes=lanes,
                              **kw)
        # refill takes whole groups of 8 lanes, not whole blocks
        assert plan["lanes"] == lanes and plan["refill"]
        assert plan["blocks"] <= -(-8200 // lanes)
    with pytest.raises(ValueError, match="plain free-run"):
        fk.launch_plan(8192, 320, 288, 288, 8, tile_b=256, lanes=lanes,
                       check_every=8, exact_k=False)


def test_lanes_constant_is_the_kernels_own():
    from spcies_tpu_torch.kernels import fused_admm, stage
    assert not hasattr(fused_admm, "CTA_LANES")
    assert not hasattr(fk, "CTA_LANES")
    src = (_build.CSRC / "fused_split.cu").read_text()
    # the builds the wrapper plans for are the source's, each lanes a block
    # with refill (and exact-k's refill) and without
    for lanes, (slab, blocks) in fk.BUILDS.items():
        assert f"#define SP_SLAB_{lanes} {slab}\n" in src
        assert f"#define SP_BLOCKS_{lanes} {blocks}\n" in src
        assert f"launch_lanes<{lanes}>(p, " in src
    for build in ("<L, false, false>", "<L, true, true>", "<L, true, false>"):
        assert f"launch{build}(p, " in src
    assert f"NARROW = {stage.NARROW};" in src
    assert f"WIDE_SLAB = {stage.WIDE_BUILD[0]};" in src
    # the launched source, its wide build too, runs on the product stage
    assert _build.included_files(_build.CSRC / "fused_split.cu") == [
        _build.CSRC / "fused_split.cu", _build.CSRC / "tile_product.cuh"]
    # exact-k opts in to the stage's refill, and the kernel keeps no mode
    # loop of its own, in the narrow builds or the wide
    assert src.count("tp::run_lanes<L, REFILL, EXACT>") == 2
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for own in ("snapshot<", "REPLAY", "budget", "sn_k[", "for (int it"):
        assert own not in code, own


def test_build_is_lazy_and_content_addressed():
    # importing the package built nothing
    assert _build.build_record("fused_split") is None
    d = _build.source_digest("fused_split")
    assert d == _build.source_digest("fused_split") and len(d) == 16
    assert d != _build.source_digest("fused_soc")
    src = (_build.CSRC / "fused_split.cu").read_text()
    assert src.count("extern \"C\" int fused_split_launch(") == 1
    assert f"NSNAP = {fk.SNAP_LEAVES};" in src
    # the C signature the wrapper binds: 18 pointers, 12 + 3 + 3 scalars,
    # the stream
    assert len(fk.FUSED_SPLIT_ARGTYPES) == 37
