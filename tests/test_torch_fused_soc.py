"""The fused ellipMPC-ADMM-soc kernel's plain PyTorch version (the path CPU
tensors take through kernels/fused_soc.py) against the JAX package's fused
kernel run in Pallas interpret mode, mode for mode (checked, free-run,
exact-k, the k_max-capped path, a warm start, a per-lane radius, a
non-identity P), and against the JAX dense engine in fp64; plus the
wrapper's dispatch, validation and build plumbing, which need no GPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import _build
from spcies_tpu_torch.kernels import fused_soc as fk
from spcies_tpu_torch.solvers.fused_backend import FusedSOCSolve

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
# times their largest entry.
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7
KW = dict(rho=5.0, sigma=4.0, tol_p=1e-5, tol_d=1e-5, k_max=3000)
SOC = dict(formulation="ellipMPC", method="ADMM", submethod="soc")


@pytest.fixture(scope="module")
def fixture():
    """The tester plant with the bench's ellipsoid (P = I) and default
    radius 0.5 (test_ellipMPC_ADMM_soc.m with r = 0.5)."""
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = np.diag(np.sum(param["T"], axis=1))
    param["P"] = np.eye(len(st["xr"]))
    param["c"] = np.asarray(st["xr"])
    param["r"] = 0.5
    return sys, param, st


def _spd(param, seed=3):
    """A random SPD P (the cone rows through its square root)."""
    n = param["P"].shape[0]
    L = np.random.default_rng(seed).normal(0.0, 0.3, (n, n))
    return dict(param, P=L @ L.T + 0.5 * np.eye(n))


def _fused_pair(sys, param, **kw):
    """(JAX fused in interpret mode, port fused) at fp32."""
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("ellipMPC", "ADMM", "soc", tile_b=8,
                                **{**KW, **kw, **extra})
        o.precision = "float"
        out.append(pkg.make_solver(sys, param, **SOC, backend="fused",
                                   options=o, **_on_cpu(pkg)))
    return out


def _data(st, B, seed, radius=0.5):
    """Inputs with the radius as the 4th: a number for every lane, or a
    (low, high) range drawn per lane."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    r = (np.full((B, 1), radius) if np.isscalar(radius)
         else rng.uniform(*radius, (B, 1)))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1)), r


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
    for key in ("lam", "mu"):
        scale = max(1.0, float(np.abs(np.asarray(rj.sol[key])).max()))
        np.testing.assert_allclose(rt.sol[key].numpy()[same],
                                   np.asarray(rj.sol[key])[same], rtol=0,
                                   atol=atol * scale, err_msg=key)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=1e-4)


# r_d moves in steps of the fp32 ulps of O(1) iterates and hovers just
# under tol 1e-5 near the exit, so lanes sit at the tolerance boundary more
# often than in K1-K4. Seed 21 (the JAX package's own test seed for this
# kernel): lane 0 exits at k=229 here (r_d 9.9838e-6) and at 230 in the JAX
# run, lane 6 at 196 here (r_d 9.9987e-6) and at 197 there; in free-run
# lane 6 ends one window (4) apart. Mode -> (lanes, iterations apart).
MOVED = {"checked": ((0, 6), 1), "exact-k": ((0, 6), 1),
         "free-run": ((6,), 4)}
MODES = {
    "checked": {},
    "free-run": dict(check_every=4),
    "exact-k": dict(check_every=8, exact_k=True),
    "capped": dict(tol_p=1e-13, tol_d=1e-13, k_max=19),
    "capped-exact-k": dict(tol_p=1e-13, tol_d=1e-13, k_max=19,
                           check_every=8, exact_k=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_version_matches_jax_fused(fixture, mode):
    """Every mode of the kernel's plain version against the JAX fused
    kernel on the same inputs: per-lane k and e_flag, and the fp32
    iterates within the drift bound."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair(sys, param, **MODES[mode])
    x = _data(st, 8, 21)
    rt = s_t(*x)
    if mode.startswith("capped"):
        assert np.all(rt.k.numpy() == 19) and np.all(rt.e_flag.numpy() == -1)
    else:
        assert np.all(rt.e_flag.numpy() == 1)
    moved, step = MOVED.get(mode, ((), 1))
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8, moved, step)


# At the tolerance boundary: with the per-lane radius lane 1 exits at k=400
# in the JAX run (r_p 9.9987e-6) and one iteration later here; with the
# random P lane 7 exits at 227 here (r_d 9.9987e-6) and at 228 there.
MOVED_CASE = {"radius": (1,), "spd": (7,)}


@pytest.mark.parametrize("case", ["radius", "spd"])
def test_radius_and_P_match_jax_fused(fixture, case):
    """A per-lane radius in [0.01, 0.1], small enough that the cone binds,
    and a random SPD P: the JAX fused kernel's k and iterates."""
    sys, param, st = fixture
    if case == "spd":
        param = _spd(param)
    s_j, s_t = _fused_pair(sys, param, check_every=8, exact_k=True)
    x = _data(st, 8, 22, radius=(0.01, 0.1))
    rt = s_t(*x)
    assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8, MOVED_CASE[case])


def test_warm_start_matches_jax_fused(fixture):
    """A warm start from the port's fp64 dense solution: the prologue's
    q_hat from (z, s, lam, mu), held to the JAX kernel's result."""
    sys, param, st = fixture
    x = _data(st, 8, 24)
    rd = tsp.make_solver(sys, param, **SOC, **dict(KW, k_max=60),
                         device="cpu")(*x)
    init = tuple(rd.sol[key].float() for key in ("z", "s", "lam", "mu"))
    s_j, s_t = _fused_pair(sys, param)
    rt = s_t(*x, init=init)
    assert bool((rt.k < s_t(*x).k).all())
    _assert_parity(s_j(*x, init=tuple(a.numpy() for a in init)), rt,
                   int(rt.k.max()) + 8)


def _fp64(sys, param, x, **kw):
    """The kernel's arguments in fp64 from the port's fp64 ingredients."""
    opt = tsp.default_options("ellipMPC", "ADMM", "soc", tile_b=8,
                              **{**KW, **kw})
    mod = tsp.formulations.ellipmpc
    ing = mod.ellipmpc_admm_soc_ingredients(sys, param, opt)
    fused = FusedSOCSolve(ing, opt, "cpu", dtype=torch.float64,
                          make_q=lambda xr, ur: mod._soc_q(ing, xr, ur,
                                                           torch.float64))
    *kin, _ = fused.prepare(*(torch.as_tensor(a) for a in x))
    return (*kin, *fused.operator), fused


@pytest.mark.parametrize("check_every,exact_k,radius",
                         [(1, False, 0.5), (8, True, 0.5),
                          (1, False, (0.01, 0.1))])
def test_plain_version_fp64_matches_jax_dense(fixture, check_every, exact_k,
                                              radius):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates within 1e-9, a per-lane
    radius included; pad entries stay exactly 0."""
    sys, param, st = fixture
    x = _data(st, 8, 5, radius=radius)
    args, fused = _fp64(sys, param, x)
    kw = dict(fused.kernel_kw, tol_p=1e-7, tol_d=1e-7, k_max=5000,
              check_every=check_every, exact_k=exact_k)
    zs, lm, aux, k, e, r_p, r_d = fk.fused_soc_reference(*args, **kw)
    rj = jsp.make_solver(sys, param, **SOC, **dict(KW, tol_p=1e-7,
                                                   tol_d=1e-7,
                                                   k_max=5000))(*x)
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
    for a in fk.fused_soc_reference(*args, **kw)[:3]:
        assert torch.all(a[:, pad] == 0)


def test_free_run_plain_version_drains_per_tile(fixture):
    """Plain free-run: converged lanes keep iterating until their tile is
    done, so with tile_b=16 the early tile's lanes carry later iterates
    than with tile_b=8, while k and the residuals stay at their exit."""
    sys, param, st = fixture
    args, fused = _fp64(sys, param, _data(st, 16, 4))
    args = tuple(a.float() for a in args)
    kw = dict(fused.kernel_kw, check_every=4)
    kw.pop("tile_b")
    o8 = fk.fused_soc_reference(*args, tile_b=8, **kw)
    o16 = fk.fused_soc_reference(*args, tile_b=16, **kw)
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
    kw = dict(fused.kernel_kw, k_max=500, check_every=8, exact_k=True)
    before = fk.fused_soc_solve.launches
    got = fk.fused_soc_solve(*args, **kw)
    want = fk.fused_soc_reference(*args, **kw)
    assert fk.fused_soc_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    t = torch.zeros((8, 96))
    head = torch.zeros((1, 64))
    row = torch.zeros((1, 96))
    ok = (t, t, t, torch.zeros((96, 96)), head, head, row, row)
    kw = dict(dim_p=64, tol_p=1e-4, tol_d=1e-4, k_max=10, tile_b=8)

    def call(i, repl, **extra):
        a = list(ok)
        a[i] = repl
        return fk.fused_soc_solve(*a, **{**kw, **extra})

    with pytest.raises(ValueError, match="share one shape"):
        call(2, torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="M1P"):
        call(3, torch.zeros((96, 64)))
    with pytest.raises(ValueError, match="M1P"):
        call(4, torch.zeros((1, 96)))
    with pytest.raises(ValueError, match="split"):
        call(0, t, dim_p=96)
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_soc_solve(*(a[:6] for a in ok[:3]), *ok[3:], **kw)
    with pytest.raises(ValueError, match="one device"):
        call(0, torch.empty((8, 96), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_soc_solve(*(a.to("meta") for a in ok), **kw)
    # the launch path refuses what the kernel does not take, before any
    # build
    lk = dict(kw, check_every=1, exact_k=False)
    with pytest.raises(TypeError, match="float32"):
        fk._launch(*(a.double() for a in ok), **lk)
    with pytest.raises(ValueError, match="contiguous"):
        fk._launch(t.T.contiguous().T, *ok[1:], **lk)
    with pytest.raises(ValueError, match="one warp"):
        fk._launch(*ok, **dict(lk, dim_p=32))


def test_launch_geometry():
    # the N=30 shape: dim = 241 pads to 256, the cone's 7 entries to 32.
    # Plain free-run refills persistent blocks of 32 lanes, one an SM: the
    # state and the 32-row slabs of M1' take all but 4 KB of its shared
    # memory
    for B in (8192, 32768):
        kw = dict(tile_b=8, check_every=8, exact_k=False)
        plan = fk.launch_plan(B, 288, 256, **kw)
        assert plan == dict(lanes=32, blocks=132, threads=288,
                            smem=fk.shared_bytes(288, 32), refill=True)
        assert fk.launch_geometry(B, 288, 256, **kw) == (132, 288,
                                                         plan["smem"])
    assert fk.shared_bytes(288, 32) == 4 * (
        2 * 32 * 288 + 16 + 288 * (4 * 32 + 4) + 9 * 2 * 32 + 4 + 5 * 32)
    assert fk.shared_bytes(288, 32) <= 232448
    # exact-k keeps one block per L lanes: at a small batch, 8
    assert fk.launch_geometry(256, 128, 96, tile_b=256, check_every=8,
                              exact_k=True)[:2] == (32, 128)
    # above 320 columns: 16-row slabs, one block an SM, at most 16 lanes
    plan = fk.launch_plan(8192, 512, 480, tile_b=8, check_every=8,
                          exact_k=False)
    assert plan["lanes"] == 16 and plan["blocks"] == 132
    assert plan["smem"] == fk.shared_bytes(512, 16) <= 232448
    bad = [
        dict(P=120, dim_p=96),            # not whole warps
        dict(P=1056, dim_p=1024),         # beyond every build (1024)
        dict(P=160, dim_p=96),            # an s slab of two warps
        dict(tile_b=12, B=48),            # tile not whole groups of 8
        dict(tile_b=32, B=48),            # batch not whole tiles
        dict(tile_b=256, B=256, check_every=8),   # drain per group
    ]
    for b in bad:
        g = {**dict(B=64, P=128, dim_p=96, tile_b=8, check_every=1), **b}
        with pytest.raises(ValueError):
            fk.launch_geometry(g["B"], g["P"], g["dim_p"], tile_b=g["tile_b"],
                               check_every=g["check_every"], exact_k=False)


@pytest.mark.parametrize("lanes,kw", [
    (64, {}),                              # no such build
    (32, dict(P=352, dim_p=320)),          # above 320 columns
    (16, dict(B=8200, exact_k=True)),      # exact-k: not whole blocks
])
def test_named_builds_are_refused(lanes, kw):
    a = {**dict(B=8192, P=288, dim_p=256, exact_k=False), **kw}
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(a["B"], a["P"], a["dim_p"], tile_b=8,
                       check_every=8 if a["exact_k"] else 1,
                       exact_k=a["exact_k"], lanes=lanes)


@pytest.mark.parametrize("check_every", [1, 4])
def test_groups_do_not_depend_on_their_neighbours(fixture, check_every):
    """What refill relies on: in the checked mode and plain free-run
    (tile_b 8) each group of 8 lanes gets the same bits solved alone, in
    another order of the groups, or beside other groups."""
    sys, param, st = fixture
    x0, xr, ur, r = _data(st, 32, 12)
    x0[8:16] *= 0.05                # groups of unlike iteration counts
    args, fused = _fp64(sys, param, (x0, xr, ur, r))
    aux1, zs0, lm0, *ops = (a.float() for a in args)
    kw = dict(fused.kernel_kw, tile_b=8, check_every=check_every,
              exact_k=False)
    whole = fk.fused_soc_reference(aux1, zs0, lm0, *ops, **kw)
    assert len(set(whole[3].reshape(4, 8).amax(dim=1).tolist())) > 1
    for g in range(0, 32, 8):
        out = fk.fused_soc_reference(aux1[g:g + 8], zs0[g:g + 8],
                                     lm0[g:g + 8], *ops, **kw)
        for a, b in zip(whole, out):
            assert torch.equal(a[g:g + 8], b), g
    rows = torch.cat([torch.arange(8 * g, 8 * g + 8) for g in (2, 0, 3, 1)])
    moved = fk.fused_soc_reference(aux1[rows], zs0[rows], lm0[rows], *ops,
                                   **kw)
    for a, b in zip(whole, moved):
        assert torch.equal(a[rows], b)


def test_build_is_lazy_and_content_addressed():
    # importing the package built nothing
    assert _build.build_record("fused_soc") is None
    d = _build.source_digest("fused_soc")
    assert d == _build.source_digest("fused_soc") and len(d) == 16
    assert d != _build.source_digest("fused_ellip")
    src = (_build.CSRC / "fused_soc.cu").read_text()
    assert src.count("extern \"C\" int fused_soc_launch(") == 1
    assert f"NSNAP = {fk.SNAP_LEAVES};" in src
    # the C signature the wrapper binds: 17 pointers, 7 + 2 + 3 scalars,
    # the stream
    assert len(fk.FUSED_SOC_ARGTYPES) == 30
    # the builds the wrapper plans for are the source's
    assert '#include "tile_product.cuh"' in src
    for lanes, (slab, blocks) in fk.BUILDS.items():
        assert f"#define SOC_SLAB_{lanes} {slab}\n" in src
        assert f"#define SOC_BLOCKS_{lanes} {blocks}\n" in src
        assert f"launch<{lanes}, true>(p, " in src
    # no tensor-core product and no library product in the launched source
    assert "mma" not in src and "cublas" not in src.lower()
