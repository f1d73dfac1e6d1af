"""The fused MPCT-EADMM kernel's plain PyTorch version (the path CPU tensors
take through kernels/fused_eadmm.py) against the JAX package's fused kernel
run in Pallas interpret mode, mode for mode (checked, free-run, exact-k,
the k_max-capped path, a warm start), and against the JAX dense engine in
fp64; plus the wrapper's dispatch, validation and build plumbing, which
need no GPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp
from spcies_tpu.kernels.fused_eadmm import fused_eadmm_solve as jax_kernel

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import _build, stage
from spcies_tpu_torch.kernels import fused_eadmm as fk
from spcies_tpu_torch.kernels.fused_admm import SMEM_MAX
from spcies_tpu_torch.solvers.fused_backend import FusedEADMMSolve

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
# On this fixture max|dz| reaches 1.2e-5 after at most 155 iterations, so
# the iterates and residuals are held to 1e-5, or 2e-7 per iteration run
# where that is more. lam's entries reach 32 here (the z's stay below 5),
# and its ulp grows with it: lam is held to that bound times max|lam|.
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7
KW = dict(rho_base=2.0, rho_mult=20.0, tol=1e-5, k_max=3000)


@pytest.fixture(scope="module")
def fixture():
    sys, param, st = tsp.systems.tester_fixture()
    param = dict(param)
    param["T"] = 10.0 * np.asarray(param["Q"])   # test_MPCT_EADMM.m:14
    param["S"] = np.asarray(param["R"]).copy()   # test_MPCT_EADMM.m:15
    return sys, param, st


def _fused_pair(sys, param, **kw):
    """(JAX fused in interpret mode, port fused) at fp32."""
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("MPCT", "EADMM", tile_b=8,
                                **{**KW, **kw, **extra})
        o.precision = "float"
        out.append(pkg.make_solver(sys, param, formulation="MPCT",
                                   method="EADMM", backend="fused",
                                   options=o, **_on_cpu(pkg)))
    return out


def _data(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


KEYS = ("z1", "z2", "z3", "r_pf", "r_z2", "r_z3")


def _assert_parity(rj, rt, iters, moved=()):
    """k and e_flag exactly, iterates within the drift bound above after
    `iters` iterations. Lanes in `moved` may end one iteration apart; they
    are held to k within one and u within 1e-4."""
    kj, kt = np.asarray(rj.k), rt.k.numpy()
    same = np.ones(kj.shape, bool)
    same[list(moved)] = False
    np.testing.assert_array_equal(kt[same], kj[same])
    assert np.all(np.abs(kt - kj) <= 1)
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


# Lane 4 of seed 23 ends at the tolerance boundary: at k=133 its r_z3 is
# 9.969e-6 in the JAX run and 1.0014e-5 here (tol 1e-5), so it exits one
# iteration later. The free-run mode tests at k=136, away from it.
MOVED = {"checked": (4,), "exact-k": (4,)}
MODES = {
    "checked": {},
    "free-run": dict(check_every=4),
    "exact-k": dict(check_every=8, exact_k=True),
    "capped": dict(tol=1e-13, k_max=19),
    "capped-exact-k": dict(tol=1e-13, k_max=19, check_every=8,
                           exact_k=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_version_matches_jax_fused(fixture, mode):
    """Every mode of the kernel's plain version against the JAX fused
    kernel on the same inputs: per-lane k and e_flag, and the fp32
    iterates within the drift bound."""
    sys, param, st = fixture
    s_j, s_t = _fused_pair(sys, param, **MODES[mode])
    x = _data(st, 8, 23)
    rt = s_t(*x)
    if mode.startswith("capped"):
        assert np.all(rt.k.numpy() == 19) and np.all(rt.e_flag.numpy() == -1)
    else:
        assert np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x), rt, int(rt.k.max()) + 8, MOVED.get(mode, ()))


def test_warm_start_matches_jax_fused(fixture):
    """A warm start from the port's fp64 dense solution: the lam mapping
    into lm and lht and back, held to the JAX kernel's result."""
    sys, param, st = fixture
    x = _data(st, 8, 24)
    o = tsp.default_options("MPCT", "EADMM", **KW)
    rd = tsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                         options=o, device="cpu")(*x)
    init = tuple(rd.sol[key].float() for key in ("z1", "z2", "z3", "lam"))
    s_j, s_t = _fused_pair(sys, param)
    rt = s_t(*x, init=init)
    assert int(rt.k.max()) <= 20
    _assert_parity(s_j(*x, init=tuple(a.numpy() for a in init)), rt, 20)


def test_kernel_level_inputs_match_jax(fixture):
    """The wrapper against the JAX kernel on the same arrays, built by the
    port's adapter and padded to the JAX kernel's 128 columns (the pad
    columns stay exactly 0), with a warm start's lm and lht."""
    sys, param, st = fixture
    _, s_t = _fused_pair(sys, param, check_every=8, exact_k=True)
    fused = s_t.raw_fn
    x = [torch.as_tensor(a, dtype=torch.float32) for a in _data(st, 8, 25)]
    rng = np.random.default_rng(25)
    nz1, nrow = fused.nz1, s_t.ingredients["nrow"]
    init = (torch.zeros((8, nz1)),
            torch.as_tensor(rng.normal(0, 0.1, (8, fused.nm)),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(0, 0.1, (8, nz1)),
                            dtype=torch.float32),
            torch.as_tensor(rng.normal(0, 1.0, (8, nrow)),
                            dtype=torch.float32))
    *kin, _ = fused.prepare(*x, init=init)
    args = [torch.nn.functional.pad(a, (0, 128 - a.shape[1]))
            for a in (*kin, *fused.operator)]
    for i in (6, 7, 8):                             # the [Z, Z] matrices
        args[i] = torch.nn.functional.pad(args[i], (0, 0, 0, 128 - 96))
    kw = dict(tol=1e-5, k_max=3000, tile_b=8, check_every=8, exact_k=True)
    got = fk.fused_eadmm_solve(*args, **kw)
    want = jax_kernel(*(a.numpy() for a in args), interpret=True, **kw)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    atol = ATOL_PER_ITER * (int(got[5].max()) + 8)
    for a, b, scale in zip(got[:5], want[:5], (1, 1, 1, 40, 40)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol * scale)
        assert torch.all(a[:, nz1:] == 0)


def _fp64_args(sys, param, x, **kw):
    opt = tsp.default_options("MPCT", "EADMM", tile_b=8, **{**KW, **kw})
    ing = tsp.formulations.mpct.mpct_eadmm_ingredients(sys, param, opt)
    fused = FusedEADMMSolve(ing, opt, "cpu", dtype=torch.float64)
    *kin, _ = fused.prepare(*(torch.as_tensor(a) for a in x))
    return (*kin, *fused.operator), fused


@pytest.mark.parametrize("check_every,exact_k", [(1, False), (8, True)])
def test_plain_version_fp64_matches_jax_dense(fixture, check_every,
                                              exact_k):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates within 1e-9; pad entries
    stay exactly 0."""
    sys, param, st = fixture
    x = _data(st, 8, 5)
    args, fused = _fp64_args(sys, param, x)
    z1, z2b, z3, lm, lht, k, e, r_pf, r_z2, r_z3 = fk.fused_eadmm_reference(
        *args, tol=1e-7, k_max=5000, tile_b=8, check_every=check_every,
        exact_k=exact_k)
    o = jsp.default_options("MPCT", "EADMM", **{**KW, "tol": 1e-7,
                                                "k_max": 5000})
    rj = jsp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                         options=o)(*x)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(e.numpy(), np.asarray(rj.e_flag))
    n, N, nm, nz1 = fused.n, fused.N, fused.nm, fused.nz1
    lam = torch.cat([lht[:, :n], lm[:, :nz1], lht[:, N * nm:nz1]], dim=-1)
    for got, key in ((z1[:, :nz1], "z1"), (z2b[:, :nm], "z2"),
                     (z3[:, :nz1], "z3"), (lam, "lam"), (r_pf, "r_pf"),
                     (r_z2, "r_z2"), (r_z3, "r_z3")):
        np.testing.assert_allclose(got.numpy(), np.asarray(rj.sol[key]),
                                   rtol=0, atol=1e-9, err_msg=key)
    for a in (z1, z2b, z3, lm):
        assert torch.all(a[:, nz1:] == 0)
    # z2 is carried in broadcast form: every stage block holds it
    np.testing.assert_allclose(
        z2b[:, :nz1].reshape(8, N + 1, nm).numpy(),
        np.broadcast_to(z2b[:, None, :nm].numpy(), (8, N + 1, nm)),
        rtol=0, atol=1e-12)


def test_free_run_plain_version_drains_per_tile(fixture):
    """Plain free-run: converged lanes keep iterating until their tile is
    done, so with tile_b=16 the early tile's lanes carry later iterates
    than with tile_b=8, while k and the residuals stay at their exit."""
    sys, param, st = fixture
    args, _ = _fp64_args(sys, param, _data(st, 16, 4))
    args = tuple(a.float().contiguous() for a in args)
    kw = dict(tol=1e-5, k_max=3000, check_every=4)
    o8 = fk.fused_eadmm_reference(*args, tile_b=8, **kw)
    o16 = fk.fused_eadmm_reference(*args, tile_b=16, **kw)
    for i in range(5, 10):
        assert torch.equal(o8[i], o16[i]), i
    assert bool((torch.stack(o8[7:]) <= 1e-5).all())
    # a tile of 8 whose slowest lane ends with the 16-lane tile's slowest
    # carries the same iterates; the other tile stopped earlier (here the
    # second: its slowest lane ends at 144, the first tile's at 148)
    assert o8[5].reshape(2, 8).amax(dim=1).tolist() == [148, 144]
    assert torch.equal(o8[0][:8], o16[0][:8])
    assert bool(((o8[0][8:] - o16[0][8:]).abs().amax(dim=1) > 0).all())


def test_wrapper_takes_plain_version_on_cpu(fixture):
    """For CPU tensors the wrapper returns the plain version's results and
    launches nothing."""
    sys, param, st = fixture
    args, _ = _fp64_args(sys, param, _data(st, 8, 6))
    args = tuple(a.float().contiguous() for a in args)
    kw = dict(tol=1e-5, k_max=500, tile_b=8, check_every=8, exact_k=True)
    before = fk.fused_eadmm_solve.launches
    got = fk.fused_eadmm_solve(*args, **kw)
    want = fk.fused_eadmm_reference(*args, **kw)
    assert fk.fused_eadmm_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    t = torch.zeros((8, 64))
    mat = torch.zeros((64, 64))
    row = torch.zeros((1, 64))
    ok = (t,) * 6 + (mat,) * 3 + (row,) * 8
    kw = dict(tol=1e-4, k_max=10, tile_b=8)

    def call(i, repl):
        a = list(ok)
        a[i] = repl
        return fk.fused_eadmm_solve(*a, **kw)

    with pytest.raises(ValueError, match="six tiles"):
        call(3, torch.zeros((8, 32)))
    with pytest.raises(ValueError, match="C2m, C2t and M3p"):
        call(7, torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="eight rows"):
        call(12, torch.zeros((1, 32)))
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_eadmm_solve(*(a[:6] for a in ok[:6]), *ok[6:], **kw)
    with pytest.raises(ValueError, match="one device"):
        call(0, torch.empty((8, 64), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_eadmm_solve(*(a.to("meta") for a in ok), **kw)
    # the launch path refuses what the kernel does not take, before any
    # build
    lk = dict(kw, check_every=1, exact_k=False)
    with pytest.raises(TypeError, match="float32"):
        fk._launch(*(a.double() for a in ok), **lk)
    with pytest.raises(ValueError, match="contiguous"):
        fk._launch(t.T.contiguous().T, *ok[1:], **lk)
    with pytest.raises(ValueError, match="multiple of 32"):
        fk._launch(*(torch.zeros((8, 40)),) * 6, *(torch.zeros((40, 40)),) * 3,
                   *(torch.zeros((1, 40)),) * 8, **lk)


def test_launch_geometry():
    # the N=30 shape: nz1 = 248 pads to 256 columns, one thread each; the
    # MPCT operator's columns fall into 9 classes, and 16 lanes a block
    # take batches of 1056 lanes (66 blocks, half the SMs) and more
    smem16 = fk.shared_bytes(256, 16, 9)
    for B in (8192, 32768):
        assert fk.launch_geometry(B, 256, 9, tile_b=256, check_every=1,
                                  exact_k=False, k_max=5000) == (
            B // 16, 256, smem16)
    assert fk.launch_geometry(1024, 256, 9, tile_b=8, check_every=1,
                              exact_k=False, k_max=5000) == (
        128, 256, fk.shared_bytes(256, 8, 9))
    # two 8-lane blocks fit an SM with their reserve
    assert 2 * (fk.shared_bytes(256, 8, 9) + stage.SMEM_RESERVED) <= \
        stage.SMEM_SM
    # the N=10 fixture: nz1 = 88 pads to 96
    assert fk.launch_geometry(16, 96, 9, tile_b=8, check_every=4,
                              exact_k=False, k_max=10)[:2] == (2, 96)
    # 512 columns fit the 227 KB a block can opt into at 8 lanes
    assert 48 * 1024 < fk.launch_geometry(
        8, 512, 9, tile_b=8, check_every=1, exact_k=False,
        k_max=10)[2] <= 232448
    bad = [
        dict(B=64, Z=250, tile_b=8),      # not whole warps
        dict(B=64, Z=1056, tile_b=8),     # beyond every build (1024)
        dict(B=60, Z=96, tile_b=12),      # tile not whole blocks
        dict(B=48, Z=96, tile_b=32),      # batch not whole tiles
        dict(B=256, Z=96, tile_b=256, check_every=8),  # drain per block
        dict(B=64, Z=96, tile_b=8, k_max=0),
        dict(B=64, Z=96, tile_b=8, nd=0),  # no class of columns
        dict(B=64, Z=96, tile_b=8, nd=97),  # more classes than columns
        dict(B=8, Z=512, tile_b=8, nd=512),  # every column its own class:
                                             # no build fits at 512
    ]
    for b in bad:
        with pytest.raises(ValueError):
            fk.launch_geometry(b["B"], b["Z"], b.get("nd", 9),
                               tile_b=b["tile_b"],
                               check_every=b.get("check_every", 1),
                               exact_k=False, k_max=b.get("k_max", 10))


@pytest.mark.parametrize("B,lanes", [(8192, 16), (32768, 16), (1056, 16),
                                     (1048, 8), (64, 8), (8, 8)])
def test_launch_plan_picks_lanes(B, lanes):
    """16 lanes a block once the batch gives half the SMs a block (66 x 16
    lanes), 8 below; the plan never launches more than one block per L
    lanes, and it has no refill."""
    plan = fk.launch_plan(B, 256, 9, tile_b=8, check_every=1, exact_k=False,
                          k_max=5000)
    assert plan == dict(lanes=lanes, blocks=B // lanes, threads=256,
                        smem=fk.shared_bytes(256, lanes, 9), refill=False)


def test_no_32_lane_build():
    """At 32 lanes a block the state alone outgrows a block's shared memory,
    even with the 16-row ring, so no 32-lane build exists and naming one
    raises."""
    assert 32 not in fk.BUILDS
    assert fk.shared_bytes(256, 32) > SMEM_MAX
    assert fk.shared_bytes(256, 32) == fk.shared_bytes(256, 32, 1)
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(8192, 256, 9, tile_b=256, check_every=1,
                       exact_k=False, k_max=5000, lanes=32)
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(8192, 96, 9, tile_b=256, check_every=1,
                       exact_k=False, k_max=5000, lanes=32)
    # a small width would fit 32 lanes in shared memory; the dispatch still
    # takes only the builds there are
    assert fk.launch_plan(8192, 96, 9, tile_b=256, check_every=1,
                          exact_k=False, k_max=5000)["lanes"] == 16


def _mpct_operator(fixture, N):
    sys, param, _ = fixture
    p = dict(param, N=N)
    opt = tsp.default_options("MPCT", "EADMM", tile_b=8, **KW)
    ing = tsp.formulations.mpct.mpct_eadmm_ingredients(sys, p, opt)
    return FusedEADMMSolve(ing, opt, "cpu")


@pytest.mark.parametrize("N", [10, 30])
def test_distinct_columns_of_the_mpct_operator(fixture, N):
    """The columns of [C2m; C2t] fall into nm + 1 = 9 classes: z2's nm
    columns, copied to every stage block, and the zero pad columns. Every
    member of a class equals its representative byte for byte in both
    matrices, and the representative is the class's first column."""
    fused = _mpct_operator(fixture, N)
    C2m, C2t = fused.operator[:2]
    Z = C2m.shape[0]
    reps, col_of = fk.distinct_columns(C2m, C2t)
    assert len(reps) == fused.nm + 1 == 9
    assert reps.tolist() == list(range(fused.nm)) + [fused.nz1]
    assert col_of.dtype == torch.int32 and col_of.shape == (Z,)
    j = torch.arange(Z)
    want = torch.where(j < fused.nz1, j % fused.nm, fused.nm)
    assert torch.equal(col_of.long(), want)
    for M in (C2m, C2t):
        bits = M.contiguous().view(torch.int32)
        assert torch.equal(bits, bits[:, reps[col_of.long()]])
    assert torch.equal(reps[col_of.long()[reps]], reps)
    # the solver found the same classes once, for the kernel
    C2d, C2td, cls = fused.classes
    assert torch.equal(cls, col_of)
    assert torch.equal(C2d, C2m[:, reps]) and C2d.is_contiguous()
    assert torch.equal(C2td, C2t[:, reps]) and C2td.is_contiguous()


def test_distinct_columns_of_random_matrices():
    """Random matrices: every column its own class. A column equal in C2m
    but not in C2t is no copy, and -0.0 is not +0.0."""
    rng = np.random.default_rng(3)
    Z = 64
    C2m = torch.as_tensor(rng.normal(size=(Z, Z)), dtype=torch.float32)
    C2t = torch.as_tensor(rng.normal(size=(Z, Z)), dtype=torch.float32)
    reps, col_of = fk.distinct_columns(C2m, C2t)
    assert reps.tolist() == list(range(Z))
    assert col_of.tolist() == list(range(Z))
    C2m[:, 5] = C2m[:, 2]
    assert len(fk.distinct_columns(C2m, C2t)[0]) == Z
    C2t[:, 5] = C2t[:, 2]
    reps, col_of = fk.distinct_columns(C2m, C2t)
    assert len(reps) == Z - 1 and int(col_of[5]) == int(col_of[2]) == 2
    a, b = torch.zeros((4, 2)), torch.zeros((4, 2))
    a[1, 1] = -0.0
    assert len(fk.distinct_columns(a, b)[0]) == 2
    # float64 operators (the plain version's) are compared by their bytes
    assert len(fk.distinct_columns(a.double(), b.double())[0]) == 2


@pytest.mark.parametrize("N", [10, 30])
def test_chains_over_classes_give_every_columns_bits(fixture, N):
    """A row-ordered fp32 accumulation (one multiply and one add a row) over
    the class representatives, scattered by col_of, equals the same chain
    over all columns bit for bit: each copy's chain is its
    representative's."""
    fused = _mpct_operator(fixture, N)
    C2m, C2t = fused.operator[:2]
    C2d, C2td, col_of = fused.classes
    rng = np.random.default_rng(N)
    d = torch.as_tensor(rng.normal(size=(8, C2m.shape[0])),
                        dtype=torch.float32)

    def chain(v, M):
        acc = torch.zeros((v.shape[0], M.shape[1]), dtype=torch.float32)
        for i in range(M.shape[0]):
            acc = acc + v[:, i:i + 1] * M[i:i + 1]
        return acc

    for full, narrow in ((C2m, C2d), (C2t, C2td)):
        want = chain(d, full)
        got = chain(d, narrow)[:, col_of.long()]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_wrapper_checks_classes():
    """The launch takes the classes as narrow_operands gives them and
    refuses others before any build."""
    t = torch.zeros((8, 64))
    mat = torch.zeros((64, 64))
    row = torch.zeros((1, 64))
    ok = (t,) * 6 + (mat,) * 3 + (row,) * 8
    kw = dict(tol=1e-4, k_max=10, tile_b=8, check_every=1, exact_k=False)
    C2d, C2td, col_of = fk.narrow_operands(mat, mat)
    assert C2d.shape == (64, 1) and col_of.tolist() == [0] * 64
    for bad in ((C2d, C2td, col_of.long()), (C2d, C2td[:1], col_of),
                (C2d.double(), C2td, col_of)):
        with pytest.raises(ValueError, match="classes"):
            fk._launch(*ok, classes=bad, **kw)


def test_parent_kernel_is_a_variant():
    """The kernel runs on the product stage; the one-column-per-thread
    parent it replaced lives only among the variants."""
    src = (_build.CSRC / "fused_eadmm.cu").read_text()
    assert '#include "tile_product.cuh"' in src
    assert "tp::run_modes<L>" in src and "tp::product<L, TCX, SR>" in src
    parent = _build.CSRC / "variants" / "fused_eadmm_parent.cu"
    assert "constexpr int TB = 8;" in parent.read_text()
    assert fk.C2D_STAGED.keys() == fk.BUILDS.keys()
    for L, (slab, blocks) in fk.BUILDS.items():
        assert f"#define EA_SLAB_{L} {slab}" in src
        assert f"#define EA_BLOCKS_{L} {blocks}" in src
        assert f"#define EA_STAGE_C2D_{L} {int(fk.C2D_STAGED[L])}" in src
    # the 16-lane build's copy of C2d is [Z][nd] floats of its shared memory
    assert (fk.shared_bytes(256, 16, 9) - fk.shared_bytes(256, 16, 1)
            == 4 * 8 * (256 + 2 * 20))
    assert (fk.shared_bytes(256, 8, 9) - fk.shared_bytes(256, 8, 1)
            == 4 * 8 * 2 * 12)


def test_build_is_lazy_and_content_addressed():
    # importing the package built nothing
    assert _build.build_record("fused_eadmm") is None
    d = _build.source_digest("fused_eadmm")
    assert d == _build.source_digest("fused_eadmm") and len(d) == 16
    assert d != _build.source_digest("fused_fista")
    src = (_build.CSRC / "fused_eadmm.cu").read_text()
    assert src.count("extern \"C\" int fused_eadmm_launch(") == 1
    assert f"NSNAP = {fk.SNAP_LEAVES};" in src
    # the C signature the wrapper binds: 30 pointers, 7 + 1 + 3 scalars,
    # the stream
    assert len(fk.FUSED_EADMM_ARGTYPES) == 42
