"""The fused box-ADMM kernel's plain PyTorch version (the path CPU tensors
take through kernels/fused_admm.py) against the JAX package's fused
backend run in Pallas interpret mode, mode for mode, and against the JAX
dense engine in fp64; plus the wrapper's dispatch, validation and build
plumbing, which need no GPU."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import _build
from spcies_tpu_torch.kernels import fused_admm as fk

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
# different orders. Each iteration adds about one fp32 ulp of an O(1)
# entry to the gap between the two runs, and ADMM's slow modes keep it:
# on this fixture max|dz| grows from 6e-8 after 1 iteration to 2e-5 after
# 300 (4.2e-5 with relax_alpha 1.8), and lam (scaled by rho) about 7
# times faster. So z and v are held to 1e-5, or 2e-7 per iteration run
# where that is more, and lam to rho times that.
ATOL_FP32 = 1e-5
ATOL_PER_ITER = 2e-7
RHO = 15.0


@pytest.fixture(scope="module")
def fixture():
    return tsp.systems.tester_fixture()


def _pair(sys, param, tol=1e-4, k_max=1000, tile_b=8, **kw):
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("laxMPC", "ADMM", rho=RHO, tol=tol,
                                k_max=k_max, tile_b=tile_b, **extra, **kw)
        o.precision = "float"
        out.append(pkg.make_solver(sys, param, formulation="laxMPC",
                                   method="ADMM", backend="fused",
                                   options=o, **_on_cpu(pkg)))
    return out


def _batch(st, B, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    return x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1))


def _assert_parity(rj, rt, iters):
    """k and e_flag exactly; iterates within the drift bound above after
    `iters` iterations."""
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    atol = max(ATOL_FP32, ATOL_PER_ITER * iters)
    for key in ("z", "v", "lam", "r_p", "r_d"):
        np.testing.assert_allclose(rt.sol[key].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=RHO * atol if key == "lam" else atol,
                                   err_msg=key)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=atol)


def _iters(res, check_every=1):
    """Iterations a run made: the last lane's k plus one window."""
    return int(res.k.max()) + check_every


MODES = {
    "checked": (8, 0, {}),
    "free-run-relaxed": (8, 2, dict(check_every=8, relax_alpha=1.8)),
    "exact-k": (8, 2, dict(check_every=8, exact_k=True)),
    "exact-k-capped": (8, 2, dict(check_every=8, exact_k=True, k_max=37,
                                  tol=1e-12)),
    "checked-capped": (8, 2, dict(k_max=10, tol=1e-14)),
    "free-run-capped": (8, 2, dict(check_every=8, k_max=10, tol=1e-14)),
    "batch-padding": (5, 1, {}),
    "sort-lanes": (32, 9, dict(check_every=8, exact_k=True,
                               sort_lanes=True)),
    "tile-16-exact-k": (16, 7, dict(check_every=8, exact_k=True,
                                    tile_b=16)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_version_matches_jax_fused(fixture, mode):
    sys, param, st = fixture
    B, seed, kw = MODES[mode]
    s_j, s_t = _pair(sys, param, **kw)
    x = _batch(st, B, seed)
    rt = s_t(*x)
    _assert_parity(s_j(*x), rt, _iters(rt, kw.get("check_every", 1)))
    assert tuple(rt.u.shape) == (B, 2)


def test_tpu_scheduling_options_change_nothing(fixture):
    """interleave and unroll_window only steered the TPU compiler; the
    port accepts them and gives identical results."""
    sys, param, st = fixture
    x = _batch(st, 16, 8)
    base = _pair(sys, param, check_every=8, exact_k=True, tile_b=16)[1](*x)
    other = _pair(sys, param, check_every=8, exact_k=True, tile_b=16,
                  interleave=2, unroll_window=False)[1](*x)
    for key in ("z", "v", "lam", "r_p", "r_d"):
        assert torch.equal(base.sol[key], other.sol[key])
    assert torch.equal(base.k, other.k)


def test_bf16_delta_plain_version(fixture):
    """bf16 delta products: rounding dq to bf16 turns the sum-order gap
    between frameworks into whole bf16 ulps, so per-lane k is not held to
    the JAX run's; it is held near the fp32 run's, with the fp32 answer."""
    sys, param, st = fixture
    _, s_bf = _pair(sys, param, check_every=8, exact_k=True,
                    bf16_delta=True)
    _, s_32 = _pair(sys, param, check_every=8, exact_k=True)
    x = _batch(st, 8, 3)
    r_bf, r_32 = s_bf(*x), s_32(*x)
    assert np.all(r_bf.e_flag.numpy() == 1)
    k_bf, k_32 = r_bf.k.numpy().astype(float), r_32.k.numpy().astype(float)
    assert np.max(np.abs(k_bf - k_32) / k_32) < 0.25
    assert np.max(np.abs(r_bf.u.numpy() - r_32.u.numpy())) < 5e-4


def test_fixed_iters_matches_jax_fused(fixture):
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param)
    B = 8
    x0 = np.tile(np.asarray(st["x"]) * 1.3, (B, 1))
    x = (x0, np.tile(st["xr"], (B, 1)), np.tile(st["ur"], (B, 1)))
    rt = s_t(*x, fixed_iters=50)
    assert np.all(rt.k.numpy() == 50) and np.all(rt.e_flag.numpy() == 1)
    _assert_parity(s_j(*x, fixed_iters=50), rt, 50)


def test_warm_start_matches_jax_fused(fixture):
    sys, param, st = fixture
    s_j, s_t = _pair(sys, param, check_every=8, exact_k=True)
    x = _batch(st, 8, 4)
    cold_t, cold_j = s_t(*x), s_j(*x)
    warm_t = s_t(*x, init=(cold_t.sol["z"], cold_t.sol["v"],
                           cold_t.sol["lam"]))
    warm_j = s_j(*x, init=(cold_j.sol["z"], cold_j.sol["v"],
                           cold_j.sol["lam"]))
    assert np.all(warm_t.k.numpy() < cold_t.k.numpy())
    _assert_parity(warm_j, warm_t, _iters(cold_t, 8) + _iters(warm_t, 8))


def _fp64_kernel_args(sys, param, x, rho):
    """Kernel arguments built in fp64 from the port's ingredients, padded
    as the fused backend pads them."""
    opt = tsp.default_options("laxMPC", "ADMM", rho=rho)
    ing = tsp.formulations.laxmpc.laxmpc_admm_ingredients(sys, param, opt)
    nz = ing["nz"]
    nzp = fk.round_up(nz, fk.COL_PAD)
    d = torch.float64
    x0, xr, ur = (torch.as_tensor(a, dtype=d) for a in x)
    q_ref = tsp.formulations.laxmpc._q_ref(ing, xr, ur, d)
    M_q = torch.as_tensor(ing["M_q"], dtype=d)
    aux_b = (-(x0 @ torch.as_tensor(ing["A"], dtype=d).T)) @ torch.as_tensor(
        ing["M_b"], dtype=d).T
    z1 = q_ref @ M_q.T + aux_b
    M_pad = F.pad(M_q.T, (0, nzp - nz, 0, nzp - nz))
    LB = F.pad(torch.as_tensor(ing["LB_z"], dtype=d), (0, nzp - nz))[None]
    UB = F.pad(torch.as_tensor(ing["UB_z"], dtype=d), (0, nzp - nz))[None]
    zeros = torch.zeros((x0.shape[0], nzp), dtype=d)
    return (F.pad(z1, (0, nzp - nz)), zeros, zeros, M_pad, LB, UB), nz


@pytest.mark.parametrize("check_every,exact_k,alpha", [
    (1, False, 1.0), (8, True, 1.0), (8, True, 1.8), (1, False, 1.8)])
def test_plain_version_fp64_matches_jax_dense(fixture, check_every, exact_k,
                                              alpha):
    """In fp64 the plain version's checked and exact-k modes give the JAX
    dense engine's k exactly and its iterates within 1e-9."""
    sys, param, st = fixture
    x = _batch(st, 8, 5)
    args, nz = _fp64_kernel_args(sys, param, x, 15.0)
    z, v, lam, k, e, rp, rd = fk.fused_admm_reference(
        *args, rho=15.0, tol_p=1e-6, tol_d=1e-6, k_max=3000, tile_b=8,
        relax_alpha=alpha, check_every=check_every, exact_k=exact_k)
    s_j = jsp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                          rho=15.0, tol=1e-6, k_max=3000, relax_alpha=alpha)
    rj = s_j(*x)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(e.numpy(), np.asarray(rj.e_flag))
    for got, key in ((z, "z"), (v, "v"), (lam, "lam")):
        np.testing.assert_allclose(got[:, :nz].numpy(),
                                   np.asarray(rj.sol[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
        assert torch.all(got[:, nz:] == 0)


def test_wrapper_takes_plain_version_on_cpu(fixture):
    """For CPU tensors the wrapper returns the plain version's results and
    launches nothing."""
    sys, param, st = fixture
    args, _ = _fp64_kernel_args(sys, param, _batch(st, 8, 6), 15.0)
    args = tuple(a.float().contiguous() for a in args)
    kw = dict(rho=15.0, tol_p=1e-4, tol_d=1e-4, k_max=500, tile_b=8,
              check_every=8, exact_k=True)
    before = fk.fused_admm_solve.launches
    got = fk.fused_admm_solve(*args, **kw)
    want = fk.fused_admm_reference(*args, **kw)
    assert fk.fused_admm_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_solver_on_cpu_launches_nothing(fixture):
    sys, param, st = fixture
    _, s_t = _pair(sys, param)
    before = fk.fused_admm_solve.launches
    res = s_t(*_batch(st, 8, 0))
    assert fk.fused_admm_solve.launches == before
    assert np.all(res.e_flag.numpy() == 1)


def test_wrapper_rejects_bad_arguments():
    z = torch.zeros((8, 32))
    M = torch.zeros((32, 32))
    row = torch.zeros((1, 32))
    kw = dict(rho=1.0, tol_p=1e-4, tol_d=1e-4, k_max=10, tile_b=8)
    with pytest.raises(ValueError, match="one shape"):
        fk.fused_admm_solve(z, torch.zeros((8, 64)), z, M, row, row, **kw)
    with pytest.raises(ValueError, match="M_q_pad"):
        fk.fused_admm_solve(z, z, z, torch.zeros((32, 16)), row, row, **kw)
    with pytest.raises(ValueError, match="tile_b"):
        fk.fused_admm_solve(z[:6], z[:6], z[:6], M, row, row, **kw)
    meta = torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError, match="one device"):
        fk.fused_admm_solve(meta, z, z, M, row, row, **kw)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_admm_solve(meta, meta, meta, M.to("meta"), row.to("meta"),
                            row.to("meta"), **kw)


def test_launch_geometry():
    # the N=30 headline: nz=240 pads to 256 columns, one thread each, 32
    # lanes a block
    kw = dict(tile_b=256, check_every=16, exact_k=True, fixed_iters=0)
    assert fk.launch_geometry(32768, 256, **kw) == (
        1024, 256, fk.shared_bytes(256, 32))
    assert fk.shared_bytes(256, 32) == fk.RING_EXTRA + 4 * (
        fk.STAGES * fk.SLAB_ROWS_NARROW * 256 + 256 * (4 * 32 + fk.DQ_PAD)
        + 8 * 2 * 32 + 4 + 2 * 32)
    assert fk.launch_geometry(16, 96, tile_b=8, check_every=8,
                              exact_k=False, fixed_iters=0)[:2] == (2, 96)
    assert fk.launch_geometry(512, 96, tile_b=256, check_every=8,
                              exact_k=False, fixed_iters=50)[0] == 64
    bad = [
        dict(B=64, nzp=250, tile_b=8),          # not whole warps
        dict(B=64, nzp=1056, tile_b=8),         # beyond the wide build
        dict(B=60, nzp=96, tile_b=12),          # tile not whole groups
        dict(B=48, nzp=96, tile_b=32),          # batch not whole tiles
        dict(B=256, nzp=96, tile_b=256, check_every=8),  # free-run drain
    ]
    for b in bad:
        with pytest.raises(ValueError):
            fk.launch_geometry(b["B"], b["nzp"], tile_b=b["tile_b"],
                               check_every=b.get("check_every", 1),
                               exact_k=False, fixed_iters=0)


# (batch, padded width) -> lanes a block the dispatch picks: the headline,
# equMPC-ADMM, MPCT-ADMM-cs (the widest shape a family runs), the widest
# shape the kernel takes, a batch of one round of 32-lane blocks, one under
# half a round, and a request of 64 lanes
DISPATCH = {(32768, 256): 32, (8192, 256): 32, (8192, 480): 16,
            (32768, 480): 16, (8192, 512): 16, (4096, 256): 32,
            (2048, 256): 16, (64, 256): 8, (8, 512): 8}


@pytest.mark.parametrize("shape", sorted(DISPATCH))
def test_dispatch_by_shape(shape):
    B, nzp = shape
    plan = fk.launch_plan(B, nzp, tile_b=8, check_every=16, exact_k=True,
                          fixed_iters=0)
    assert plan["lanes"] == DISPATCH[shape] == fk.pick_lanes(B, nzp)
    assert plan["blocks"] * plan["lanes"] == B and plan["threads"] == nzp
    assert plan["smem"] == fk.shared_bytes(nzp, plan["lanes"]) <= 232448
    # the bf16 mode takes the same build
    assert fk.launch_geometry(B, nzp, tile_b=8, check_every=16, exact_k=True,
                              fixed_iters=0) == (
        plan["blocks"], plan["threads"], plan["smem"])
    # a request of 64 lanes keeps its 8 blocks
    assert plan["blocks"] >= min(B // 8, fk.SMS // 2)


@pytest.mark.parametrize("lanes", fk.LANES)
def test_plain_free_run_takes_tile_8_at_every_lanes(lanes):
    kw = dict(check_every=16, exact_k=False, fixed_iters=0, lanes=lanes)
    plan = fk.launch_plan(4096, 256, tile_b=8, **kw)
    assert plan["lanes"] == lanes and plan["blocks"] == 4096 // lanes
    with pytest.raises(ValueError, match="plain free-run"):
        fk.launch_plan(4096, 256, tile_b=256, **kw)


@pytest.mark.parametrize("forced", [
    dict(lanes=32, nzp=480),            # four [480][32] buffers do not fit
    dict(lanes=32, nzp=512),
    dict(lanes=64),                     # no such build
    dict(lanes=4),
    dict(lanes=32, B=48),               # batch not whole blocks
    dict(lanes=16, B=4104),
])
def test_named_builds_are_refused(forced):
    f = dict(dict(B=4096, nzp=256, lanes=None), **forced)
    with pytest.raises(ValueError, match="no build"):
        fk.launch_plan(f["B"], f["nzp"], tile_b=8, check_every=1,
                       exact_k=False, fixed_iters=0, lanes=f["lanes"])


@pytest.mark.parametrize("lanes", (None,) + fk.LANES)
def test_lanes_do_not_reach_the_plain_version(fixture, lanes):
    # on CPU tensors `lanes` names no build: the plain version runs
    sys, param, st = fixture
    args, _ = _fp64_kernel_args(sys, param, _batch(st, 8, 6), 15.0)
    args = tuple(a.float().contiguous() for a in args)
    kw = dict(rho=15.0, tol_p=1e-4, tol_d=1e-4, k_max=500, tile_b=8,
              check_every=4, exact_k=True)
    want = fk.fused_admm_reference(*args, **kw)
    for a, b in zip(fk.fused_admm_solve(*args, lanes=lanes, **kw), want):
        assert torch.equal(a, b)


def test_geometry_constants_match_the_sources():
    head = (_build.CSRC / "tile_product.cuh").read_text()
    assert f"#define TP_SLAB_ROWS {fk.SLAB_ROWS} " in head
    assert f"#define TP_SLAB_ROWS_NARROW {fk.SLAB_ROWS_NARROW} " in head
    assert f"NARROW = {fk.NARROW};" in (
        _build.CSRC / "fused_admm.cu").read_text()
    assert f"#define TP_STAGES {fk.STAGES}\n" in head
    assert "#define TP_STAGE 2 " in head        # the TMA ring
    assert f"DQ_PAD = {fk.DQ_PAD};" in head
    src = (_build.CSRC / "fused_admm.cu").read_text()
    assert '#include "tile_product.cuh"' in src
    assert f"NSNAP = {fk.SNAP_LEAVES};" in src
    for lanes in fk.LANES:
        assert f"launch<{lanes}>(p, " in src
    # no tensor-core product and no library product in the launched source
    assert "mma" not in src and "cublas" not in src.lower()
    # the C signature the wrapper binds: 15 pointers, 7 + 4 + 1 + 2 + 5
    # scalars, the stream
    assert src.count('extern "C" int fused_admm_launch(') == 1
    assert len(fk.FUSED_ADMM_ARGTYPES) == 35


@pytest.mark.parametrize("name", ["fused_admm_parent", "fused_admm_tc",
                                  "fused_split_tile", "fused_hmpc_parent",
                                  "fused_soc_parent"])
def test_variant_sources_stay_out_of_the_launched_builds(name):
    # the builds a timing script holds against the launched kernels; the
    # parents are the one-column-per-thread kernels of 8 lanes a block
    variants = _build.CSRC / "variants"
    src = (variants / f"{name}.cu").read_text()
    assert 'extern "C" int fused_' in src
    files = _build.included_files(variants / f"{name}.cu")
    uses_stage = not name.endswith("_parent")
    assert (_build.CSRC / "tile_product.cuh" in files) == uses_stage
    # no wrapper of the package names a variant
    for wrapper in (_build.CSRC.parent / "kernels").glob("*.py"):
        assert f'"{name}"' not in wrapper.read_text()


def test_source_digest_follows_includes(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "INCLUDE", tmp_path)
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    assert [f.name for f in _build.included_files(tmp_path / "k.cu")] == [
        "k.cu", "a.cuh", "b.cuh"]
    d0 = _build.source_digest("k")
    (tmp_path / "other.cuh").write_text("int o2;\n")    # not included
    assert _build.source_digest("k") == d0
    (tmp_path / "b.cuh").write_text("int b2;\n")        # through a.cuh
    d1 = _build.source_digest("k")
    assert d1 != d0
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a2;\n')
    assert _build.source_digest("k") not in (d0, d1)
    # a source in another directory finds the header under INCLUDE
    sub = tmp_path / "variant"
    sub.mkdir()
    (sub / "k.cu").write_text((tmp_path / "k.cu").read_text())
    assert _build.source_digest("k", sub) == _build.source_digest("k")
    (tmp_path / "k.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError, match="missing.cuh"):
        _build.source_digest("k")


def test_build_is_lazy_and_content_addressed(monkeypatch):
    # importing the package built nothing
    assert _build.build_record("fused_admm") is None
    d = _build.source_digest("fused_admm")
    assert d == _build.source_digest("fused_admm") and len(d) == 16
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
