"""The widths each fused kernel takes, checked without CUDA: every kernel
module's `check_width` takes the N=30 widths of its families and refuses
the first padded width past its cap, naming the kernel, the width, the cap
and backend="dense" (the fused builders call it when they build for the
card, so that make_solver refuses a width no build takes); K1's wide build
takes 544 and 1024 columns, and its plain version at 544 columns
(MPCT-ADMM-cs, N=33) gives the JAX fused kernel's per-lane k and e_flag in
interpret mode."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import (_build, fused_admm, fused_eadmm,
                                      fused_ellip, fused_fista, fused_hmpc,
                                      fused_soc, fused_split)
from spcies_tpu_torch.solvers import fused_backend

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


# kernel -> (module, its N=30 widths (the families' padded widths), the
# first widths past its cap, the cap)
WIDTHS = {
    "K1": (fused_admm, [(256,), (480,), (544,), (1024,)], [(1056,)], 1024),
    "K2": (fused_fista, [(256, 192)], [(544, 192), (256, 544)], 512),
    "K3": (fused_eadmm, [(256, 9)], [(544, 9)], 512),
    "K4": (fused_ellip, [(256,)], [(544,)], 512),
    "K5": (fused_soc, [(288,)], [(544,)], 512),
    "K6": (fused_hmpc, [(288, 288)], [(544, 288), (288, 544)], 512),
    "K7": (fused_split, [(320,)], [(544,)], 512),
}


@pytest.mark.parametrize("kernel", sorted(WIDTHS))
def test_check_width_takes_n30_and_refuses_past_the_cap(kernel):
    module, takes, refuses, cap = WIDTHS[kernel]
    for widths in takes:
        module.check_width(*widths)
    for widths in refuses:
        past = max(widths)
        with pytest.raises(ValueError) as err:
            module.check_width(*widths)
        msg = str(err.value)
        for part in (f"({kernel},", f"up to {cap}", f"has {past}",
                     'backend="dense"'):
            assert part in msg, (part, msg)
    with pytest.raises(ValueError, match="multiple of 32"):
        module.check_width(*[250] * len(takes[0]))


def test_k3_refuses_classes_that_do_not_fit():
    # K3 keeps [Z][nd] of C2m's distinct columns in shared memory: at 512
    # columns, 64 classes fit its 8-lane build and 512 fit none
    fused_eadmm.check_width(512, 64)
    with pytest.raises(ValueError, match='shared memory: use backend="dense"'):
        fused_eadmm.check_width(512, 512)


def test_adapters_check_width_on_the_card_alone():
    """A fused adapter built for a CUDA device runs its kernel's check; for
    the CPU, whose plain versions take any width, it does not."""
    solve = object()
    assert fused_backend._on_card(solve, "cpu", fused_admm.check_width,
                                  4096) is solve
    assert fused_backend._on_card(solve, torch.device("cuda", 0),
                                  fused_admm.check_width, 1024) is solve
    with pytest.raises(ValueError, match="K1"):
        fused_backend._on_card(solve, "cuda", fused_admm.check_width, 1056)


@pytest.mark.parametrize("shape", [(8192, 544), (8192, 672), (8192, 704),
                                   (8192, 1024), (64, 1024), (8, 544)])
def test_wide_plan(shape):
    """Past 512 columns the wide build runs 512 threads of two columns at
    8 or 16 lanes a block, with 16-row slabs where they fit in shared
    memory and 8-row slabs where they do not."""
    B, nzp = shape
    plan = fused_admm.launch_plan(B, nzp, tile_b=8, check_every=16,
                                  exact_k=True, fixed_iters=0)
    assert plan["wide"] and plan["threads"] == fused_admm.WIDE_THREADS
    assert plan["lanes"] in (8, 16) and plan["blocks"] * plan["lanes"] == B
    assert plan["smem"] == fused_admm.shared_bytes(nzp, plan["lanes"], True)
    assert plan["smem"] <= fused_admm.SMEM_MAX
    if plan["slab"] == 8:       # 16-row slabs would not fit
        assert fused_admm._smem(nzp, plan["lanes"], 16) > (
            fused_admm.SMEM_MAX)
    else:
        assert plan["slab"] == 16
    # the batch takes 16 lanes a block where they fit
    if B == 8192:
        assert plan["lanes"] == (16 if nzp <= 672 else 8)


def test_wide_plan_refusals():
    kw = dict(tile_b=8, check_every=16, exact_k=True, fixed_iters=0)
    # 32 lanes a block never fit beside a wide block's state, 16 not at
    # 1024 columns
    for lanes, nzp in ((32, 544), (16, 1024)):
        with pytest.raises(ValueError, match="no build"):
            fused_admm.launch_plan(8192, nzp, lanes=lanes, **kw)
    # one thread a column ends at 512
    with pytest.raises(ValueError, match="one thread a column"):
        fused_admm.launch_plan(8192, 544, wide=False, **kw)
    with pytest.raises(ValueError, match='backend="dense"'):
        fused_admm.launch_plan(8192, 1056, **kw)
    # the wide build also takes 512 columns, for a comparison of bits, and
    # no fewer
    with pytest.raises(ValueError, match="512 columns or more"):
        fused_admm.launch_plan(8192, 480, wide=True, **kw)
    plan = fused_admm.launch_plan(8192, 512, wide=True, **kw)
    assert plan["threads"] == 512 and plan["lanes"] == 16
    assert not fused_admm.launch_plan(8192, 512, **kw)["wide"]


def test_wide_constants_match_the_source():
    src = (_build.CSRC / "fused_admm.cu").read_text()
    fa = fused_admm
    assert f"WIDE_CPT = {fa.WIDE_CPT};" in src
    assert "WIDE_THREADS = MAX_COLS;" in src and fa.WIDE_THREADS == 512
    assert f"MAX_COLS = {fa.MAX_COLS};" in src
    assert f"WIDE_SLAB = {fa.WIDE_SLAB_ROWS};" in src
    assert f"SMEM_MAX = {fa.SMEM_MAX};" in src
    assert 'extern "C" long fused_admm_smem(int nzp, int lanes, int wide)' \
        in src


def _mpct_cs_pair(N, **kw):
    sys, param, _ = tsp.systems.tester_fixture()
    p = dict(param, N=N)
    p["T"] = 10.0 * np.asarray(p["Q"])
    p["S"] = np.asarray(p["R"]).copy()
    out = []
    for pkg, extra in ((jsp, dict(pallas_interpret=True)), (tsp, {})):
        o = pkg.default_options("MPCT", "ADMM", "cs", tile_b=8,
                                **{**kw, **extra})
        o.precision = "float"
        out.append(pkg.make_solver(
            sys, p, formulation="MPCT", method="ADMM", submethod="cs",
            backend="fused", options=o,
            **(dict(device="cpu") if pkg is tsp else {})))
    return out


def test_k1_plain_version_at_544_columns_matches_jax_fused():
    """MPCT-ADMM-cs at N=33 (nz = 528, padded to 544: past 512, on K1's
    wide build on the card) at the bench's settings (rho 2, tol 1e-4,
    exact-k, check_every 8), B=8, fp32: the plain version of the kernel
    gives the JAX fused kernel's k and e_flag on every lane, and the fp32
    dense engine's u within 1e-4."""
    s_j, s_t = _mpct_cs_pair(33, rho=2.0, tol=1e-4, k_max=4000,
                             check_every=8, exact_k=True)
    assert s_t.raw_fn.operator[0].shape == (544, 544)
    _, _, st = tsp.systems.tester_fixture()
    rng = np.random.default_rng(4)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (8, 1))
    x = (x0, np.tile(st["xr"], (8, 1)), np.tile(st["ur"], (8, 1)))
    rj, rt = s_j(*x), s_t(*x)
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.e_flag.numpy(), np.asarray(rj.e_flag))
    assert np.all(rt.e_flag.numpy() == 1)
    atol = max(1e-5, 2e-7 * (int(rt.k.max()) + 8))
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0,
                               atol=atol)
    sys, param, _ = tsp.systems.tester_fixture()
    p = dict(param, N=33, T=10.0 * np.asarray(param["Q"]),
             S=np.asarray(param["R"]).copy())
    o = tsp.default_options("MPCT", "ADMM", "cs", rho=2.0, tol=1e-4,
                            k_max=4000)
    o.precision = "float"
    rd = tsp.make_solver(sys, p, formulation="MPCT", method="ADMM",
                         submethod="cs", options=o, device="cpu")(*x)
    np.testing.assert_allclose(rd.u.numpy(), rt.u.numpy(), rtol=0,
                               atol=1e-4)


def test_plain_versions_have_no_cap():
    """On the CPU the fused builders take any width: laxMPC-ADMM at N=130
    pads to 1056 columns, past every build of K1, and solves."""
    sys, param, st = tsp.systems.tester_fixture()
    o = tsp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-3,
                            k_max=300, tile_b=8)
    o.precision = "float"
    s = tsp.make_solver(sys, dict(param, N=130), formulation="laxMPC",
                        method="ADMM", options=o, backend="fused",
                        device="cpu")
    assert s.raw_fn.operator[0].shape == (1056, 1056)
    res = s(np.tile(st["x"], (8, 1)), np.tile(st["xr"], (8, 1)),
            np.tile(st["ur"], (8, 1)))
    assert tuple(res.u.shape) == (8, 2)
