"""The widths each fused kernel takes, checked without CUDA: every kernel
module's `check_width` takes the N=30 widths of its families and the wide
widths up to 1024, and refuses the first padded width past 1024, naming the
kernel, the width, the cap and backend="dense" (the fused builders call it
when they build for the card, so that make_solver refuses a width no build
takes); each launch plan takes the wide build past 512 columns (and where
it is named), and sizes its shared memory as the C source does; K1's
plain version at 544 columns (MPCT-ADMM-cs, N=33) and K2-K7's at the first
oscillating-masses horizon past 512 columns give the JAX fused kernel's
per-lane k and e_flag in interpret mode."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import spcies_tpu as jsp

import spcies_tpu_torch as tsp
from spcies_tpu_torch.kernels import (_build, fused_admm, fused_eadmm,
                                      fused_ellip, fused_fista, fused_hmpc,
                                      fused_soc, fused_split, stage)
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
    "K2": (fused_fista, [(256, 192), (544, 416), (1024, 768)],
           [(1056, 192), (256, 1056)], 1024),
    "K3": (fused_eadmm, [(256, 9), (544, 9), (1024, 9)], [(1056, 9)], 1024),
    "K4": (fused_ellip, [(256,), (544,), (1024,)], [(1056,)], 1024),
    "K5": (fused_soc, [(288,), (544,), (1024,)], [(1056,)], 1024),
    "K6": (fused_hmpc, [(288, 288), (544, 544), (1024, 1024)],
           [(1056, 288), (288, 1056)], 1024),
    "K7": (fused_split, [(320,), (544,), (1024,)], [(1056,)], 1024),
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
    # columns, 64 classes fit its 8-lane build and 512 fit none; past 512
    # columns its wide build holds 32 classes at 1024 columns and no more
    fused_eadmm.check_width(512, 64)
    with pytest.raises(ValueError, match='shared memory: use backend="dense"'):
        fused_eadmm.check_width(512, 512)
    fused_eadmm.check_width(1024, 32)
    with pytest.raises(ValueError, match='shared memory: use backend="dense"'):
        fused_eadmm.check_width(1024, 33)


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


# kernel -> (module, its launch_plan's shape arguments at padded width W,
# its C source's function of the wide build's shared bytes, that
# function's arguments, shared_bytes' arguments for the wide build)
WIDE_PLANS = {
    "K2": (fused_fista, lambda W: (W, W - 128),
           dict(fixed_iters=0, k_max=100), "fused_fista_wide_smem",
           lambda W: dict(nzp=W, nlamp=W - 128),
           lambda W: (W, W - 128, 8)),
    "K3": (fused_eadmm, lambda W: (W, 9), dict(k_max=100),
           "fused_eadmm_wide_smem", lambda W: dict(Z=W, nd=9),
           lambda W: (W, 8, 9)),
    "K4": (fused_ellip, lambda W: (W, W - 30, 6), dict(fixed_iters=0),
           "fused_ellip_wide_smem", lambda W: dict(nzp=W),
           lambda W: (W, 6, 8)),
    "K5": (fused_soc, lambda W: (W, W - 32), {}, "fused_soc_wide_smem",
           lambda W: dict(P=W), lambda W: (W, 8)),
    "K6": (fused_hmpc, lambda W: (W, W, W - 32, 8), {},
           "fused_hmpc_wide_smem", lambda W: dict(dim_p=W, ns_p=W),
           lambda W: (W, W, 8)),
    "K7": (fused_split, lambda W: (W, W - 64, W - 32, 8), {},
           "fused_split_wide_smem", lambda W: dict(P=W), lambda W: (W,)),
}


def _c_return(src: str, fn: str) -> str:
    """The expression a one-line C function of `src` returns."""
    head = src.index(f'extern "C" long {fn}(')
    body = src[src.index("{", head) + 1:src.index("}", head)]
    return body.strip().removeprefix("return").strip().rstrip(";")


def _c_bytes(kernel: str, W: int) -> int:
    """The wide build's shared bytes as its C source computes them,
    evaluated in Python (wc::box_smem from csrc/wide_cols.cuh)."""
    import re
    module, _shape, _kw, fn, cargs, _ = WIDE_PLANS[kernel]
    name = module.__name__.rsplit(".", 1)[1]
    src = (_build.CSRC / f"{name}.cu").read_text()
    hdr = (_build.CSRC / "wide_cols.cuh").read_text()
    expr = _c_return(src, fn)
    box = hdr[hdr.index("inline long box_smem(int P) {"):]
    box = box[box.index("return") + 6:box.index(";")]
    expr = re.sub(r"wc::box_smem\((\w+)\)",
                  lambda m: "(" + re.sub(r"\bP\b", m.group(1), box) + ")",
                  expr)
    expr = expr.replace("wc::", "").replace("static_cast<long>", "")
    expr = re.sub(r"\b(\d+)L\b", r"\1", expr)
    env = dict(cargs(W), TB=8, WARPS=16)
    return eval(expr, {}, env)


@pytest.mark.parametrize("kernel", sorted(WIDE_PLANS))
@pytest.mark.parametrize("W", [256, 544, 1024])
def test_wide_launch_plan(kernel, W):
    """Each of K2-K7's launch plans names its wide build at 256, 544 and
    1024 columns: 512 threads, 8 lanes a block, one block per 8 lanes, no
    refill, its shared bytes within the 232,448 a block can have and equal
    to what the C source's wide_smem function computes. Past 512 columns
    the plan takes it by default; up to 512 the narrow builds, and no build
    of one thread a column is named past 512."""
    module, shape, extra, _fn, _c, sb = WIDE_PLANS[kernel]
    kw = dict(tile_b=8, check_every=8, exact_k=True, **extra)
    plan = module.launch_plan(8192, *shape(W), **kw, wide=True)
    assert plan["wide"] and plan["threads"] == 512 == stage.WIDE_THREADS
    assert plan["lanes"] == 8 and plan["blocks"] == 8192 // 8
    assert not plan["refill"]
    assert plan["smem"] <= fused_admm.SMEM_MAX
    assert plan["smem"] == module.shared_bytes(*sb(W), wide=True)
    assert plan["smem"] == _c_bytes(kernel, W)
    default = module.launch_plan(8192, *shape(W), **kw)
    assert default.get("wide", False) == (W > 512)
    if W > 512:
        assert default == plan
        with pytest.raises(ValueError, match="one thread a column"):
            module.launch_plan(8192, *shape(W), **kw, wide=False)
    else:
        assert default["threads"] == max(shape(W)[:2 if kernel in (
            "K2", "K6") else 1])


def test_wide_plan_takes_eight_lanes_alone():
    """The wide build is one build, 8 lanes a block: naming another raises,
    as does a batch of part of a group of 8."""
    kw = dict(tile_b=8, check_every=1, exact_k=False)
    for lanes in (16, 32):
        with pytest.raises(ValueError, match="8 lanes a block"):
            fused_soc.launch_plan(8192, 544, 512, **kw, lanes=lanes)
    assert fused_soc.launch_plan(8192, 544, 512, **kw, lanes=8)["wide"]
    with pytest.raises(ValueError):
        fused_soc.launch_plan(12, 544, 512, **kw)


def test_wide_constants_match_the_header():
    hdr = (_build.CSRC / "wide_cols.cuh").read_text()
    assert f"THREADS = {stage.WIDE_THREADS};" in hdr
    assert f"TB = {stage.WIDE_LANES};" in hdr
    assert f"CPT = {fused_admm.WIDE_CPT};" in hdr
    assert f"SMEM_MAX = {fused_admm.SMEM_MAX};" in hdr
    for name in ("fused_fista", "fused_eadmm", "fused_ellip", "fused_soc",
                 "fused_hmpc", "fused_split"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "wide_cols.cuh"' in src
        assert f"{name}_wide_kernel" in src
        assert f'extern "C" int {name}_wide_launch(' in src
        assert f'extern "C" long {name}_wide_smem(' in src


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


def _hmpc_param(param, N):
    """The HMPC fixture of tests/test_torch_fused_hmpc.py and
    tests/test_torch_fused_split.py (tests/test_hmpc.py:14-25) at horizon
    N."""
    p = dict(param, N=N)
    p.pop("T", None)
    p["w"] = 3 * 1.627 * 0.2
    p["Te"] = 10 * N * np.asarray(p["Q"])
    p["Th"] = p["Te"]
    p["Se"] = np.asarray(p["R"]).copy()
    p["Sh"] = 0.5 * p["Se"]
    return p


def _ellip_param(param, st, N):
    """The ellipMPC fixture of tests/test_torch_fused_ellip.py and
    tests/test_torch_fused_soc.py (P = I, c = xr, r = 0.5) at horizon N."""
    return dict(param, N=N, T=np.diag(np.sum(param["T"], axis=1)),
                P=np.eye(len(st["xr"])), c=np.asarray(st["xr"]), r=0.5)


def _wide_case(kernel):
    """(port test module, the kernel's plain-version solver pair at fp32
    with the JAX fused kernel in interpret mode, the inputs of B=8 lanes)
    for K2-K7 at the first oscillating-masses horizon whose padded width
    passes 512, each in its test module's settings."""
    import importlib
    sys, param, st = tsp.systems.tester_fixture()
    mod = importlib.import_module({
        "K2": "tests.test_torch_fused_fista",
        "K3": "tests.test_torch_fused_eadmm",
        "K4": "tests.test_torch_fused_ellip",
        "K5": "tests.test_torch_fused_soc",
        "K6": "tests.test_torch_fused_hmpc",
        "K7": "tests.test_torch_fused_split"}[kernel])
    N = WIDE_N[kernel]
    if kernel == "K2":
        p = dict(param, N=N, T=np.diag(np.sum(param["T"], axis=1)))
        pair = mod._fused_pair("laxMPC", sys, p)
    elif kernel == "K3":
        p = dict(param, N=N, T=10.0 * np.asarray(param["Q"]),
                 S=np.asarray(param["R"]).copy())
        pair = mod._fused_pair(sys, p)
    elif kernel in ("K4", "K5"):
        pair = mod._fused_pair(sys, _ellip_param(param, st, N))
    elif kernel == "K6":
        pair = mod._fused_pair(sys, _hmpc_param(param, N))
    else:
        pair = mod._fused_pair(sys, _hmpc_param(param, N), "ADMM")
    return mod, pair, mod._data(st, 8, 7)


# the first oscillating-masses horizon whose padded width passes 512 for
# the family each test module runs (chip_smoke.py WIDE_HORIZONS)
WIDE_N = {"K2": 65, "K3": 64, "K4": 65, "K5": 60, "K6": 61, "K7": 58}
# lanes at the tolerance boundary, which end one iteration apart from the
# JAX kernel's as the frameworks' sums of the products differ in order
# (tests/test_torch_fused_soc.py MOVED and tests/test_torch_fused_split.py
# MOVED_WARM name such lanes at N=30): K5's lanes 0 (k 1212 here, 1211 in
# the JAX run) and 3 (284, 285); K7's lanes 2 (582, 581) and 4 (589, 588)
WIDE_MOVED = {"K5": (0, 3), "K7": (2, 4)}
# lanes that stall above tol 1e-5 at fp32 in both frameworks and reach the
# modules' k_max of 3000 (lane 0's x0 is 1.5 times the fixture's): equal k
# and e_flag -1 in both (with k_max 8000 they still do not converge)
WIDE_STALLED = {"K6": (0,), "K7": (0,)}
# the padded widths there (K2: nz, nlam; K6: dim_p, ns_p)
WIDE_SHAPES = {"K2": (544, 416), "K3": (544,), "K4": (544,), "K5": (544,),
               "K6": (544, 544), "K7": (544,)}


@pytest.mark.parametrize("kernel", sorted(WIDE_N))
def test_plain_version_past_512_columns_matches_jax_fused(kernel):
    """K2-K7's plain versions at the first horizon past 512 columns (on the
    card, each kernel's wide build), B=8, checked mode, fp32, in each
    kernel's test module settings: the JAX fused kernel's per-lane k and
    e_flag, and iterates within that module's drift bound
    (_assert_parity)."""
    mod, (s_j, s_t), x = _wide_case(kernel)
    shapes = [t.shape for t in s_t.raw_fn.operator if t.dim() == 2]
    assert max(max(s) for s in shapes) > 512
    assert max(max(s) for s in shapes) == max(WIDE_SHAPES[kernel])
    rt = s_t(*x)
    stalled = np.zeros(8, bool)
    stalled[list(WIDE_STALLED.get(kernel, ()))] = True
    np.testing.assert_array_equal(rt.e_flag.numpy(),
                                  np.where(stalled, -1, 1))
    mod._assert_parity(s_j(*x), rt, int(rt.k.max()) + 8,
                       WIDE_MOVED.get(kernel, ()))
