"""The widths each fused kernel takes, checked without CUDA: every kernel
module's `check_width` takes the N=30 widths of its families and the wide
widths up to 1024, and refuses the first padded width past 1024, naming the
kernel, the width, the cap and backend="dense" (the fused builders call it
when they build for the card, so that make_solver refuses a width no build
takes); each launch plan takes the wide build past 512 columns (and where
it is named), and sizes its shared memory as the C source does; K1's
plain version at 544 columns (MPCT-ADMM-cs, N=33) and K2-K7's at the first
oscillating-masses horizon past 512 columns, and K5's and K7's at the
widest up to 1024 columns, give the JAX fused kernel's per-lane k and
e_flag in interpret mode."""

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
# function's arguments, shared_bytes' arguments for the wide build at L
# lanes a block)
WIDE_PLANS = {
    "K2": (fused_fista, lambda W: (W, W - 128),
           dict(fixed_iters=0, k_max=100), "fused_fista_wide_smem",
           lambda W: dict(nzp=W, nlamp=W - 128),
           lambda W, L: (W, W - 128, L)),
    "K3": (fused_eadmm, lambda W: (W, 9), dict(k_max=100),
           "fused_eadmm_wide_smem", lambda W: dict(Z=W, nd=9),
           lambda W, L: (W, L, 9)),
    "K4": (fused_ellip, lambda W: (W, W - 30, 6), dict(fixed_iters=0),
           "fused_ellip_wide_smem", lambda W: dict(P=W, n=6),
           lambda W, L: (W, 6, L)),
    "K5": (fused_soc, lambda W: (W, W - 32), {}, "fused_soc_wide_smem",
           lambda W: dict(P=W), lambda W, L: (W, L)),
    "K6": (fused_hmpc, lambda W: (W, W, W - 32, 8), {},
           "fused_hmpc_wide_smem", lambda W: dict(dim_p=W, ns_p=W),
           lambda W, L: (W, W, L)),
    "K7": (fused_split, lambda W: (W, W - 64, W - 32, 8), {},
           "fused_split_wide_smem", lambda W: dict(P=W),
           lambda W, L: (W, L)),
}
# every wide build runs on the stage's engine (kernels/stage.py
# WIDE_BUILDS); K4-K7's refill, K2's and K3's keep a block of L lanes
STAGE_WIDE = ("K2", "K3", "K4", "K5", "K6", "K7")
REFILL_WIDE = ("K4", "K5", "K6", "K7")
# a block's shared bytes with its three leaves in shared memory at 16 lanes
# a block and 8-row slabs, at 1024 columns (of both widths)
THREE_LEAVES_1024 = {
    "K4": lambda: fused_ellip._bytes(1024, 6, 16, 8, 3, 16),
    "K5": lambda: fused_soc._bytes(1024, 16, 8, 3, 16),
    "K6": lambda: fused_hmpc._bytes(1024, 1024, 16, 8, 3, 16),
    "K7": lambda: fused_split._bytes(1024, 16, 8, 3, 16),
}


def _c_return(src: str, fn: str) -> str:
    """The expression a one-line C function of `src` returns."""
    head = src.index(f'extern "C" long {fn}(')
    body = src[src.index("{", head) + 1:src.index("}", head)]
    return body.strip().removeprefix("return").strip().rstrip(";")


def _py(expr: str) -> str:
    """A C expression of the sources as Python: no namespaces, casts or
    long suffixes, integer division, a conditional as Python's."""
    import re
    expr = expr.replace("wc::", "").replace("tp::", "")
    expr = expr.replace("static_cast<long>", "").replace("/", "//")
    expr = re.sub(r"\b(\d+)L\b", r"\1", expr)
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", expr, re.S)
    return f"(({m[2]}) if ({m[1]}) else ({m[3]}))" if m else f"({expr})"


def _c_fn(src: str, head: str) -> str:
    """The expression the one-line C function `head` of `src` returns."""
    i = src.index(head)
    body = src[src.index("{", i) + 1:src.index("}", i)]
    return body.strip().removeprefix("return").strip().rstrip(";")


def _c_def(src: str, name: str, env: dict):
    """The one-line C function `name` of `src` (its return expression over
    int parameters) as a Python function evaluated in `env`."""
    import re
    head = re.search(rf"\b{name}\(([^)]*)\)\s*{{", src)
    params = [p.split()[-1] for p in head[1].split(",")]
    expr = _py(_c_fn(src, head[0]))
    return lambda *a: eval(expr, {}, dict(env, **dict(zip(params, a))))


def _c_bytes(kernel: str, W: int, lanes: int = 8, cargs=None) -> int:
    """The wide build's shared bytes as its C source computes them,
    evaluated in Python: the source's wide_smem function over its one-line
    helpers (wide_bytes over the stage's ring, tp::ring_bytes of
    csrc/tile_product.cuh: two buffers and 64 bytes of mbarriers; the
    layout's choices, wide_global, wide_slab_rows, wide_staged) at `lanes`
    lanes a block, with the constants of the source and of
    csrc/tile_product.cuh, at WIDE_PLANS' arguments of padded width W or
    at `cargs`."""
    import re
    module, _shape, _kw, fn, c_of, _ = WIDE_PLANS[kernel]
    name = module.__name__.rsplit(".", 1)[1]
    src = (_build.CSRC / f"{name}.cu").read_text()
    tph = (_build.CSRC / "tile_product.cuh").read_text()
    wide = src[src.index("#if WIDE_PART"):]
    assert "4L * NST * SR * P + (TP_STAGE == 2 ? 64L : 0L)" in tph
    assert "#define TP_STAGES 2\n" in tph and "#define TP_STAGE 2 " in tph
    assert "WARPS = tp::WIDE_THREADS / 32;" in wide or "WARPS" not in wide
    env = dict(cargs or c_of(W), lanes=lanes, WARPS=stage.WIDE_WARPS)
    env.update({k: int(v) for k, v in re.findall(
        r"constexpr (?:int|long) (\w+) = (\d+);", tph + wide)})
    env.update(wide_slab=lambda n: env[f"WIDE_SLAB_{n}"],
               ring_bytes=lambda P, SR: 4 * 2 * SR * P + 64)
    for helper in re.findall(r"^(?:long|int|bool) (\w+)\(", wide, re.M):
        env[helper] = _c_def(wide, helper, env)
    return eval(_py(_c_return(src, fn)), {}, env)


@pytest.mark.parametrize("kernel", sorted(WIDE_PLANS))
@pytest.mark.parametrize("W", [256, 544, 1024])
def test_wide_launch_plan(kernel, W):
    """Each of K2-K7's launch plans names its wide build at 256, 544 and
    1024 columns: 512 threads at 16 lanes a block, its shared bytes within
    the 232,448 a block can have and equal to what the C source's
    wide_smem function computes, also at 8 lanes. K4-K7: 16-row slabs and
    the three leaves in shared memory where they fit (up to 544 columns),
    else the second and third leaves in global scratch and 8-row slabs
    (the three leaves at 16 lanes would pass the 232,448 bytes), refill in
    every mode (K4's fixed_iters: static blocks of 16 lanes), persistent
    blocks, no more than the SMs (one block an SM) and the groups fill. K2
    and K3: one block per 16 lanes, no refill, their state laid out by
    their own layouts. Past 512 columns the plan takes the wide build by
    default; up to 512 the narrow builds, and no build of one thread a
    column is named past 512."""
    module, shape, extra, _fn, _c, sb = WIDE_PLANS[kernel]
    kw = dict(tile_b=8, check_every=8, exact_k=True, **extra)
    plan = module.launch_plan(8192, *shape(W), **kw, wide=True)
    assert plan["wide"] and plan["threads"] == 512 == stage.WIDE_THREADS
    assert plan["lanes"] == 16
    assert plan["smem"] == module.shared_bytes(*sb(W, 16), wide=True)
    assert plan["smem"] == _c_bytes(kernel, W, 16)
    eight = module.launch_plan(8192, *shape(W), **kw, wide=True, lanes=8)
    assert eight["smem"] == _c_bytes(kernel, W, 8)
    assert eight["smem"] == module.shared_bytes(*sb(W, 8), wide=True)
    if kernel in REFILL_WIDE:
        assert plan["refill"]
        assert plan["global_leaves"] == (W > 544)
        assert plan["slab"] == (16 if W <= 544 else stage.GLOBAL_SLAB)
        assert plan["blocks"] == min(8192 // 16, fused_admm.SMS * 1)
        assert eight["slab"] == 8 and not eight["global_leaves"]
        assert eight["blocks"] == fused_admm.SMS and eight["refill"]
        if kernel == "K4":
            fixed = module.launch_plan(8192, *shape(W),
                                       **dict(kw, fixed_iters=50), wide=True)
            assert fixed == dict(plan, refill=False, blocks=8192 // 16)
    else:
        assert not plan["refill"] and plan["blocks"] == 8192 // 16
        assert not eight["refill"] and eight["blocks"] == 8192 // 8
        assert plan["slab"] == _k23_slab(kernel, sb(W, 16))
        assert plan["global_leaves"]
    assert plan["smem"] <= fused_admm.SMEM_MAX
    default = module.launch_plan(8192, *shape(W), **kw)
    assert default.get("wide", False) == (W > 512)
    if W > 512:
        assert default == plan
        with pytest.raises(ValueError, match="one thread a column"):
            module.launch_plan(8192, *shape(W), **kw, wide=False)
    else:
        assert default["threads"] == max(shape(W)[:2 if kernel in (
            "K2", "K6") else 1])


def _k23_slab(kernel, args):
    """K2's or K3's wide build's rows a slab at shared_bytes' arguments."""
    if kernel == "K2":
        return fused_fista.wide_slab(*args)
    return fused_eadmm.wide_layout(*args)[0]


# K2's and K3's wide layouts at phase 17's shapes (chip_smoke.py
# WIDE_HORIZONS: laxMPC-FISTA N=65 and 128, MPCT-EADMM N=64 and 127, whose
# nd is 9 and 8): padded width -> shape arguments, and lanes a block ->
# (rows a slab, global leaves; K3 also whether C2d is copied to shared
# memory)
K23_LAYOUTS = {
    ("K2", 544): ((544, 416), {16: (16, True), 8: (16, True)}),
    ("K2", 1024): ((1024, 768), {16: (8, True), 8: (16, True)}),
    ("K3", 544): ((544, 9), {16: (16, True, True), 8: (8, True, True)}),
    ("K3", 1024): ((1024, 8), {16: (8, True, True), 8: (8, True, True)}),
}


@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("kernel,W", sorted(K23_LAYOUTS))
def test_k2_k3_wide_layouts(kernel, W, lanes):
    """K2's and K3's wide builds at phase 17's shapes, 8 and 16 lanes a
    block: one block per L lanes, no refill, and the layout each picks.
    K2: its four leaves in global scratch, 16-row slabs where they fit (not
    at 1024 x 768 columns, 16 lanes). K3: the nine leaves and dv2t in
    global scratch; C2d copied to shared memory
    where it fits beside 8-row slabs (here everywhere), then 16-row slabs
    of M3p where they fit beside the rest (544 columns, 16 lanes). The
    shared bytes are those of the C source's wide_smem expression, and the
    layout one step richer does not fit."""
    module = WIDE_PLANS[kernel][0]
    shape, layouts = K23_LAYOUTS[(kernel, W)]
    kw = dict(tile_b=8, check_every=8, exact_k=True, k_max=100,
              **(dict(fixed_iters=0) if kernel == "K2" else {}))
    plan = module.launch_plan(8192, *shape, **kw, lanes=lanes)
    assert plan["wide"] and plan["lanes"] == lanes and not plan["refill"]
    assert plan["blocks"] == 8192 // lanes and plan["threads"] == 512
    cargs = (dict(nzp=shape[0], nlamp=shape[1]) if kernel == "K2" else
             dict(Z=shape[0], nd=shape[1]))
    assert plan["smem"] == _c_bytes(kernel, W, lanes, cargs)
    assert plan["smem"] <= fused_admm.SMEM_MAX
    want = layouts[lanes]
    if kernel == "K2":
        nzp, nlamp = shape
        assert (plan["slab"], plan["global_leaves"]) == want
        assert module.wide_slab(nzp, nlamp, lanes) == want[0]
        if want[0] < 16:
            assert module._wide_bytes(nzp, nlamp, lanes, 16) > (
                fused_admm.SMEM_MAX)
    else:
        Z, nd = shape
        assert (plan["slab"], plan["global_leaves"],
                plan["c2d_staged"]) == want
        slab, staged = want[0], want[2]
        if not staged:
            assert module._wide_bytes(Z, lanes, nd, stage.GLOBAL_SLAB,
                                      True) > fused_admm.SMEM_MAX
        if slab < stage.WIDE_BUILDS[lanes][0]:
            assert module._wide_bytes(Z, lanes, nd, 16, staged) > (
                fused_admm.SMEM_MAX)


@pytest.mark.parametrize("Z", [544, 1024])
def test_k3_wide_build_takes_every_class_count_it_took(Z):
    """Past 512 columns check_width takes nd up to wide_classes(Z), 82
    classes at 544 columns and 32 at 1024, and refuses one more: the first
    wide layout's rule (C2d's [Z][nd] beside three [Z][8] buffers and 16
    warps' three row maxima of 8 lanes in 232,448 bytes), so that the
    kernel takes and refuses what it did; and the wide build on the stage
    takes each of those counts at 16 lanes a block (planned) and at 8."""
    top = fused_eadmm.wide_classes(Z)
    assert top == {544: 82, 1024: 32}[Z]
    assert 4 * (24 * Z + 384 + Z * top) <= fused_admm.SMEM_MAX
    assert 4 * (24 * Z + 384 + Z * (top + 1)) > fused_admm.SMEM_MAX
    kw = dict(tile_b=8, check_every=8, exact_k=True, k_max=100)
    for nd in range(1, top + 1):
        fused_eadmm.check_width(Z, nd)
        assert fused_eadmm.launch_plan(8192, Z, nd, **kw)["lanes"] == 16
        plan = fused_eadmm.launch_plan(8192, Z, nd, **kw, lanes=8)
        assert plan["wide"] and plan["smem"] <= fused_admm.SMEM_MAX
    with pytest.raises(ValueError, match='shared memory: use backend="dense"'):
        fused_eadmm.check_width(Z, top + 1)


def _chip_smoke():
    """chip_smoke.py as a module (it needs no card until main runs)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("run", [2, 3])
def test_phase_17_k3_plants_take_the_ldg_layout(run):
    """chip_smoke.py's phase-17 runs of K3 on random plants (WIDE_EXTRA)
    reach 1024 padded columns with more classes of columns than C2d's copy
    fits beside the 16-lane build's ring, so that the card runs the layout
    whose z2 chains read C2d by __ldg: nd 21, where the 8-lane build still
    copies it, and nd 29, where neither does."""
    cs = _chip_smoke()
    fam, horizon, pk, _ = cs.wide_runs("fused_eadmm")[run]
    cs.DEVICE = "cpu"
    solver = cs.fam_solver(tsp, fam, horizon=horizon, **pk)
    Z = max(max(t.shape) for t in solver.raw_fn.operator if t.dim() == 2)
    nd = solver.raw_fn.classes[0].shape[1]
    assert (Z, nd) == (1024, {2: 21, 3: 29}[run])
    kw = dict(tile_b=256, check_every=1, exact_k=False, k_max=5000)
    plan = fused_eadmm.launch_plan(cs.FB, Z, nd, **kw)
    assert (plan["lanes"], plan["c2d_staged"]) == (16, False)
    eight = fused_eadmm.launch_plan(cs.FB, Z, nd, **kw, lanes=8)
    assert eight["c2d_staged"] == (run == 2)


def test_first_wide_layout_retired():
    """The first wide layout is gone: its header no longer exists, no
    kernel source or header under csrc/ names it, and kernels/stage.py
    plans every wide build through `plan` (no wide_plan, no
    WIDE_LANES)."""
    assert not (_build.CSRC / "wide_cols.cuh").exists()
    for f in sorted(_build.CSRC.glob("**/*.cu*")):
        assert "wide_cols" not in f.read_text(), f
    assert not hasattr(stage, "wide_plan")
    assert not hasattr(stage, "WIDE_LANES")


@pytest.mark.parametrize("kernel", STAGE_WIDE)
def test_stage_wide_plans_refuse_what_does_not_fit(kernel):
    """Every wide build runs 16 or 8 lanes a block: 32 lanes are refused at
    every width, as is a batch of part of a group of 8. K4-K7: 16 lanes at
    1024 columns keep their first leaf alone in shared memory (their three
    leaves, dq and a ring of 8-row slabs would need 346,320 bytes or more);
    8 lanes take 1024 columns with their three leaves, and every batch of
    whole groups, its blocks no more than the groups. K2 and K3 (no
    refill): 16 lanes at 1024 columns take 8-row slabs with their leaves
    in global scratch, 8 lanes their own slab and any batch of
    whole groups, one block per 8 lanes, and 16 lanes only a batch of
    whole blocks."""
    module, shape, extra, _fn, _c, _sb = WIDE_PLANS[kernel]
    for mode in (dict(check_every=1, exact_k=False),
                 dict(check_every=8, exact_k=True)):
        kw = dict(tile_b=8, **mode, **extra)
        for W in (544, 1024):
            with pytest.raises(ValueError, match="no build"):
                module.launch_plan(8192, *shape(W), **kw, lanes=32)
        plan = module.launch_plan(8192, *shape(1024), **kw, lanes=16)
        assert plan["global_leaves"] and plan["slab"] == 8
        assert plan["smem"] <= fused_admm.SMEM_MAX
        assert module.launch_plan(8192, *shape(1024), **kw) == plan
        plan = module.launch_plan(8192, *shape(1024), **kw, lanes=8)
        assert plan["wide"]
        if kernel in REFILL_WIDE:
            assert THREE_LEAVES_1024[kernel]() >= 346320 > (
                fused_admm.SMEM_MAX)
            assert plan["refill"] and not plan["global_leaves"]
            assert plan["slab"] == 8
        else:
            assert not plan["refill"] and plan["blocks"] == 8192 // 8
            assert plan["slab"] == _k23_slab(kernel,
                                             WIDE_PLANS[kernel][5](1024, 8))
            odd = module.launch_plan(8200, *shape(544), **kw)
            assert odd["lanes"] == 8 and odd["blocks"] == 1025
            with pytest.raises(ValueError, match="no build"):
                module.launch_plan(8200, *shape(544), **kw, lanes=16)
        small = module.launch_plan(40, *shape(544), **kw)
        assert small["lanes"] == 8 and small["blocks"] == 5
        with pytest.raises(ValueError):
            module.launch_plan(12, *shape(544), **kw)


def test_wide_constants_match_the_header():
    """K2-K7 build their wide kernels on the stage (csrc/tile_product.cuh
    alone), whose wide constants (tp::WIDE_*, one copy for the six) are
    those kernels/stage.py plans for: 512 threads of two columns, tiles of
    tp::wide_tc<L>() columns, a build for each of stage.WIDE_BUILDS' lanes
    a block; K4-K7 through the refill loops (tp::run_lanes), K2 and K3
    through tp::run_modes, as their narrow builds."""
    tph = (_build.CSRC / "tile_product.cuh").read_text()
    assert f"WIDE_CPT = {fused_admm.WIDE_CPT};" in tph
    assert f"WIDE_THREADS = {stage.WIDE_THREADS};" in tph
    assert f"SMEM_MAX = {fused_admm.SMEM_MAX};" in tph
    for lanes, (slab, per_sm) in stage.WIDE_BUILDS.items():
        assert f"WIDE_SLAB_{lanes} = {slab};" in tph
        assert per_sm == 1
    assert stage.GLOBAL_SLAB == stage.WIDE_BUILDS[8][0]
    for name in ("fused_fista", "fused_eadmm", "fused_ellip", "fused_soc",
                 "fused_hmpc", "fused_split"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        wide = src[src.index("#if WIDE_PART"):]
        assert _build.included_files(_build.CSRC / f"{name}.cu") == [
            _build.CSRC / f"{name}.cu", _build.CSRC / "tile_product.cuh"]
        assert f"{name}_wide_kernel" in wide
        assert f'extern "C" int {name}_wide_launch(' in wide
        assert f'extern "C" long {name}_wide_smem(' in wide
        assert "constexpr int WIDE_CPT" not in src
        assert "wide_tc() {" not in src
        assert f"MAX_COLS = {fused_admm.MAX_COLS};" in src
        assert "__launch_bounds__(tp::WIDE_THREADS, 1)" in wide
        assert "tp::wide_tc<L>()" in wide
        if name in ("fused_fista", "fused_eadmm"):
            for lanes in stage.WIDE_BUILDS:
                assert f"wide_launch<{lanes}, " in wide
            assert "tp::run_modes<L" in wide and "run_lanes" not in wide
            continue
        for lanes in stage.WIDE_BUILDS:
            assert f"wide_lanes<{lanes}, false>(p, " in wide
        # 16 lanes with the global leaves, at GLOBAL_SLAB rows a slab
        assert "wide_lanes<16, true>(p, " in wide
        assert "GL ? tp::WIDE_SLAB_8 : tp::wide_slab(L)" in wide
        for build in ("<L, GL, false, false>", "<L, GL, true, true>",
                      "<L, GL, true, false>"):
            assert f"wide_launch{build}(p, " in wide
        assert "tp::run_lanes<L, REFILL, EXACT>" in wide


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


def _wide_case(kernel, N=None, **kw):
    """(port test module, the kernel's plain-version solver pair at fp32
    with the JAX fused kernel in interpret mode, the inputs of B=8 lanes)
    for K2-K7 at the first oscillating-masses horizon whose padded width
    passes 512 (or at horizon N, K4-K7, with the solver options `kw`),
    each in its test module's settings."""
    import importlib
    sys, param, st = tsp.systems.tester_fixture()
    mod = importlib.import_module({
        "K2": "tests.test_torch_fused_fista",
        "K3": "tests.test_torch_fused_eadmm",
        "K4": "tests.test_torch_fused_ellip",
        "K5": "tests.test_torch_fused_soc",
        "K6": "tests.test_torch_fused_hmpc",
        "K7": "tests.test_torch_fused_split"}[kernel])
    N = N or WIDE_N[kernel]
    if kernel == "K5":
        return mod, mod._fused_pair(sys, _ellip_param(param, st, N),
                                    **kw), mod._data(st, 8, 7)
    if kernel == "K7":
        return mod, mod._fused_pair(sys, _hmpc_param(param, N), "ADMM",
                                    **kw), mod._data(st, 8, 7)
    if kernel == "K2":
        p = dict(param, N=N, T=np.diag(np.sum(param["T"], axis=1)))
        pair = mod._fused_pair("laxMPC", sys, p)
    elif kernel == "K3":
        p = dict(param, N=N, T=10.0 * np.asarray(param["Q"]),
                 S=np.asarray(param["R"]).copy())
        pair = mod._fused_pair(sys, p)
    elif kernel == "K4":
        pair = mod._fused_pair(sys, _ellip_param(param, st, N), **kw)
    else:
        pair = mod._fused_pair(sys, _hmpc_param(param, N), **kw)
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


# the widest oscillating-masses horizon whose padded width stays at 1024
# (chip_smoke.py WIDE_HORIZONS), where K4-K7 run 16 lanes a block with
# global leaves on the card; lanes that end apart from the JAX kernel's as
# the frameworks' sums of the products differ in order, and by how many
# iterations: K5's lane 0 (1216 here, 1211 in the JAX run; the slowest
# lane, which at N=60 ends one apart, WIDE_MOVED), in both modes
WIDEST_N = {"K4": 128, "K5": 123, "K6": 124, "K7": 121}
WIDEST_MOVED = {"K5": ((0,), 5)}
# lanes whose k and e_flag are the JAX kernel's but whose iterates drift
# past their module's bar (2e-7 an iteration: 8.26e-5 here, lam's scaled
# to 3.56e-4), in both modes: K4's eight lanes, by up to 1.94e-4 in z and
# v and 4.2e-4 in lam, on the state columns that sit on their box bound of
# 0.5 along the horizon, where the ADMM iterate moves freely along the
# bound; they are held to k exactly and u within 1e-4 (_assert_parity's
# moved lanes, with step 0), and their residuals r_p and r_d (1.2e-7
# apart) to the bar
WIDEST_DRIFT = {"K4": tuple(range(8))}
WIDEST_MODES = {"checked": {}, "exact-k": dict(check_every=8, exact_k=True)}


@pytest.mark.parametrize("mode", sorted(WIDEST_MODES))
@pytest.mark.parametrize("kernel", sorted(WIDEST_N))
def test_plain_version_at_1024_columns_matches_jax_fused(kernel, mode):
    """K4's, K5's, K6's and K7's plain versions at the widest horizon up to
    1024 columns (on the card, their wide builds at 16 lanes a block), B=8,
    checked and exact-k, fp32, in each kernel's test module settings: the
    JAX fused kernel's per-lane k and e_flag exactly (WIDEST_MOVED's lanes
    within their iterations), and iterates within that module's drift
    bound (_assert_parity; WIDEST_DRIFT's lanes to k and u alone)."""
    mod, (s_j, s_t), x = _wide_case(kernel, WIDEST_N[kernel],
                                    **WIDEST_MODES[mode])
    shapes = [t.shape for t in s_t.raw_fn.operator if t.dim() == 2]
    assert max(max(s) for s in shapes) == 1024
    rt = s_t(*x)
    stalled = np.zeros(8, bool)
    stalled[list(WIDE_STALLED.get(kernel, ()))] = True
    np.testing.assert_array_equal(rt.e_flag.numpy(),
                                  np.where(stalled, -1, 1))
    moved, step = WIDEST_MOVED.get(kernel, ((), 1))
    rj, iters = s_j(*x), int(rt.k.max()) + 8
    if kernel in WIDEST_DRIFT:
        moved, step = WIDEST_DRIFT[kernel], 0
        bar = max(mod.ATOL_FP32, mod.ATOL_PER_ITER * iters)
        for key in ("r_p", "r_d"):
            np.testing.assert_allclose(rt.sol[key].numpy(),
                                       np.asarray(rj.sol[key]), rtol=0,
                                       atol=bar, err_msg=key)
    mod._assert_parity(rj, rt, iters, moved, step)
