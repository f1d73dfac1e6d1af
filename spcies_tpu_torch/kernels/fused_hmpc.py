"""Fused single-split cone ADMM for HMPC-ADMM and ellipHMPC-ADMM: the
wrapper of the hand-written CUDA kernel (csrc/fused_hmpc.cu) and its plain
PyTorch version.

Counterpart of spcies_tpu/kernels/fused_hmpc.py (`_fused_hmpc_kernel`). A
lane's state is z (dim_p columns) and s, lam (ns_p columns each), and one
iteration is

    czd  = z @ CT - d                     (an O(1) operand: full fp32)
    y    = -czd - rho^-1 lam
    s    = clip(y, lb, ub) on the box rows; on each cone's (y0, y1, y2):
           SOC (a=+1, dd=0), or the diamond: (a=+1, dd=lby), then
           (a=-1, dd=uby), each in `proj_ssoc_seg`'s form
    lam += rho (czd + s)
    w    = rho (s - s_old) + rho (czd + s)
    z   += w @ MC                         (MC = C M1', delta form)
    r_p  = max |czd + s|, r_d = max |s - s_old|

Layout of the s columns (`cone_columns`): the n_box box rows first, then
from column cone0 = round_up(n_box, 32) whole warps of cones, g cones a
warp (at most 10, `cone_layout`): cone c of a warp has its y0, y1 and y2
at lanes c, g + c and 2g + c, so the three entries a projection couples
lie in one warp. Pad columns carry zero rows and columns of CT and MC,
d = 0 and [0, 0] bounds; pad cone slots project a zero triple onto zero in
both modes. So pad state stays exactly 0. The rows lb/ub hold the box
bounds on the box rows and the cone's D-set bounds on each of its three
lanes. The batch is padded to a multiple of tile_b by the caller.

Modes, as kernels/fused_admm.py has them: checked (check_every=1, freeze
blending, the consumed z returned), plain free-run (check_every>1, the
prepared z returned) and exact-k (window snapshots of (z, s, lam) and a
budgeted replay); there is no fixed_iters mode, as in the JAX kernel.

`fused_hmpc_solve` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; `fused_hmpc_solve.launches` counts the launches and
`fused_hmpc_solve.last_plan` holds the last launch's build and geometry.

The kernel runs on the product stage csrc/tile_product.cuh, built for 8, 16
and 32 lanes a block (kernels/stage.py); plain free-run and the checked mode
refill its persistent blocks group by group of 8 lanes. Every build gives
the same bits, so `lanes=` of `fused_hmpc_solve` may name another build, for
a check or a timing.

Past MAX_COLS columns of either width, up to WIDE_COLS, the wide build
(fused_hmpc_wide_kernel, csrc/wide_cols.cuh) runs 512 threads at 8 lanes a
block, each thread taking two columns of each width (t and t + 512), no
refill, with the consumed z, s and lam in global memory; `wide=` of
`fused_hmpc_solve` names it at any width, for a check of bits. The cones
keep their warps: a warp of cones, 32 columns from cone0 on, lies in one
half, [0, 512) or [512, ns_p), of a thread's s columns.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, DQ_PAD, MAX_COLS,
                                                 WIDE_COLS, check_widths,
                                                 round_up)
from spcies_tpu_torch.kernels.modes import run_modes

__all__ = ["check_width", "COL_PAD", "MAX_COLS", "round_up", "cone_layout",
           "cone_columns", "proj_ssoc_seg", "fused_hmpc_reference",
           "fused_hmpc_solve", "launch_plan", "launch_geometry",
           "shared_bytes"]

WARP = 32
# cones a warp holds at most: three lanes each
MAX_CONES_PER_WARP = WARP // 3
# C signature of fused_hmpc_launch: 17 pointers (8 inputs, 7 outputs, the
# exact-k snapshot scratch, the refill queue); B, dim_p, ns_p, cone0,
# cone_g, use_soc, lanes, blocks, threads, shared bytes; rho, rho_i, tol_p,
# tol_d; k_max, check_every, exact_k; the stream
FUSED_HMPC_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
# lanes a block -> (rows a slab of MC, blocks an SM) of its build up to
# stage.NARROW columns (Build<L> in csrc/fused_hmpc.cu)
BUILDS = {8: (16, 2), 16: (8, 2), 32: (32, 1)}
# the leaves an exact-k snapshot saves per lane: z, s, lam
SNAP_LEAVES = 3
# C signature of fused_hmpc_wide_launch: 17 pointers (the refill queue's
# place holds the blocks' global state); B, dim_p, ns_p, cone0, cone_g,
# use_soc, blocks, threads, shared bytes; rho, 1/rho, tol_p, tol_d; k_max,
# check_every, exact_k; the stream
FUSED_HMPC_WIDE_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
                            + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                            + [ctypes.c_void_p])


def cone_layout(n_cones: int) -> tuple[int, int]:
    """(warps, cones a warp) of the cone columns: as few warps as hold
    n_cones at MAX_CONES_PER_WARP each, the cones spread evenly."""
    warps = max(1, -(-n_cones // MAX_CONES_PER_WARP))
    return warps, -(-n_cones // warps)


def cone_columns(warps: int, g: int, cone0: int) -> np.ndarray:
    """[warps * g, 3] columns of each cone slot's (y0, y1, y2) for `warps`
    warps of g cones from column cone0 (`cone_layout`); slots past the
    real cones are pads."""
    c = np.arange(warps * g)
    base = cone0 + WARP * (c // g) + c % g
    return np.stack([base, base + g, base + 2 * g], axis=1)


def proj_ssoc_seg(y0, y1, y2, a: float, dd):
    """Branch-free shifted-SOC projection onto {||(y1, y2)|| <= a (y0 - dd)},
    a in {-1, +1}, in the JAX kernel's form (spcies_tpu/kernels/
    fused_hmpc.py `_proj_ssoc_seg`): the three cases blended by 0/1
    weights."""
    ny1 = torch.sqrt(y1 * y1 + y2 * y2)
    corr = a * (y0 - dd)
    inside = (ny1 <= corr).to(y0.dtype)
    apex = (ny1 <= -corr).to(y0.dtype) * (1.0 - inside)
    proj = (1.0 - inside) * (1.0 - apex)
    safe = torch.clamp(ny1, min=1e-30)
    step = (corr + ny1) / (2.0 * safe)
    z0 = inside * y0 + apex * dd + proj * (step * ny1 * a + dd)
    z1 = inside * y1 + proj * (step * y1)
    z2 = inside * y2 + proj * (step * y2)
    return z0, z1, z2


def cone_project(y, lb, ub, cols, use_soc: bool):
    """Clip every column of y onto [lb, ub], then project each cone slot's
    (y0, y1, y2) at `cols` ([slots, 3] long tensor): SOC, or the diamond
    with the bounds on the slot's y0 column."""
    s = torch.minimum(torch.maximum(y, lb), ub)
    c0, c1, c2 = cols[:, 0], cols[:, 1], cols[:, 2]
    y0, y1, y2 = y[:, c0], y[:, c1], y[:, c2]
    if use_soc:
        y0, y1, y2 = proj_ssoc_seg(y0, y1, y2, 1.0, 0.0)
    else:
        y0, y1, y2 = proj_ssoc_seg(y0, y1, y2, 1.0, lb[:, c0])
        y0, y1, y2 = proj_ssoc_seg(y0, y1, y2, -1.0, ub[:, c0])
    s[:, c0], s[:, c1], s[:, c2] = y0, y1, y2
    return s


class _Ops:
    """One iteration in the kernel's operation order, over padded
    operators."""

    def __init__(self, CT, MC, d, lb, ub, *, rho, use_soc, cone0, cone_g):
        self.CT, self.MC = CT, MC
        self.d, self.lb, self.ub = (r.reshape(1, -1) for r in (d, lb, ub))
        self.rho, self.rho_i = float(rho), float(1.0 / rho)
        self.use_soc = bool(use_soc)
        self.cols = torch.as_tensor(
            cone_columns((CT.shape[1] - cone0) // WARP, cone_g, cone0),
            device=CT.device)

    def iterate(self, z, s_old, lam):
        """One single-split iteration; returns (z_next, s_new, lam_new,
        r_p, r_d)."""
        czd = z @ self.CT - self.d
        y = -czd - self.rho_i * lam
        s_new = cone_project(y, self.lb, self.ub, self.cols, self.use_soc)
        resid = czd + s_new
        lam_new = lam + self.rho * resid
        ds = s_new - s_old
        w = self.rho * ds + self.rho * resid
        z_next = z + w @ self.MC
        return (z_next, s_new, lam_new, torch.amax(torch.abs(resid), dim=1),
                torch.amax(torch.abs(ds), dim=1))


def fused_hmpc_reference(z1, s0, lam0, CT, MC, d_row, lb_row, ub_row, *,
                         rho: float, tol_p: float, tol_d: float, k_max: int,
                         use_soc: bool, cone0: int, cone_g: int,
                         tile_b: int = 256, check_every: int = 1,
                         exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_hmpc_solve`."""
    ops = _Ops(CT, MC, d_row, lb_row, ub_row, rho=rho, use_soc=use_soc,
               cone0=cone0, cone_g=cone_g)
    return run_modes(ops.iterate, z1, s0, lam0, tol_p=tol_p, tol_d=tol_d,
                     k_max=k_max, tile_b=tile_b, check_every=check_every,
                     exact_k=exact_k)


def check_cone_layout(width: int, cone0: int, cone_g: int):
    """Raise ValueError unless cone warps from column cone0 fill `width`
    with at most MAX_CONES_PER_WARP cones a warp."""
    if cone0 % WARP or (width - cone0) % WARP or width <= cone0 or cone0 < 0:
        raise ValueError(f"the cones take whole warps from a warp boundary; "
                         f"got cone0={cone0} in {width} columns")
    if not 1 <= cone_g <= MAX_CONES_PER_WARP:
        raise ValueError(f"a warp holds 1 to {MAX_CONES_PER_WARP} cones; "
                         f"got {cone_g}")


def shared_bytes(dim_p: int, ns_p: int, lanes: int,
                 wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_hmpc_smem in the source): the
    ring of MC's slabs, z, s and lam as [rows][lanes], w with its padding,
    the warps' row maxima, the masks, the window starts and the slots'
    lanes. The wide build's (fused_hmpc_wide_smem): the prepared z as
    [dim_p][8], w as [ns_p][8] and the warps' row maxima."""
    if wide:
        return 4 * stage.WIDE_LANES * (dim_p + ns_p + 2 * stage.WIDE_WARPS)
    slab = stage.build_of(BUILDS, max(dim_p, ns_p), lanes)[0]
    return stage.ring_bytes(dim_p, slab) + 4 * (
        dim_p * lanes + 2 * ns_p * lanes + ns_p * (lanes + DQ_PAD)
        + ns_p // WARP * 2 * lanes + 4 + 2 * lanes)


def check_width(dim_p: int, ns_p: int) -> None:
    """Raise ValueError unless some build of the kernel takes these padded
    widths (a plain check, no CUDA: the fused builders call it when they
    build for the card)."""
    check_widths("fused cone-ADMM kernel (K6, csrc/fused_hmpc.cu)",
                 WIDE_COLS, dim_p=dim_p, ns_p=ns_p)


def launch_plan(B: int, dim_p: int, ns_p: int, cone0: int, cone_g: int, *,
                tile_b: int, check_every: int, exact_k: bool,
                lanes: int | None = None, wide: bool | None = None):
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (and wide=True for the
    wide build). `lanes` names a build in place of the dispatch's choice,
    `wide` the wide build or not (by default: past MAX_COLS columns of
    either width); raises ValueError on a shape or mode no build takes."""
    check_width(dim_p, ns_p)
    check_cone_layout(ns_p, cone0, cone_g)
    stage.check_mode(B, tile_b=tile_b, check_every=check_every,
                     exact_k=exact_k)
    if stage.use_wide(max(dim_p, ns_p), wide):
        return stage.wide_plan(B, shared_bytes(dim_p, ns_p, 8, wide=True),
                               lanes)
    return stage.plan(B, max(dim_p, ns_p),
                      lambda L: shared_bytes(dim_p, ns_p, L), BUILDS,
                      refill=not (check_every > 1 and exact_k), lanes=lanes)


def launch_geometry(B: int, dim_p: int, ns_p: int, cone0: int, cone_g: int,
                    **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, dim_p, ns_p, cone0, cone_g, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(*args, rho, tol_p, tol_d, k_max, use_soc, cone0, cone_g, tile_b,
            check_every, exact_k, lanes=None, wide=None):
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, dim_p = args[0].shape
    ns_p = args[1].shape[1]
    plan = launch_plan(B, dim_p, ns_p, cone0, cone_g, tile_b=tile_b,
                       check_every=check_every, exact_k=exact_k, lanes=lanes,
                       wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    wide = plan.get("wide", False)
    launch = (load_kernel("fused_hmpc", "fused_hmpc_wide_launch",
                          FUSED_HMPC_WIDE_ARGTYPES) if wide else
              load_kernel("fused_hmpc", "fused_hmpc_launch",
                          FUSED_HMPC_ARGTYPES))
    dev = args[0].device
    z = torch.empty_like(args[0])
    s, lam = torch.empty_like(args[1]), torch.empty_like(args[1])
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    exact = check_every > 1 and exact_k
    snap = torch.empty((B if exact else 0, dim_p + 2 * ns_p),
                       dtype=torch.float32, device=dev)
    # the queue of groups of 8 lanes (refill), then each block's count of
    # iterations (refill) and kilo-clocks of the two halves of an iteration
    # (in a build with TP_CLOCKS; else zeros)
    # (the wide build: the blocks' state, the consumed z, s and lam)
    nb = plan["blocks"]
    queue = (torch.empty((B * (dim_p + 2 * ns_p),), dtype=torch.float32,
                         device=dev) if wide else
             torch.zeros((1 + 3 * nb,), dtype=torch.int32, device=dev))
    ptrs = [t.data_ptr() for t in args + (z, s, lam, k, done, rp, rd, snap,
                                          queue)]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build = ([] if wide else [plan["lanes"]]) + [plan["blocks"],
                                                 plan["threads"],
                                                 plan["smem"]]
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, dim_p, ns_p, int(cone0), int(cone_g),
            int(bool(use_soc)), *build, float(rho), float(1.0 / rho),
            float(tol_p), float(tol_d), int(k_max), int(check_every),
            int(bool(exact_k)), stream)
    if err != 0:
        raise RuntimeError(f"fused_hmpc kernel launch failed with CUDA error "
                           f"{err} ({plan})")
    fused_hmpc_solve.launches += 1
    fused_hmpc_solve.last_plan = plan if wide else dict(
        plan, block_iterations=queue[1:1 + nb],
        block_clocks=queue[1 + nb:].view(nb, 2))
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return z, s, lam, k, e_flag, rp, rd


def fused_hmpc_solve(z1, s0, lam0, CT, MC, d_row, lb_row, ub_row, *,
                     rho: float, tol_p: float, tol_d: float, k_max: int,
                     use_soc: bool, cone0: int, cone_g: int,
                     tile_b: int = 256, check_every: int = 1,
                     exact_k: bool = False, lanes: int | None = None,
                     wide: bool | None = None):
    """Run the fused single-split cone-ADMM loop on z [B, dim_p] and s, lam
    [B, ns_p] in the layout the module docstring sets out (B a multiple of
    tile_b): CT [dim_p, ns_p] and MC [ns_p, dim_p] in row form
    (czd = z @ CT, z += w @ MC), the rows d, lb, ub of ns_p entries. CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise.
    `lanes` names the build to launch (one of stage.LANES) in place of the
    dispatch's choice, `wide` the wide build or not (by default: past
    MAX_COLS columns of either width); the results depend on neither, and
    the plain version has no such builds.

    Returns (z [B, dim_p], s, lam [B, ns_p], k [B] int32, e_flag [B] int32
    (1 converged / -1 k_max reached), r_p [B], r_d [B]).
    """
    args = (z1, s0, lam0, CT, MC, d_row, lb_row, ub_row)
    B, dim_p = z1.shape
    ns_p = s0.shape[1]
    if s0.shape != lam0.shape or s0.shape[0] != B:
        raise ValueError(f"s0 and lam0 must share one shape [{B}, ns_p]; "
                         f"got {tuple(s0.shape)} and {tuple(lam0.shape)}")
    if (CT.shape != (dim_p, ns_p) or MC.shape != (ns_p, dim_p)
            or any(r.numel() != ns_p for r in (d_row, lb_row, ub_row))):
        raise ValueError(f"CT must be [{dim_p}, {ns_p}], MC [{ns_p}, "
                         f"{dim_p}] and the rows d, lb, ub hold {ns_p} "
                         f"entries")
    check_cone_layout(ns_p, cone0, cone_g)
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(rho=float(rho), tol_p=tol_p, tol_d=tol_d, k_max=k_max,
              use_soc=bool(use_soc), cone0=int(cone0), cone_g=int(cone_g),
              tile_b=tile_b, check_every=check_every, exact_k=exact_k)
    if z1.device.type == "cpu":
        return fused_hmpc_reference(*args, **kw)
    if z1.device.type == "cuda":
        return _launch(*args, lanes=lanes, wide=wide, **kw)
    raise ValueError(f"fused_hmpc_solve takes CPU or CUDA tensors; got "
                     f"{z1.device}")


fused_hmpc_solve.launches = 0
fused_hmpc_solve.last_plan = None
