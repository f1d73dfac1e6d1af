"""Fused two-block split (S)ADMM for HMPC-ADMM-split and HMPC-SADMM-split:
the wrapper of the hand-written CUDA kernel (csrc/fused_split.cu) and its
plain PyTorch version.

Counterpart of spcies_tpu/kernels/fused_split.py (`_fused_split_kernel`;
code_HMPC_ADMM_split_C.c:176-305). One row per lane holds [z (dim_p
columns) | s], aux = (z_hat, s_hat) is kept in delta form through the
single KKT map M1', and one iteration is

    lm_h   = lm + alpha scale (aux - zs_old)     (SADMM only: the half-step
                                                  with the previous (z, s),
                                                  code_HMPC_ADMM_split_C.c:
                                                  215-225)
    w      = aux + iscale lm_h
    zs     = clip(w, lb, ub) on every column but the cones' (the harmonic
             references free at +-3e38); on each cone's (y0, y1, y2): SOC
             or diamond, as kernels/fused_hmpc.py projects them
    lm'    = lm_h + alpha scale (aux - zs)
    dq     = (lm' - lm) - scale (zs - zs_old)
    aux   += dq @ M1'
    r_p    = max |aux - zs|, r_d = max |zs - zs_old|

with scale = sigma on the z slab and rho on the s slab, iscale their
inverses on the real columns and 0 on the pads, alpha = 1 for ADMM. The s
slab starts at column dim_p with its box rows (output mode), then from
column cone0 = dim_p + round_up(n_box, 32) the cone warps of
kernels/fused_hmpc.py `cone_columns`. Pad columns carry zero rows and
columns in M1', [0, 0] bounds and iscale = 0, so they stay exactly 0.

Modes: checked, plain free-run and exact-k (window snapshots of (aux, zs,
lm) and a budgeted replay), as kernels/fused_soc.py has them; there is no
fixed_iters mode, as in the JAX kernel.

`fused_split_solve` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; `fused_split_solve.launches` counts the
launches and `fused_split_solve.last_plan` holds the last launch's build and
geometry.

The kernel runs on the product stage csrc/tile_product.cuh, built for 8, 16
and 32 lanes a block (kernels/stage.py), with refill in every mode: its
persistent blocks take groups of 8 lanes from a queue, and in exact-k each
block then replays the groups it ran (the stage's run_refill_exact), in
the same launch. Every build gives the same bits, so `lanes=` of
`fused_split_solve` may name another build, for a check or a timing. The
one-column-per-thread kernel it replaced is csrc/variants/fused_split_parent.cu,
which tools/ab_kernels.py builds and times and nothing here launches.

Past MAX_COLS columns, up to WIDE_COLS, the wide build
(fused_split_wide_kernel) runs the same engine on 512 threads of two
columns, t and t + 512, at 16 lanes a block (its state in shared memory
with 16-row slabs of M1' up to 544 columns; past that zs and lm in a
per-block global scratch, 8-row slabs) or 8 (8-row slabs, its state in
shared memory up to 1024), with the spread cones and refill in every mode
(kernels/stage.py WIDE_BUILDS, `wide_layout`); `wide=` of
`fused_split_solve` names it at any width, for a check of bits.
"""

from __future__ import annotations

import ctypes

import torch

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, DQ_PAD, MAX_COLS,
                                                 WIDE_COLS, check_widths)
from spcies_tpu_torch.kernels.fused_hmpc import (WARP, check_cone_layout,
                                                 cone_columns, cone_project)
from spcies_tpu_torch.kernels.modes import run_modes

__all__ = ["check_width", "fused_split_reference", "fused_split_solve",
           "launch_geometry", "launch_plan", "shared_bytes"]

# C signature of fused_split_launch: 18 pointers (8 inputs, 7 outputs, the
# exact-k snapshot scratch, the refill queue, the window starts and links);
# B, P, dim_p, cone0, cone_g, symmetric, use_soc, lanes, refill, blocks,
# threads, shared bytes; alpha, tol_p, tol_d; k_max, check_every, exact_k;
# the stream
FUSED_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 12
                        + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
# and of fused_split_wide_launch: those, the global leaves' scratch after
# the links
FUSED_SPLIT_WIDE_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 12
                             + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
# lanes a block -> (rows a slab of M1', blocks an SM) of its build up to
# stage.NARROW columns (Build<L> in csrc/fused_split.cu)
BUILDS = {8: (16, 2), 16: (8, 2), 32: (16, 1)}
# the leaves an exact-k snapshot saves per lane: aux, zs, lm
SNAP_LEAVES = 3


class _Ops:
    """One iteration in the kernel's operation order, over padded
    operators."""

    def __init__(self, M1P, lb, ub, scale, iscale, *, alpha, symmetric,
                 use_soc, cone0, cone_g):
        self.M1P = M1P
        self.lb, self.ub, self.scale, self.iscale = (
            r.reshape(1, -1) for r in (lb, ub, scale, iscale))
        self.ascale = float(alpha) * self.scale
        self.symmetric, self.use_soc = bool(symmetric), bool(use_soc)
        self.cols = torch.as_tensor(
            cone_columns((M1P.shape[0] - cone0) // WARP, cone_g, cone0),
            device=M1P.device)

    def iterate(self, aux, zs_old, lm):
        """One split iteration; returns (aux_next, zs_new, lm_new, r_p,
        r_d)."""
        lm_at = lm
        if self.symmetric:
            lm = lm + self.ascale * (aux - zs_old)
        w = aux + self.iscale * lm
        zs_new = cone_project(w, self.lb, self.ub, self.cols, self.use_soc)
        lm_new = lm + self.ascale * (aux - zs_new)
        dp = aux - zs_new
        dd = zs_new - zs_old
        dq = (lm_new - lm_at) - self.scale * dd
        aux_next = aux + dq @ self.M1P
        return (aux_next, zs_new, lm_new, torch.amax(torch.abs(dp), dim=1),
                torch.amax(torch.abs(dd), dim=1))


def fused_split_reference(aux1, zs0, lm0, M1P, lb_row, ub_row, scale_row,
                          iscale_row, *, alpha: float, symmetric: bool,
                          use_soc: bool, dim_p: int, cone0: int, cone_g: int,
                          tol_p: float, tol_d: float, k_max: int,
                          tile_b: int = 256, check_every: int = 1,
                          exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_split_solve`."""
    ops = _Ops(M1P, lb_row, ub_row, scale_row, iscale_row, alpha=alpha,
               symmetric=symmetric, use_soc=use_soc, cone0=cone0,
               cone_g=cone_g)
    aux, zs, lm, *rest = run_modes(
        ops.iterate, aux1, zs0, lm0, tol_p=tol_p, tol_d=tol_d, k_max=k_max,
        tile_b=tile_b, check_every=check_every, exact_k=exact_k)
    return (zs, lm, aux, *rest)


def check_width(P: int) -> None:
    """Raise ValueError unless the kernel takes this padded width (a plain
    check, no CUDA: the fused builders call it when they build for the
    card)."""
    check_widths("fused split ADMM kernel (K7, csrc/fused_split.cu)",
                 WIDE_COLS, width=P)


def _bytes(P, lanes, slab, leaves, warps):
    """The ring of M1''s slabs, `leaves` leaves as [P][lanes], dq with its
    padding, the warps' row maxima, the masks, the window starts and the
    slots' lanes."""
    return stage.ring_bytes(P, slab) + 4 * (
        leaves * P * lanes + P * (lanes + DQ_PAD) + warps * 2 * lanes + 4
        + 2 * lanes)


def wide_layout(P: int, lanes: int) -> tuple[int, bool]:
    """(rows a slab, global leaves) of the wide build (stage.wide_layout)."""
    return stage.wide_layout(lanes, lambda slab, leaves: _bytes(
        P, lanes, slab, leaves, stage.WIDE_WARPS))


def shared_bytes(P: int, lanes: int = 8, wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_split_smem in the source; the
    wide build's fused_split_wide_smem): aux, zs and lm in shared memory,
    P / 32 warps' row maxima; the wide build's WIDE_WARPS, and aux alone
    where zs and lm go to global scratch."""
    if not wide:
        return _bytes(P, lanes, stage.build_of(BUILDS, P, lanes)[0], 3,
                      P // WARP)
    slab, global_leaves = wide_layout(P, lanes)
    return _bytes(P, lanes, slab, 1 if global_leaves else 3,
                  stage.WIDE_WARPS)


def launch_plan(B: int, P: int, dim_p: int, cone0: int, cone_g: int, *,
                tile_b: int, check_every: int, exact_k: bool,
                lanes: int | None = None, wide: bool | None = None) -> dict:
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (and wide=True for the
    wide build). `lanes` names a build in place of the dispatch's choice,
    `wide` the wide build or not (by default: past MAX_COLS columns);
    raises ValueError on a shape or mode no build takes."""
    check_width(P)
    if dim_p % WARP or not 0 < dim_p <= cone0:
        raise ValueError(f"the kernel takes a z slab of whole warps before "
                         f"the cones; got dim_p={dim_p}, cone0={cone0}")
    check_cone_layout(P, cone0, cone_g)
    stage.check_mode(B, tile_b=tile_b, check_every=check_every,
                     exact_k=exact_k)
    if stage.use_wide(P, wide):
        return stage.plan(B, P, lambda L: shared_bytes(P, L, True),
                          stage.WIDE_BUILDS, refill=True, lanes=lanes,
                          layout=lambda L: wide_layout(P, L))
    return stage.plan(B, P, lambda L: shared_bytes(P, L), BUILDS,
                      refill=True, lanes=lanes)


def launch_geometry(B: int, P: int, dim_p: int, cone0: int, cone_g: int,
                    **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, P, dim_p, cone0, cone_g, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(*args, alpha, symmetric, use_soc, dim_p, cone0, cone_g, tol_p,
            tol_d, k_max, tile_b, check_every, exact_k, lanes=None,
            wide=None):
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, P = args[0].shape
    plan = launch_plan(B, P, dim_p, cone0, cone_g, tile_b=tile_b,
                       check_every=check_every, exact_k=exact_k, lanes=lanes,
                       wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    wide = plan.get("wide", False)
    launch = (load_kernel("fused_split", "fused_split_wide_launch",
                          FUSED_SPLIT_WIDE_ARGTYPES) if wide else
              load_kernel("fused_split", "fused_split_launch",
                          FUSED_SPLIT_ARGTYPES))
    dev = args[0].device
    zs, lm, aux = (torch.empty_like(args[0]) for _ in range(3))
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    exact = check_every > 1 and exact_k
    snap = torch.empty((B if exact else 0, SNAP_LEAVES * P),
                       dtype=torch.float32, device=dev)
    nb = plan["blocks"]
    # the queue of groups of 8 lanes (refill), then each block's count of
    # iterations (refill) and kilo-clocks of the two halves of an iteration
    # (in a build with TP_CLOCKS; else zeros); in exact-k with refill each
    # lane's window start and each group's link
    queue = torch.zeros((1 + 3 * nb,), dtype=torch.int32, device=dev)
    wk = torch.empty((B + B // 8 if exact and plan["refill"] else 0,),
                     dtype=torch.int32, device=dev)
    scratch = (queue, wk)
    if wide:
        # the wide build's global leaves: zs and lm of each block's lanes
        scratch += (torch.empty((nb * 2 * P * plan["lanes"]
                                 if plan["global_leaves"] else 0,),
                                dtype=torch.float32, device=dev),)
    ptrs = [t.data_ptr() for t in args + (zs, lm, aux, k, done, rp, rd,
                                          snap) + scratch]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, P, int(dim_p), int(cone0), int(cone_g),
            int(bool(symmetric)), int(bool(use_soc)), plan["lanes"],
            int(plan["refill"]), nb,
            plan["threads"], plan["smem"], float(alpha), float(tol_p),
            float(tol_d), int(k_max), int(check_every), int(bool(exact_k)),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_split kernel launch failed with CUDA "
                           f"error {err} ({plan})")
    fused_split_solve.launches += 1
    fused_split_solve.last_plan = dict(
        plan, block_iterations=queue[1:1 + nb],
        block_clocks=queue[1 + nb:].view(nb, 2))
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return zs, lm, aux, k, e_flag, rp, rd


def fused_split_solve(aux1, zs0, lm0, M1P, lb_row, ub_row, scale_row,
                      iscale_row, *, alpha: float, symmetric: bool,
                      use_soc: bool, dim_p: int, cone0: int, cone_g: int,
                      tol_p: float, tol_d: float, k_max: int,
                      tile_b: int = 256, check_every: int = 1,
                      exact_k: bool = False, lanes: int | None = None,
                      wide: bool | None = None):
    """Run the fused split (S)ADMM loop on [B, P] tensors in the layout the
    module docstring sets out (B a multiple of tile_b): M1P [P, P] in row
    form (aux += dq @ M1P), the rows lb, ub, scale and iscale of P entries
    (lb/ub: clip bounds, or a cone's D-set bounds on its three lanes).
    alpha scales the dual steps; symmetric adds SADMM's half-step. CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise.
    `lanes` names the build to launch (one of stage.LANES) in place of the
    dispatch's choice, `wide` the wide build or not (by default: past
    MAX_COLS columns); the results depend on neither, and the plain version
    has no such builds.

    Returns (zs, lm, aux [B, P], k [B] int32, e_flag [B] int32 (1
    converged / -1 k_max reached), r_p [B], r_d [B]).
    """
    args = (aux1, zs0, lm0, M1P, lb_row, ub_row, scale_row, iscale_row)
    B, P = aux1.shape
    for t in (zs0, lm0):
        if t.shape != (B, P):
            raise ValueError(f"aux1, zs0 and lm0 must share one shape; got "
                             f"{tuple(aux1.shape)} and {tuple(t.shape)}")
    if M1P.shape != (P, P) or any(r.numel() != P for r in args[4:]):
        raise ValueError(f"M1P must be [{P}, {P}] and the rows lb, ub, "
                         f"scale, iscale hold {P} entries")
    if not 0 < dim_p <= cone0:
        raise ValueError(f"dim_p={dim_p} must end before the cones at "
                         f"column {cone0}")
    check_cone_layout(P, cone0, cone_g)
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(alpha=float(alpha), symmetric=bool(symmetric),
              use_soc=bool(use_soc), dim_p=int(dim_p), cone0=int(cone0),
              cone_g=int(cone_g), tol_p=tol_p, tol_d=tol_d, k_max=k_max,
              tile_b=tile_b, check_every=check_every, exact_k=exact_k)
    if aux1.device.type == "cpu":
        return fused_split_reference(*args, **kw)
    if aux1.device.type == "cuda":
        return _launch(*args, lanes=lanes, wide=wide, **kw)
    raise ValueError(f"fused_split_solve takes CPU or CUDA tensors; got "
                     f"{aux1.device}")


fused_split_solve.launches = 0
fused_split_solve.last_plan = None
