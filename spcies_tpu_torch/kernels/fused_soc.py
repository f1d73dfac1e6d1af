"""Fused slack-SOC split ADMM for ellipMPC-ADMM-soc: the wrapper of the
hand-written CUDA kernel (csrc/fused_soc.cu) and its plain PyTorch version.

Counterpart of spcies_tpu/kernels/fused_soc.py (`_fused_soc_kernel`). One
row per lane holds [z (dim_p columns) | s (sp columns)], both slabs padded
to multiples of COL_PAD; aux = (z_hat, s_hat) is kept in delta form through
the single KKT map M1'. For each lane one iteration is

    w      = aux + iscale lm
    z      = clip(w[:dim_p], LB, UB)     (x_N and the slack: +-3e38)
    s      = SOC projection of w[dim_p:] = [s0 | tail]:
             nrm = sqrt(max(sum(seg^2) - s0^2, 0));
             inside (nrm <= s0): s = seg; apex (nrm <= -s0): s = 0;
             else s0 -> (s0 + nrm) / 2, tail -> tail (s0 + nrm) / (2 nrm)
    lm'    = lm + scale (aux - zs)
    dq     = (lm' - lm) - scale (zs - zs_old)
    aux   += dq @ M1'
    r_p    = max |aux - zs|, r_d = max |zs - zs_old|

with scale = sigma on the z slab and rho on the s slab, iscale their
inverses on the real columns and 0 on the pads. The squares of the cone's
n + 1 real entries are summed in column order, one after the other, in the
kernel and in the plain version alike (the JAX kernel uses a row sum). The
runtime radius enters only the prologue offset aux_b, never the loop. Modes,
as
kernels/fused_admm.py has them: checked (check_every=1), plain free-run
(check_every>1) and exact-k (window snapshots of (aux, zs, lm) and a
budgeted replay); there is no fixed_iters mode, as in the JAX kernel.

Padding contract: pad columns carry zero rows and columns in M1', [0, 0]
bounds on the z slab and iscale = 0, so they stay exactly 0. The batch is
padded to a multiple of tile_b by the caller. On the card the s slab is one
warp (sp = 32, n + 1 <= 32).

`fused_soc_solve` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; `fused_soc_solve.launches` counts the launches and
`fused_soc_solve.last_plan` holds the last launch's build and geometry.

The kernel runs on the product stage csrc/tile_product.cuh, built for 8, 16
and 32 lanes a block (kernels/stage.py); plain free-run and the checked mode
refill its persistent blocks group by group of 8 lanes. Every build gives
the same bits, so `lanes=` of `fused_soc_solve` may name another build, for
a check or a timing.

Past MAX_COLS columns, up to WIDE_COLS, the wide build
(fused_soc_wide_kernel, csrc/wide_cols.cuh) runs 512 threads of two
columns at 8 lanes a block, no refill, with its state in global memory;
`wide=` of `fused_soc_solve` names it at any width, for a check of bits.
"""

from __future__ import annotations

import ctypes

import torch

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, DQ_PAD, MAX_COLS,
                                                 WIDE_COLS, check_widths,
                                                 round_up)
from spcies_tpu_torch.kernels.modes import run_modes

__all__ = ["check_width", "COL_PAD", "MAX_COLS", "round_up",
           "fused_soc_reference", "fused_soc_solve", "launch_plan",
           "launch_geometry", "shared_bytes"]

# C signature of fused_soc_launch: 17 pointers (8 inputs, 7 outputs, the
# exact-k snapshot scratch, the refill queue); B, P, dim_p, lanes, blocks,
# threads, shared bytes; tol_p, tol_d; k_max, check_every, exact_k; the
# stream
FUSED_SOC_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
                      + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])
# and of fused_soc_wide_launch: 17 pointers (the refill queue's place holds
# the blocks' global state); B, P, dim_p, blocks, threads, shared bytes;
# tol_p, tol_d; k_max, check_every, exact_k; the stream
FUSED_SOC_WIDE_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                           + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
# the wide build's state leaves: aux, zs, lm and the consumed aux
WIDE_LEAVES = 4
# lanes a block -> (rows a slab of M1', blocks an SM) of its build up to
# stage.NARROW columns (Build<L> in csrc/fused_soc.cu)
BUILDS = {8: (16, 2), 16: (8, 2), 32: (32, 1)}
# the leaves an exact-k snapshot saves per lane: aux, zs, lm
SNAP_LEAVES = 3
WARP = 32


class _Ops:
    """One iteration in the kernel's operation order, over padded
    operators."""

    def __init__(self, M1P, lb, ub, scale, iscale, dim_p):
        self.M1P, self.dim_p = M1P, dim_p
        self.lb, self.ub, self.scale, self.iscale = (
            r.reshape(1, -1) for r in (lb, ub, scale, iscale))
        sp = M1P.shape[0] - dim_p
        self.e0 = torch.zeros((1, sp), dtype=M1P.dtype, device=M1P.device)
        self.e0[0, 0] = 1.0
        # the cone's real entries (iscale is 0 on the pads)
        self.n_s = int(torch.count_nonzero(self.iscale[0, dim_p:]))

    def iterate(self, aux, zs_old, lm):
        """One split iteration; returns (aux_next, zs_new, lm_new, r_p,
        r_d)."""
        dim_p, e0 = self.dim_p, self.e0
        w = aux + self.iscale * lm
        head = torch.minimum(torch.maximum(w[:, :dim_p], self.lb), self.ub)
        seg = w[:, dim_p:]
        s0 = seg[:, 0:1]
        # the squares summed in column order, as the kernel sums them
        sq = seg * seg
        ss = sq[:, 0:1]
        for i in range(1, self.n_s):
            ss = ss + sq[:, i:i + 1]
        nrm = torch.sqrt(torch.clamp(ss - s0 * s0, min=0.0))
        inside = (nrm <= s0).to(w.dtype)
        apex = (nrm <= -s0).to(w.dtype) * (1.0 - inside)
        proj = (1.0 - inside) * (1.0 - apex)
        safe = torch.clamp(nrm, min=1e-30)
        coef = 0.5 * (s0 + nrm)
        tail_scale = inside + proj * (coef / safe)
        s_new = (e0 * (inside * s0 + proj * coef)
                 + (1.0 - e0) * (seg * tail_scale))
        zs_new = torch.cat([head, s_new], dim=1)
        lm_new = lm + self.scale * (aux - zs_new)
        dp = aux - zs_new
        dd = zs_new - zs_old
        dq = (lm_new - lm) - self.scale * dd
        aux_next = aux + dq @ self.M1P
        return (aux_next, zs_new, lm_new, torch.amax(torch.abs(dp), dim=1),
                torch.amax(torch.abs(dd), dim=1))


def fused_soc_reference(aux1, zs0, lm0, M1P, LB_head, UB_head, scale_row,
                        iscale_row, *, dim_p: int, tol_p: float,
                        tol_d: float, k_max: int, tile_b: int = 256,
                        check_every: int = 1, exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_soc_solve`."""
    ops = _Ops(M1P, LB_head, UB_head, scale_row, iscale_row, dim_p)
    aux, zs, lm, *rest = run_modes(
        ops.iterate, aux1, zs0, lm0, tol_p=tol_p, tol_d=tol_d, k_max=k_max,
        tile_b=tile_b, check_every=check_every, exact_k=exact_k)
    return (zs, lm, aux, *rest)


def shared_bytes(P: int, lanes: int, wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_soc_smem in the source): the
    ring of M1''s slabs, aux, zs and lm as [P][lanes], dq with its padding,
    the warps' row maxima, the masks, the window starts, the slots' lanes
    and the lanes' cones. The wide build's (fused_soc_wide_smem): dq as
    [2][P][8] and the warps' row maxima."""
    if wide:
        return 4 * stage.WIDE_LANES * (2 * P + 4 * stage.WIDE_WARPS)
    slab = stage.build_of(BUILDS, P, lanes)[0]
    return stage.ring_bytes(P, slab) + 4 * (
        P * (4 * lanes + DQ_PAD) + P // WARP * 2 * lanes + 4 + 5 * lanes)


def check_width(P: int) -> None:
    """Raise ValueError unless some build of the kernel takes this padded
    width (a plain check, no CUDA: the fused builder calls it when it
    builds for the card)."""
    check_widths("fused slack-SOC kernel (K5, csrc/fused_soc.cu)",
                 WIDE_COLS, width=P)


def launch_plan(B: int, P: int, dim_p: int, *, tile_b: int,
                check_every: int, exact_k: bool, lanes: int | None = None,
                wide: bool | None = None):
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (and wide=True for the
    wide build). `lanes` names a build in place of the dispatch's choice,
    `wide` the wide build or not (by default: past MAX_COLS columns);
    raises ValueError on a shape or mode no build takes."""
    check_width(P)
    if dim_p % WARP or P - dim_p != WARP:
        raise ValueError(f"the kernel takes an s slab of one warp of {WARP} "
                         f"columns after a z slab of whole warps; got "
                         f"dim_p={dim_p}, P={P}")
    stage.check_mode(B, tile_b=tile_b, check_every=check_every,
                     exact_k=exact_k)
    if stage.use_wide(P, wide):
        return stage.wide_plan(B, shared_bytes(P, 8, wide=True), lanes)
    return stage.plan(B, P, lambda L: shared_bytes(P, L), BUILDS,
                      refill=not (check_every > 1 and exact_k), lanes=lanes)


def launch_geometry(B: int, P: int, dim_p: int, **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, P, dim_p, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(*args, dim_p, tol_p, tol_d, k_max, tile_b, check_every,
            exact_k, lanes=None, wide=None):
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, P = args[0].shape
    plan = launch_plan(B, P, dim_p, tile_b=tile_b, check_every=check_every,
                       exact_k=exact_k, lanes=lanes, wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    wide = plan.get("wide", False)
    launch = (load_kernel("fused_soc", "fused_soc_wide_launch",
                          FUSED_SOC_WIDE_ARGTYPES) if wide else
              load_kernel("fused_soc", "fused_soc_launch",
                          FUSED_SOC_ARGTYPES))
    dev = args[0].device
    zs, lm, aux = (torch.empty_like(args[0]) for _ in range(3))
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    exact = check_every > 1 and exact_k
    snap = torch.empty((B if exact else 0, SNAP_LEAVES * P),
                       dtype=torch.float32, device=dev)
    # the queue of groups of 8 lanes (refill), then each block's count of
    # iterations (refill) and kilo-clocks of the two halves of an iteration
    # (in a build with TP_CLOCKS; else zeros)
    # (the wide build: the blocks' state)
    nb = plan["blocks"]
    queue = (torch.empty((B * WIDE_LEAVES * P,), dtype=torch.float32,
                         device=dev) if wide else
             torch.zeros((1 + 3 * nb,), dtype=torch.int32, device=dev))
    ptrs = [t.data_ptr() for t in args + (zs, lm, aux, k, done, rp, rd, snap,
                                          queue)]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build = ([] if wide else [plan["lanes"]]) + [plan["blocks"],
                                                 plan["threads"],
                                                 plan["smem"]]
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, P, int(dim_p), *build, float(tol_p), float(tol_d),
            int(k_max), int(check_every), int(bool(exact_k)), stream)
    if err != 0:
        raise RuntimeError(f"fused_soc kernel launch failed with CUDA error "
                           f"{err} ({plan})")
    fused_soc_solve.launches += 1
    fused_soc_solve.last_plan = plan if wide else dict(
        plan, block_iterations=queue[1:1 + nb],
        block_clocks=queue[1 + nb:].view(nb, 2))
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return zs, lm, aux, k, e_flag, rp, rd


def fused_soc_solve(aux1, zs0, lm0, M1P, LB_head, UB_head, scale_row,
                    iscale_row, *, dim_p: int, tol_p: float, tol_d: float,
                    k_max: int, tile_b: int = 256, check_every: int = 1,
                    exact_k: bool = False, lanes: int | None = None,
                    wide: bool | None = None):
    """Run the fused slack-SOC split ADMM loop on [B, P] tensors in the
    layout [z (dim_p) | s (P - dim_p)] (padded as the module docstring
    says; B a multiple of tile_b): M1P [P, P] in row form
    (aux += dq @ M1P), the z-slab bounds of dim_p entries, the scale and
    iscale rows of P entries. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise. `lanes` names the build to launch
    (one of stage.LANES) in place of the dispatch's choice, `wide` the wide
    build or not (by default: past MAX_COLS columns); the results depend on
    neither, and the plain version has no such builds.

    Returns (zs, lm, aux [B, P], k [B] int32, e_flag [B] int32 (1
    converged / -1 k_max reached), r_p [B], r_d [B]).
    """
    args = (aux1, zs0, lm0, M1P, LB_head, UB_head, scale_row, iscale_row)
    B, P = aux1.shape
    for t in (zs0, lm0):
        if t.shape != (B, P):
            raise ValueError(f"aux1, zs0 and lm0 must share one shape; got "
                             f"{tuple(aux1.shape)} and {tuple(t.shape)}")
    if not 0 < dim_p < P:
        raise ValueError(f"dim_p={dim_p} must split {P} columns")
    if (M1P.shape != (P, P) or LB_head.numel() != dim_p
            or UB_head.numel() != dim_p or scale_row.numel() != P
            or iscale_row.numel() != P):
        raise ValueError(f"M1P must be [{P}, {P}], the bounds hold {dim_p} "
                         f"entries and the scale rows {P}")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(dim_p=int(dim_p), tol_p=tol_p, tol_d=tol_d, k_max=k_max,
              tile_b=tile_b, check_every=check_every, exact_k=exact_k)
    if aux1.device.type == "cpu":
        return fused_soc_reference(*args, **kw)
    if aux1.device.type == "cuda":
        return _launch(*args, lanes=lanes, wide=wide, **kw)
    raise ValueError(f"fused_soc_solve takes CPU or CUDA tensors; got "
                     f"{aux1.device}")


fused_soc_solve.launches = 0
fused_soc_solve.last_plan = None
