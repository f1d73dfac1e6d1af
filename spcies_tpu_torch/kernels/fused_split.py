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
launches.

The kernel runs 8 lanes a thread block, one column a thread, three blocks an
SM. A build on the product stage K1 runs on (csrc/tile_product.cuh: 8, 16 or
32 lanes a block, M1' staged through shared memory, register tiles) gives the
same bits on every lane and is 3-17 % slower at the HMPC families' batches on
an H100 (PERF.md): it is kept as csrc/variants/fused_split_tile.cu, which
tools/ab_kernels.py builds and times and nothing here launches.

Past MAX_COLS columns, up to WIDE_COLS, the wide build
(fused_split_wide_kernel, csrc/wide_cols.cuh) runs 512 threads of two
columns, t and t + 512, at 8 lanes a block, with its state in global
memory; `wide=` of `fused_split_solve` names it at any width, for a check
of bits. The cones keep their warps: a warp of cones, 32 columns from
cone0 on, lies in one half, [0, 512) or [512, P), of a thread's columns,
since both halves start on a warp.
"""

from __future__ import annotations

import ctypes

import torch

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, MAX_COLS,
                                                 WIDE_COLS, check_widths)
from spcies_tpu_torch.kernels.fused_hmpc import (WARP, check_cone_layout,
                                                 cone_columns, cone_project)
from spcies_tpu_torch.kernels.modes import run_modes

__all__ = ["check_width", "fused_split_reference", "fused_split_solve",
           "launch_geometry", "launch_plan", "shared_bytes"]

# lanes per thread block (TB in csrc/fused_split.cu)
CTA_LANES = 8

# C signature of fused_split_launch: 16 tensor pointers (8 inputs, 7
# outputs, the exact-k snapshot scratch); B, P, dim_p, cone0, cone_g,
# symmetric, use_soc, blocks, threads, shared bytes; alpha, tol_p, tol_d;
# k_max, check_every, exact_k; the stream
FUSED_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
                        + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
# and of fused_split_wide_launch: 17 pointers (the blocks' global state
# after the snapshot scratch); the ints, floats and ints of
# fused_split_launch; the stream
FUSED_SPLIT_WIDE_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
                             + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
# the leaves an exact-k snapshot saves per lane: aux, zs, lm
SNAP_LEAVES = 3
# the wide build's state leaves: aux, zs, lm and the consumed aux
WIDE_LEAVES = 4


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


def shared_bytes(P: int, wide: bool = False) -> int:
    """Dynamic shared bytes of a block: dq [2][P][8], the warp maxima
    [2][warps][2][8] and, one column a thread, the four state vectors
    [P][8] (fused_split_wide_smem in the source for the wide build, whose
    state lives in global memory)."""
    if wide:
        return 4 * CTA_LANES * (2 * P + 4 * stage.WIDE_WARPS)
    return 4 * CTA_LANES * (6 * P + 4 * (P // WARP))


def launch_plan(B: int, P: int, dim_p: int, cone0: int, cone_g: int, *,
                tile_b: int, check_every: int, exact_k: bool,
                wide: bool | None = None) -> dict:
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (always False; and
    wide=True for the wide build). `wide` names the wide build or not (by
    default: past MAX_COLS columns); raises ValueError on a shape or mode
    no build takes."""
    check_width(P)
    if dim_p % WARP or not 0 < dim_p <= cone0:
        raise ValueError(f"the kernel takes a z slab of whole warps before "
                         f"the cones; got dim_p={dim_p}, cone0={cone0}")
    check_cone_layout(P, cone0, cone_g)
    if tile_b % CTA_LANES:
        raise ValueError(f"tile_b must be a multiple of {CTA_LANES}; "
                         f"got {tile_b}")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    if check_every > 1 and not exact_k and tile_b != CTA_LANES:
        # in plain free-run the output iterates depend on when a lane's
        # tile drains, and the kernel drains per block of CTA_LANES lanes
        raise ValueError(
            f"plain free-run (check_every > 1 without exact_k) takes "
            f"tile_b={CTA_LANES} on the GPU; got {tile_b}")
    if stage.use_wide(P, wide):
        return stage.wide_plan(B, shared_bytes(P, wide=True))
    return dict(lanes=CTA_LANES, blocks=B // CTA_LANES, threads=P,
                smem=shared_bytes(P), refill=False)


def launch_geometry(B: int, P: int, dim_p: int, cone0: int, cone_g: int,
                    **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, P, dim_p, cone0, cone_g, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(*args, alpha, symmetric, use_soc, dim_p, cone0, cone_g, tol_p,
            tol_d, k_max, tile_b, check_every, exact_k, wide=None):
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, P = args[0].shape
    plan = launch_plan(B, P, dim_p, cone0, cone_g, tile_b=tile_b,
                       check_every=check_every, exact_k=exact_k, wide=wide)
    blocks, threads, smem = plan["blocks"], plan["threads"], plan["smem"]
    wide = plan.get("wide", False)
    from spcies_tpu_torch.kernels._build import load_kernel
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
    state = (torch.empty((B * WIDE_LEAVES * P,), dtype=torch.float32,
                         device=dev),) if wide else ()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = launch(
            *(t.data_ptr() for t in args + (zs, lm, aux, k, done, rp, rd,
                                            snap) + state),
            B, P, int(dim_p), int(cone0), int(cone_g), int(bool(symmetric)),
            int(bool(use_soc)), blocks, threads, smem, float(alpha),
            float(tol_p), float(tol_d), int(k_max), int(check_every),
            int(bool(exact_k)), stream)
    if err != 0:
        raise RuntimeError(f"fused_split kernel launch failed with CUDA "
                           f"error {err} (blocks={blocks}, threads="
                           f"{threads}, shared={smem} B)")
    fused_split_solve.launches += 1
    fused_split_solve.last_plan = plan
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return zs, lm, aux, k, e_flag, rp, rd


def fused_split_solve(aux1, zs0, lm0, M1P, lb_row, ub_row, scale_row,
                      iscale_row, *, alpha: float, symmetric: bool,
                      use_soc: bool, dim_p: int, cone0: int, cone_g: int,
                      tol_p: float, tol_d: float, k_max: int,
                      tile_b: int = 256, check_every: int = 1,
                      exact_k: bool = False, wide: bool | None = None):
    """Run the fused split (S)ADMM loop on [B, P] tensors in the layout the
    module docstring sets out (B a multiple of tile_b): M1P [P, P] in row
    form (aux += dq @ M1P), the rows lb, ub, scale and iscale of P entries
    (lb/ub: clip bounds, or a cone's D-set bounds on its three lanes).
    alpha scales the dual steps; symmetric adds SADMM's half-step. CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise.
    `wide` names the wide build or not (by default: past MAX_COLS columns);
    the results do not depend on it, and the plain version takes none.

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
        return _launch(*args, wide=wide, **kw)
    raise ValueError(f"fused_split_solve takes CPU or CUDA tensors; got "
                     f"{aux1.device}")


fused_split_solve.launches = 0
fused_split_solve.last_plan = None
