"""Fused ellipMPC-ADMM in P_half coordinates: the wrapper of the
hand-written CUDA kernel (csrc/fused_ellip.cu) and its plain PyTorch
version.

Counterpart of spcies_tpu/kernels/fused_ellip.py (`_fused_ellip_kernel`).
With S = blkdiag(I, P_half) the iterates are z' = S z and v' = S v (the
dual lam is already the transformed one), so the P-norm ellipsoid
projection on the terminal state is a Euclidean ball of radius r about
c' = P_half c, and for each lane the loop runs

    y      = z' + rho_i lam
    v'     = clip(y, LB, UB) on the stage columns,
             c' + min(1, r / max(||y - c'||, 1e-30)) (y - c') on the slab
    lam   += rho (z' - v')
    dq     = rho (z' - 2 v' + v'_prev)           (delta form; dq -> 0)
    z'    += dq @ M2                             (M2 = S M_q S, full fp32)

where the slab is the n terminal columns t0 .. t0+n-1. The residuals are
those of the original coordinates: at a checked iteration the slab columns
of z' - v' and v' - v'_prev are mapped back through P_half^-1 (the n x n
`pinvh` = P_half^-T, applied as d_slab @ pinvh) before the row maxima.
The ball's squares and the terms of that map are added in slab order, one
column after the other, in the kernel and in the plain version alike (the
JAX kernel uses a row sum and a product; the order moves the last bit of
the norm, and where the ball binds that moves a lane's exit).
Modes, as kernels/fused_admm.py has them:

  checked     check_every=1: exit tests every iteration; a converged lane
              freezes and keeps the z' it consumed at exit.
  free-run    check_every=C>1: C-1 plain iterations, then one checked
              iteration; k at check granularity, converged lanes keep
              iterating until their tile drains; the output z' is the
              prepared iterate.
  exact-k     check_every=C>1, exact_k: free-run windows with a snapshot
              of (z', v', lam) of each active lane at each window start,
              then a per-iteration replay of each lane's last window
              (budget min(C, k_max - kws)) — the checked mode's k, e_flag
              and exit iterates at free-run speed.
  fixed_iters exactly fixed_iters plain iterations, k = fixed_iters,
              e_flag = 1, residuals 3.4e38.

Padding contract: the columns outside [0, ns) and the slab carry zero rows
and columns in M2, [0, 0] bounds and c' = 0, so they stay exactly 0 and add
nothing to a residual. The batch is padded to a multiple of tile_b by the
caller. On the card the slab must lie inside one warp of 32 columns
(t0 % 32 + n <= 32): the adapter lays it out so, and the kernel takes the
ball and the residual map in that warp, one lane a thread.

`fused_ellip_solve` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; `fused_ellip_solve.launches` counts the launches
and `fused_ellip_solve.last_plan` holds the last launch's build and
geometry.

The kernel runs on the product stage csrc/tile_product.cuh, built for 8, 16
and 32 lanes a block (kernels/stage.py); plain free-run and the checked mode
refill its persistent blocks group by group of 8 lanes, exact-k and
fixed_iters keep a block of L lanes. Every build gives the same bits, so
`lanes=` of `fused_ellip_solve` may name another build, for a check or a
timing.

Past MAX_COLS columns, up to WIDE_COLS, the wide build
(fused_ellip_wide_kernel) runs the same engine on 512 threads of two
columns, t and t + 512, at 16 lanes a block (its state in shared memory
with 16-row slabs of M2 up to 544 columns; past that v and lam in a
per-block global scratch, 8-row slabs) or 8 (8-row slabs, its state in
shared memory up to 1024), with refill in the checked mode, plain free-run
and exact-k, fixed_iters in static blocks (kernels/stage.py WIDE_BUILDS,
`wide_layout`); the warp that takes the ball and the residual map is the
one that holds the slab, in the first half of a thread's columns or the
second. `wide=` of `fused_ellip_solve` names it at any width, for a check
of bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, DQ_PAD, MAX_COLS,
                                                 RBIG, WIDE_COLS, check_widths,
                                                 round_up)

__all__ = ["check_width", "COL_PAD", "MAX_COLS", "round_up",
           "fused_ellip_reference", "fused_ellip_solve", "launch_geometry",
           "launch_plan", "shared_bytes", "slab_start"]

# C signature of fused_ellip_launch: 17 tensor pointers (8 inputs, 7
# outputs, the exact-k snapshot scratch, the refill queue); B, nzp, t0, n,
# lanes, blocks, threads, shared bytes; rho, 1/rho, r; tol_p, tol_d; k_max,
# check_every, fixed_iters, exact_k; the stream
FUSED_ELLIP_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                        + [ctypes.c_float] * 5 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
# lanes a block -> (rows a slab of M2, blocks an SM) of its build up to
# stage.NARROW columns (Build<L> in csrc/fused_ellip.cu)
BUILDS = {8: (16, 2), 16: (16, 2), 32: (32, 1)}
# the leaves an exact-k snapshot saves per lane: z', v', lam
SNAP_LEAVES = 3
# C signature of fused_ellip_wide_launch: 19 pointers (those of
# fused_ellip_launch, then exact-k's window starts and links, the global
# leaves' scratch); B, nzp, t0, n, lanes, refill, blocks, threads, shared
# bytes; rho, 1/rho, r, tol_p, tol_d; k_max, check_every, fixed_iters,
# exact_k; the stream
FUSED_ELLIP_WIDE_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
                             + [ctypes.c_float] * 5 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p])
WARP = 32
# plain version: read "all lanes done" on the host every this many
# iterations of the checked loop (extra iterations of frozen lanes are
# exact no-ops)
_SYNC_EVERY = 8


def slab_start(ns: int, n: int) -> int:
    """Where the n terminal columns start in the kernel's layout: right
    after the ns stage columns when they fit in that warp, else at the next
    warp boundary (the columns between are zero pads)."""
    return ns if ns % WARP + n <= WARP else round_up(ns, WARP)


class _Ops:
    """One iteration in the kernel's operation order, over padded
    operators."""

    def __init__(self, M2, pinvh, lb, ub, c, t0, rho, r_ball):
        nzp, n = M2.shape[0], pinvh.shape[0]
        self.M2, self.pinvh = M2, pinvh
        self.lb, self.ub, self.c = (r.reshape(1, -1) for r in (lb, ub, c))
        self.segt = torch.zeros((1, nzp), dtype=M2.dtype, device=M2.device)
        self.segt[0, t0:t0 + n] = 1.0
        self.segs = 1.0 - self.segt
        self.t0, self.t1, self.nzp = t0, t0 + n, nzp
        self.rho, self.rho_i, self.r_ball = (float(rho), float(1.0 / rho),
                                             float(r_ball))

    def prox(self, y):
        """Box on the stage columns, the ball about c' on the slab. The
        squares are summed in slab order, one column after the other, as
        the kernel sums them."""
        vbox = torch.minimum(torch.maximum(y, self.lb), self.ub)
        yc = y - self.c
        sq = yc[:, self.t0:self.t1] * yc[:, self.t0:self.t1]
        quad = sq[:, 0:1]
        for i in range(1, sq.shape[1]):
            quad = quad + sq[:, i:i + 1]
        nrm = torch.sqrt(quad)
        scale = torch.clamp(self.r_ball / torch.clamp(nrm, min=1e-30),
                            max=1.0)
        return self.segs * vbox + self.segt * (self.c + scale * yc)

    def orig(self, d):
        """The slab columns of a difference mapped back through P_half^-1:
        d_slab @ pinvh, its terms added in slab order as the kernel adds
        them."""
        ds = d[:, self.t0:self.t1]
        back = ds[:, 0:1] * self.pinvh[0]
        for i in range(1, ds.shape[1]):
            back = back + ds[:, i:i + 1] * self.pinvh[i]
        return d * self.segs + F.pad(back, (self.t0, self.nzp - self.t1))

    def iterate(self, zc, v_prev, lam, check=True):
        """One iteration. Returns (v_new, lam_new, z_next, r_p, r_d); the
        residuals are None without `check`."""
        v_new = self.prox(zc + self.rho_i * lam)
        lam_new = lam + self.rho * (zc - v_new)
        dq = self.rho * (zc - 2.0 * v_new + v_prev)
        z_next = zc + dq @ self.M2
        if not check:
            return v_new, lam_new, z_next, None, None
        r_p = torch.amax(torch.abs(self.orig(zc - v_new)), dim=1)
        r_d = torch.amax(torch.abs(self.orig(v_new - v_prev)), dim=1)
        return v_new, lam_new, z_next, r_p, r_d


def _sel(mask, new, old):
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def fused_ellip_reference(z1, v0, lam0, M2_pad, pinvh, LB_pad, UB_pad,
                          c_pad, *, t0: int, rho: float, r_ball: float,
                          tol_p: float, tol_d: float, k_max: int,
                          tile_b: int = 256, check_every: int = 1,
                          fixed_iters: int = 0, exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_ellip_solve`."""
    B = z1.shape[0]
    dt, dev = z1.dtype, z1.device
    ops = _Ops(M2_pad, pinvh, LB_pad, UB_pad, c_pad, t0, rho, r_ball)
    C = int(check_every)

    def conv_of(r_p, r_d):
        return torch.logical_and(r_p <= tol_p, r_d <= tol_d)

    rbig = torch.full((B,), RBIG, dtype=dt, device=dev)
    zn, v, lam = z1, v0, lam0
    if fixed_iters:
        for _ in range(int(fixed_iters)):
            v, lam, zn, _rp, _rd = ops.iterate(zn, v, lam, check=False)
        k = torch.full((B,), int(fixed_iters), dtype=torch.int32,
                       device=dev)
        return (zn, v, lam, k, torch.ones_like(k), rbig, rbig.clone())

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp, rd = rbig, rbig
    if C > 1 and exact_k:
        snz, snv, snl = zn, v, lam
        kws = torch.zeros_like(k)
        it = 0
        while it < k_max and not bool(done.all()):
            a = torch.logical_not(done)
            snz, snv, snl = _sel(a, zn, snz), _sel(a, v, snv), _sel(a, lam,
                                                                    snl)
            kws = torch.where(a, it, kws)
            # windows may overshoot k_max: the replay budget cuts each
            # lane off at exactly k_max
            for _ in range(C - 1):
                v, lam, zn, _rp, _rd = ops.iterate(zn, v, lam, check=False)
            v, lam, zn, r_p, r_d = ops.iterate(zn, v, lam)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
            it += C
        # replay each lane's last window with per-iteration checks
        budget = torch.clamp(k_max - kws, max=C)
        convd = torch.zeros_like(done)
        k = kws
        z, zn, v, lam = snz, snz, snv, snl
        for j in range(C):
            act = torch.logical_not(convd) & (j < budget)
            v_new, lam_new, z_new, r_p, r_d = ops.iterate(zn, v, lam)
            z, zn = _sel(act, zn, z), _sel(act, z_new, zn)
            v, lam = _sel(act, v_new, v), _sel(act, lam_new, lam)
            k = k + act.to(torch.int32)
            rp, rd = _sel(act, r_p, rp), _sel(act, r_d, rd)
            convd = torch.logical_or(convd, act & conv_of(r_p, r_d))
        done = convd
    elif C > 1:
        # a tile of tile_b lanes stops iterating once all its lanes are
        # done; until then its converged lanes keep iterating too
        if B % tile_b:
            raise ValueError(f"batch {B} is not a multiple of tile_b "
                             f"{tile_b}")
        it = 0
        while it < k_max and not bool(done.all()):
            ta = torch.logical_not(
                done.reshape(-1, tile_b).all(dim=1)).repeat_interleave(tile_b)
            n_fast = min(C - 1, k_max - 1 - it)
            for _ in range(n_fast):
                v_new, lam_new, z_new, _rp, _rd = ops.iterate(zn, v, lam,
                                                              check=False)
                zn, v, lam = (_sel(ta, z_new, zn), _sel(ta, v_new, v),
                              _sel(ta, lam_new, lam))
            v_new, lam_new, z_new, r_p, r_d = ops.iterate(zn, v, lam)
            zn, v, lam = (_sel(ta, z_new, zn), _sel(ta, v_new, v),
                          _sel(ta, lam_new, lam))
            a = torch.logical_not(done)
            k = k + a.to(torch.int32) * (n_fast + 1)
            rp, rd = _sel(a, r_p, rp), _sel(a, r_d, rd)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
            it += n_fast + 1
        z = zn
    else:
        z = zn
        for it in range(k_max):
            if it % _SYNC_EVERY == 0 and bool(done.all()):
                break
            v_new, lam_new, z_new, r_p, r_d = ops.iterate(zn, v, lam)
            a = torch.logical_not(done)
            z, zn = _sel(a, zn, z), _sel(a, z_new, zn)
            v, lam = _sel(a, v_new, v), _sel(a, lam_new, lam)
            k = k + a.to(torch.int32)
            rp, rd = _sel(a, r_p, rp), _sel(a, r_d, rd)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
    e_flag = torch.where(done, 1, -1).to(torch.int32)
    return z, v, lam, k, e_flag, rp, rd


def _bytes(nzp, n, lanes, slab, leaves, warps):
    """The ring of M2's slabs, `leaves` leaves as [nzp][lanes], dq with its
    padding, the warps' row maxima, the masks, the window starts, the
    slots' lanes, the lanes' ball scales, the slab's two staged differences
    [n][lanes + DQ_PAD] and pinvh."""
    return stage.ring_bytes(nzp, slab) + 4 * (
        nzp * ((leaves + 1) * lanes + DQ_PAD) + warps * 2 * lanes + 4
        + 3 * lanes + 2 * n * (lanes + DQ_PAD) + n * n)


def wide_layout(nzp: int, n: int, lanes: int) -> tuple[int, bool]:
    """(rows a slab, global leaves) of the wide build (stage.wide_layout)."""
    return stage.wide_layout(lanes, lambda slab, leaves: _bytes(
        nzp, n, lanes, slab, leaves, stage.WIDE_WARPS))


def shared_bytes(nzp: int, n: int, lanes: int, wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_ellip_smem in the source; the
    wide build's fused_ellip_wide_smem): z, v and lam in shared memory,
    nzp / 32 warps' row maxima; the wide build's WIDE_WARPS, and z alone
    where v and lam go to global scratch."""
    if not wide:
        return _bytes(nzp, n, lanes, stage.build_of(BUILDS, nzp, lanes)[0],
                      3, nzp // WARP)
    slab, global_leaves = wide_layout(nzp, n, lanes)
    return _bytes(nzp, n, lanes, slab, 1 if global_leaves else 3,
                  stage.WIDE_WARPS)


def check_width(nzp: int) -> None:
    """Raise ValueError unless some build of the kernel takes this padded
    width (a plain check, no CUDA: the fused builder calls it when it
    builds for the card)."""
    check_widths("fused ellipMPC-ADMM kernel (K4, csrc/fused_ellip.cu)",
                 WIDE_COLS, width=nzp)


def launch_plan(B: int, nzp: int, t0: int, n: int, *, tile_b: int,
                check_every: int, exact_k: bool, fixed_iters: int,
                lanes: int | None = None, wide: bool | None = None):
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (and wide=True for the
    wide build). `lanes` names a build in place of the dispatch's choice,
    `wide` the wide build or not (by default: past MAX_COLS columns);
    raises ValueError on a shape or mode no build takes."""
    check_width(nzp)
    if not (0 < n <= WARP and 0 <= t0 and t0 + n <= nzp
            and t0 % WARP + n <= WARP):
        raise ValueError(f"the kernel takes a terminal slab inside one warp "
                         f"of {WARP} columns; got t0={t0}, n={n}")
    # fixed_iters runs plain iterations alone, whatever check_every says
    stage.check_mode(B, tile_b=tile_b,
                     check_every=1 if fixed_iters else check_every,
                     exact_k=exact_k)
    if stage.use_wide(nzp, wide):
        # the wide build refills in every mode but fixed_iters
        return stage.plan(B, nzp, lambda L: shared_bytes(nzp, n, L, True),
                          stage.WIDE_BUILDS, refill=not fixed_iters,
                          lanes=lanes,
                          layout=lambda L: wide_layout(nzp, n, L))
    refill = not fixed_iters and not (check_every > 1 and exact_k)
    return stage.plan(B, nzp, lambda L: shared_bytes(nzp, n, L), BUILDS,
                      refill=refill, lanes=lanes)


def launch_geometry(B: int, nzp: int, t0: int, n: int, **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, nzp, t0, n, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(z1, v0, lam0, M2_pad, pinvh, LB_pad, UB_pad, c_pad, *, t0, rho,
            r_ball, tol_p, tol_d, k_max, tile_b, check_every, fixed_iters,
            exact_k, lanes=None, wide=None):
    args = (z1, v0, lam0, M2_pad, pinvh, LB_pad, UB_pad, c_pad)
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, nzp = z1.shape
    n = pinvh.shape[0]
    plan = launch_plan(B, nzp, t0, n, tile_b=tile_b, check_every=check_every,
                       exact_k=exact_k, fixed_iters=fixed_iters, lanes=lanes,
                       wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    wide = plan.get("wide", False)
    launch = (load_kernel("fused_ellip", "fused_ellip_wide_launch",
                          FUSED_ELLIP_WIDE_ARGTYPES) if wide else
              load_kernel("fused_ellip", "fused_ellip_launch",
                          FUSED_ELLIP_ARGTYPES))
    dev = z1.device
    z, v, lam = (torch.empty_like(z1) for _ in range(3))
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    exact = check_every > 1 and exact_k and not fixed_iters
    snap = torch.empty((B if exact else 0, SNAP_LEAVES * nzp),
                       dtype=torch.float32, device=dev)
    # the queue of groups of 8 lanes (refill), then each block's count of
    # iterations (refill) and kilo-clocks of the two halves of an iteration
    # (in a build with TP_CLOCKS; else zeros)
    nb = plan["blocks"]
    queue = torch.zeros((1 + 3 * nb,), dtype=torch.int32, device=dev)
    scratch = (queue,)
    build = [plan["lanes"]]
    if wide:
        # exact-k's window starts and links; the global leaves: v and lam
        # of each block's lanes
        scratch += (torch.empty((B + B // 8 if exact and plan["refill"]
                                 else 0,), dtype=torch.int32, device=dev),
                    torch.empty((nb * 2 * nzp * plan["lanes"]
                                 if plan["global_leaves"] else 0,),
                                dtype=torch.float32, device=dev))
        build.append(int(plan["refill"]))
    ptrs = [t.data_ptr() for t in args + (z, v, lam, k, done, rp, rd, snap)
            + scratch]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build += [plan["blocks"], plan["threads"], plan["smem"]]
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, nzp, int(t0), n, *build, float(rho), float(1.0 / rho),
            float(r_ball), float(tol_p), float(tol_d), int(k_max),
            int(check_every), int(fixed_iters), int(bool(exact_k)), stream)
    if err != 0:
        raise RuntimeError(f"fused_ellip kernel launch failed with CUDA "
                           f"error {err} ({plan})")
    fused_ellip_solve.launches += 1
    fused_ellip_solve.last_plan = dict(
        plan, block_iterations=queue[1:1 + nb],
        block_clocks=queue[1 + nb:].view(nb, 2))
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return z, v, lam, k, e_flag, rp, rd


def fused_ellip_solve(z1, v0, lam0, M2_pad, pinvh, LB_pad, UB_pad, c_pad, *,
                      t0: int, rho: float, r_ball: float, tol_p: float,
                      tol_d: float, k_max: int, tile_b: int = 256,
                      check_every: int = 1, fixed_iters: int = 0,
                      exact_k: bool = False, lanes: int | None = None,
                      wide: bool | None = None):
    """Run the fused ellipMPC-ADMM loop on [B, nzp] tensors in transformed
    coordinates (padded as the module docstring says; B a multiple of
    tile_b): z1 and v0 transformed, lam0 the dual as it is; M2_pad
    [nzp, nzp] in row form (z' += dq @ M2_pad); pinvh the [n, n] map of
    the slab back to the original coordinates; the bounds and c' rows of
    nzp entries; the slab at columns t0 .. t0+n-1. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise. `lanes` names
    the build to launch (one of stage.LANES) in place of the dispatch's
    choice, `wide` the wide build or not (by default: past MAX_COLS
    columns); the results depend on neither, and the plain version has no
    such builds.

    Returns (z', v' [B, nzp] transformed, lam [B, nzp], k [B] int32,
    e_flag [B] int32 (1 converged / -1 k_max reached), r_p [B], r_d [B]).
    """
    B, nzp = z1.shape
    args = (z1, v0, lam0, M2_pad, pinvh, LB_pad, UB_pad, c_pad)
    for t in (v0, lam0):
        if t.shape != (B, nzp):
            raise ValueError(f"z1, v0 and lam0 must share one shape; got "
                             f"{tuple(z1.shape)} and {tuple(t.shape)}")
    n = pinvh.shape[0]
    if (M2_pad.shape != (nzp, nzp) or pinvh.shape != (n, n)
            or any(t.numel() != nzp for t in (LB_pad, UB_pad, c_pad))):
        raise ValueError(f"M2_pad must be [{nzp}, {nzp}], pinvh square and "
                         f"the rows hold {nzp} entries")
    if not 0 <= t0 <= nzp - n:
        raise ValueError(f"the slab t0={t0}, n={n} lies outside {nzp} "
                         f"columns")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(t0=int(t0), rho=rho, r_ball=r_ball, tol_p=tol_p, tol_d=tol_d,
              k_max=k_max, tile_b=tile_b, check_every=check_every,
              fixed_iters=fixed_iters, exact_k=exact_k)
    if z1.device.type == "cpu":
        return fused_ellip_reference(*args, **kw)
    if z1.device.type == "cuda":
        return _launch(*args, lanes=lanes, wide=wide, **kw)
    raise ValueError(f"fused_ellip_solve takes CPU or CUDA tensors; got "
                     f"{z1.device}")


fused_ellip_solve.launches = 0
fused_ellip_solve.last_plan = None
