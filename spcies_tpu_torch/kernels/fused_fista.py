"""Fused dual FISTA: the wrapper of the hand-written CUDA kernel
(csrc/fused_fista.cu) and its plain PyTorch version.

Counterpart of spcies_tpu/kernels/fused_fista.py (`_fused_fista_kernel`),
serving laxMPC-FISTA and equMPC-FISTA. For each lane the loop runs, with
q = q_ref - y G and r = b - z_prev G' kept in delta form,

    z    = clip(-hinv q, LB, UB)
    r    = r - (z - z_prev) @ G'          (dz -> 0)
    res  = max |r|
    lam' = y + r @ Winv'
    t    = 1 where restart and res > res_prev
    t'   = (1 + sqrt(1 + 4 t t)) / 2
    y'   = lam' + ((t - 1) / t') (lam' - lam)
    q    = q - (y' - y) @ G               (dy -> 0)

in one of four modes:

  checked     check_every=1: exit tests every iteration; on the converging
              iteration lam, y and t keep their values (the dense engine's
              momentum mask), and a converged lane freezes.
  free-run    check_every=C>1: C-1 plain iterations, then one tested
              iteration; k is recorded at check granularity, converged
              lanes keep iterating until their tile drains, and a done
              lane's reported residual is frozen at its exit while its
              running residual keeps feeding the restart test.
  exact-k     check_every=C>1, exact_k: free-run windows with a snapshot
              of each active lane's seven in-loop leaves (q, z_prev, r, y,
              lam, t, res) at the window start; a lane is done when the
              window's MINIMUM residual meets tol (FISTA's residual
              oscillates, so the last one can miss a crossing inside the
              window); then each lane's last window is replayed with the
              checked semantics — the checked mode's k, e_flag and
              iterates at free-run speed.
  fixed_iters exactly fixed_iters plain iterations, k = fixed_iters,
              e_flag = 1, res the last iteration's.

Padding contract: nz and nlam = N n are padded to multiples of COL_PAD
with zero rows and columns in G, G' and Winv', zero hinv and [0, 0]
bounds, so padded entries stay exactly 0 and never enter the residual.
The batch is padded to a multiple of tile_b by the caller.

`fused_fista_solve` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; `fused_fista_solve.launches` counts the
launches and `fused_fista_solve.last_plan` holds the last launch's build
and geometry.

The kernel runs its three products on the product stage
csrc/tile_product.cuh, built for 8, 16 and 32 lanes a block
(kernels/stage.py plans the launch; there is no refill: every mode keeps a
block of L lanes, and plain free-run freezes each group of 8 lanes once its
lanes are done, as a tile of tile_b = 8 drains). Every build gives the same
bits, so `lanes=` of `fused_fista_solve` may name another build, for a
check or a timing.

Past MAX_COLS columns of either width, up to WIDE_COLS, the wide build
(fused_fista_wide_kernel) runs the narrow builds' iteration on the stage,
512 threads of two columns of each width at 16 or 8 lanes a block
(stage.WIDE_BUILDS), no refill: its three products through one ring of
16-row slabs where they fit (else 8, `wide_slab`), q, z_prev, y and lam in
the block's global scratch. `wide=` of
`fused_fista_solve` names it at any width, for a check of bits.
"""

from __future__ import annotations

import ctypes

import torch

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, DQ_PAD, MAX_COLS,
                                                 RBIG, SMEM_MAX, WIDE_COLS,
                                                 check_widths, round_up)

__all__ = ["check_width", "COL_PAD", "MAX_COLS", "round_up",
           "fused_fista_reference", "fused_fista_solve", "launch_geometry",
           "launch_plan", "shared_bytes"]

# C signature of fused_fista_launch: 19 tensor pointers (11 inputs, 6
# outputs, the exact-k snapshot scratch, int32 scratch for the matrices'
# real rows and the clock counts); B, nzp, nlamp, lanes, blocks, threads,
# shared bytes; tol; k_max, restart, check_every, fixed_iters, exact_k; the
# stream
FUSED_FISTA_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                        + [ctypes.c_float] + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
# lanes a block -> (rows a slab of the ring, blocks an SM) of its build up
# to stage.NARROW columns (Build<L> in csrc/fused_fista.cu)
BUILDS = {8: (16, 2), 16: (16, 1), 32: (16, 1)}
WARP = 32
# C signature of fused_fista_wide_launch: 20 pointers (the blocks' global
# scratch before the int32 scratch); then as fused_fista_launch's
FUSED_FISTA_WIDE_ARGTYPES = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 7
                             + [ctypes.c_float] + [ctypes.c_int] * 5
                             + [ctypes.c_void_p])
# plain version: read "all lanes done" on the host every this many
# iterations of the checked loop (extra iterations of frozen lanes are
# exact no-ops)
_SYNC_EVERY = 8


def _sel(mask, new, old):
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


class _Ops:
    """One iteration in the kernel's operation order, over padded
    operators."""

    def __init__(self, G, GT, WinvT, hinv, lb, ub, restart):
        self.G, self.GT, self.WinvT = G, GT, WinvT
        self.nhinv = -hinv.reshape(1, -1)
        self.lb, self.ub = lb.reshape(1, -1), ub.reshape(1, -1)
        self.restart = restart

    def iterate(self, q, zp, r, y, lam, t, res_prev):
        """One iteration up to the q update; returns (z, r_new, res,
        lam_new, y_new, t_new)."""
        z = torch.minimum(torch.maximum(self.nhinv * q, self.lb), self.ub)
        r_new = r - (z - zp) @ self.GT
        res = torch.amax(torch.abs(r_new), dim=1)
        lam_new = y + r_new @ self.WinvT
        t_cur = torch.where(res > res_prev, 1.0, t) if self.restart else t
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t_cur * t_cur))
        coef = (t_cur - 1.0) / t_new
        y_new = lam_new + coef[:, None] * (lam_new - lam)
        return z, r_new, res, lam_new, y_new, t_new

    def free(self, s):
        """A plain iteration of every lane; s = (q, z_prev, r, y, lam, t,
        res)."""
        q, zp, r, y, lam, t, res = s
        z, r_new, res_new, lam_new, y_new, t_new = self.iterate(*s)
        return (q - (y_new - y) @ self.G, z, r_new, y_new, lam_new, t_new,
                res_new)

    def checked(self, s, frozen, tol):
        """A checked iteration: lanes in `frozen` keep everything; on the
        converging iteration lam, y and t keep their values. Returns the
        new state and conv (res <= tol, all lanes)."""
        q, zp, r, y, lam, t, res = s
        z, r_new, res_new, lam_new, y_new, t_new = self.iterate(*s)
        conv = res_new <= tol
        keep = conv | frozen
        y_out, lam_out = _sel(keep, y, y_new), _sel(keep, lam, lam_new)
        t_out = torch.where(keep, t, t_new)
        q_new = q - (y_out - y) @ self.G
        act = torch.logical_not(frozen)
        return ((_sel(act, q_new, q), _sel(act, z, zp), _sel(act, r_new, r),
                 y_out, lam_out, t_out, torch.where(act, res_new, res)),
                conv)


def fused_fista_reference(q1, z0, r0, y0, lam0, G_pad, GT_pad, WinvT_pad,
                          hinv_pad, LB_pad, UB_pad, *, tol: float,
                          k_max: int, restart: bool = False,
                          tile_b: int = 256, check_every: int = 1,
                          fixed_iters: int = 0, exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_fista_solve`."""
    B = q1.shape[0]
    dt, dev = q1.dtype, q1.device
    ops = _Ops(G_pad, GT_pad, WinvT_pad, hinv_pad, LB_pad, UB_pad,
               bool(restart))
    C = int(check_every)
    t0 = torch.ones((B,), dtype=dt, device=dev)
    rbig = torch.full((B,), RBIG, dtype=dt, device=dev)
    s = (q1, z0, r0, y0, lam0, t0, rbig)

    if fixed_iters:
        for _ in range(int(fixed_iters)):
            s = ops.free(s)
        k = torch.full((B,), int(fixed_iters), dtype=torch.int32, device=dev)
        return s[1], s[3], s[4], k, torch.ones_like(k), s[6]

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)
    if C > 1 and exact_k:
        snap = s
        kws = torch.zeros_like(k)
        it = 0
        while it < k_max and not bool(done.all()):
            a = torch.logical_not(done)
            snap = tuple(_sel(a, x, sx) for x, sx in zip(s, snap))
            kws = torch.where(a, it, kws)
            # windows may overshoot k_max: the replay budget cuts each
            # lane off at exactly k_max
            res_min = rbig
            for _ in range(C):
                s = ops.free(s)
                res_min = torch.minimum(res_min, s[6])
            done = torch.logical_or(done, a & (res_min <= tol))
            it += C
        # replay each lane's last window with per-iteration checks
        budget = torch.clamp(k_max - kws, max=C)
        convd = torch.zeros_like(done)
        k = kws
        s = snap
        for j in range(C):
            frozen = convd | (j >= budget)
            s, conv = ops.checked(s, frozen, tol)
            act = torch.logical_not(frozen)
            k = k + act.to(torch.int32)
            convd = torch.logical_or(convd, act & conv)
        done, res = convd, s[6]
    elif C > 1:
        # a tile of tile_b lanes stops iterating once all its lanes are
        # done; until then its converged lanes keep iterating too
        if B % tile_b:
            raise ValueError(f"batch {B} is not a multiple of tile_b "
                             f"{tile_b}")
        res = rbig
        it = 0
        while it < k_max and not bool(done.all()):
            ta = torch.logical_not(
                done.reshape(-1, tile_b).all(dim=1)).repeat_interleave(tile_b)
            n_fast = min(C - 1, k_max - 1 - it)
            for _ in range(n_fast + 1):
                s = tuple(_sel(ta, x, ox) for x, ox in zip(ops.free(s), s))
            conv = s[6] <= tol
            a = torch.logical_not(done)
            k = k + a.to(torch.int32) * (n_fast + 1)
            res = torch.where(a, s[6], res)
            done = torch.logical_or(done, a & conv)
            it += n_fast + 1
    else:
        for it in range(k_max):
            if it % _SYNC_EVERY == 0 and bool(done.all()):
                break
            s, conv = ops.checked(s, done, tol)
            a = torch.logical_not(done)
            k = k + a.to(torch.int32)
            done = torch.logical_or(done, a & conv)
        res = s[6]
    e_flag = torch.where(done, 1, -1).to(torch.int32)
    return s[1], s[3], s[4], k, e_flag, res


def shared_bytes(nzp: int, nlamp: int, lanes: int,
                 wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_fista_smem in the source): the
    ring of slabs of the widest row, q, z_prev, y and lam as [rows][lanes],
    r and the dz/dy buffer with their padding, the warps' row maxima, the
    coefficients, the masks, the window starts, the slots' lanes and the
    snapshot's t and res. The wide build's (fused_fista_wide_smem):
    `_wide_bytes` of its `wide_slab`."""
    if wide:
        return _wide_bytes(nzp, nlamp, lanes, wide_slab(nzp, nlamp, lanes))
    T = max(nzp, nlamp)
    slab = stage.build_of(BUILDS, T, lanes)[0]
    return stage.ring_bytes(T, slab) + 4 * (
        (2 * nzp + 2 * nlamp) * lanes + (nlamp + T) * (lanes + DQ_PAD)
        + T // WARP * 2 * lanes + lanes + 4 + 4 * lanes)


def _wide_bytes(nzp: int, nlamp: int, lanes: int, slab: int) -> int:
    """A wide block's shared bytes (wide_bytes in the source) at `slab`
    rows a slab: the ring of slabs of the widest row, r and the dz/dy
    buffer with their padding, the 16 warps' row maxima, the coefficients,
    the masks, the window starts, the slots' lanes and the snapshot's t and
    res; q, z_prev, y and lam lie in global scratch."""
    T = max(nzp, nlamp)
    return stage.ring_bytes(T, slab) + 4 * (
        (nlamp + T) * (lanes + DQ_PAD) + stage.WIDE_WARPS * 2 * lanes
        + lanes + 4 + 4 * lanes)


def wide_slab(nzp: int, nlamp: int, lanes: int) -> int:
    """Rows a slab of the wide build at `lanes` lanes (wide_slab_rows in
    the source): 16 (stage.WIDE_BUILDS' at 16 lanes) where they fit, else
    stage.GLOBAL_SLAB."""
    slab = stage.WIDE_BUILDS[16][0]
    if _wide_bytes(nzp, nlamp, lanes, slab) > SMEM_MAX:
        slab = stage.GLOBAL_SLAB
    return slab


def check_width(nzp: int, nlamp: int) -> None:
    """Raise ValueError unless some build of the kernel takes these padded
    widths (a plain check, no CUDA: the fused builder calls it when it
    builds for the card)."""
    check_widths("fused dual-FISTA kernel (K2, csrc/fused_fista.cu)",
                 WIDE_COLS, nz=nzp, nlam=nlamp)


def launch_plan(B: int, nzp: int, nlamp: int, *, tile_b: int,
                check_every: int, exact_k: bool, fixed_iters: int,
                k_max: int, lanes: int | None = None,
                wide: bool | None = None):
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (always False); the wide
    build's also wide=True, its rows a slab (`wide_slab`) and global_leaves
    (always True). `lanes` names a build in place of the dispatch's
    choice, `wide` the wide build or not (by default: past MAX_COLS columns
    of either width); raises ValueError on a shape or mode no build
    takes."""
    check_width(nzp, nlamp)
    if k_max < 1:
        raise ValueError(f"k_max must be at least 1; got {k_max}")
    # fixed_iters runs plain iterations alone, whatever check_every says
    stage.check_mode(B, tile_b=tile_b,
                     check_every=1 if fixed_iters else check_every,
                     exact_k=exact_k)
    if stage.use_wide(max(nzp, nlamp), wide):
        return stage.plan(B, max(nzp, nlamp),
                          lambda L: shared_bytes(nzp, nlamp, L, wide=True),
                          stage.WIDE_BUILDS, refill=False, lanes=lanes,
                          layout=lambda L: (wide_slab(nzp, nlamp, L), True))
    return stage.plan(B, max(nzp, nlamp),
                      lambda L: shared_bytes(nzp, nlamp, L), BUILDS,
                      refill=False, lanes=lanes)


def launch_geometry(B: int, nzp: int, nlamp: int, **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, nzp, nlamp, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(q1, z0, r0, y0, lam0, G_pad, GT_pad, WinvT_pad, hinv_pad,
            LB_pad, UB_pad, *, tol, k_max, restart, tile_b, check_every,
            fixed_iters, exact_k, lanes=None, wide=None):
    args = (q1, z0, r0, y0, lam0, G_pad, GT_pad, WinvT_pad, hinv_pad,
            LB_pad, UB_pad)
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, nzp = q1.shape
    nlamp = r0.shape[1]
    plan = launch_plan(B, nzp, nlamp, tile_b=tile_b, check_every=check_every,
                       exact_k=exact_k, fixed_iters=fixed_iters, k_max=k_max,
                       lanes=lanes, wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    wide = plan.get("wide", False)
    launch = (load_kernel("fused_fista", "fused_fista_wide_launch",
                          FUSED_FISTA_WIDE_ARGTYPES) if wide else
              load_kernel("fused_fista", "fused_fista_launch",
                          FUSED_FISTA_ARGTYPES))
    dev = q1.device
    z = torch.empty_like(q1)
    y, lam = torch.empty_like(r0), torch.empty_like(r0)
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    res = torch.empty((B,), dtype=torch.float32, device=dev)
    # exact-k window snapshots of (q, z_prev) and (r, y, lam), per lane
    exact = check_every > 1 and exact_k and not fixed_iters
    snap = torch.empty((B if exact else 0, 2 * nzp + 3 * nlamp),
                       dtype=torch.float32, device=dev)
    # the wide build's blocks' leaves: z_prev, q, y and lam
    scratch = (torch.empty((B * (2 * nzp + 2 * nlamp),),
                           dtype=torch.float32, device=dev),) if wide else ()
    # the real rows of G', Winv' and G, found by the launch; then each
    # block's kilo-clocks of its iterations and of each product's slab loop
    # (in a build with TP_CLOCKS; else zeros)
    nb = plan["blocks"]
    ext = torch.zeros((4 + 4 * nb,), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in args + (z, y, lam, k, done, res, snap)
            + scratch + (ext,)]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, nzp, nlamp, plan["lanes"], plan["blocks"],
            plan["threads"], plan["smem"], float(tol), int(k_max),
            int(bool(restart)), int(check_every), int(fixed_iters),
            int(bool(exact_k)), stream)
    if err != 0:
        raise RuntimeError(f"fused_fista kernel launch failed with CUDA "
                           f"error {err} ({plan})")
    fused_fista_solve.launches += 1
    fused_fista_solve.last_plan = dict(plan,
                                       block_clocks=ext[4:].view(nb, 4))
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return z, y, lam, k, e_flag, res


def fused_fista_solve(q1, z0, r0, y0, lam0, G_pad, GT_pad, WinvT_pad,
                      hinv_pad, LB_pad, UB_pad, *, tol: float, k_max: int,
                      restart: bool = False, tile_b: int = 256,
                      check_every: int = 1, fixed_iters: int = 0,
                      exact_k: bool = False, lanes: int | None = None,
                      wide: bool | None = None):
    """Run the fused dual-FISTA loop: q1, z0 [B, nzp]; r0, y0, lam0
    [B, nlamp]; G_pad [nlamp, nzp], GT_pad [nzp, nlamp], WinvT_pad
    [nlamp, nlamp]; hinv_pad and the bounds hold nzp entries (padded as
    the module docstring says; B a multiple of tile_b). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise. `lanes`
    names the build to launch (one of stage.LANES) in place of the
    dispatch's choice, `wide` the wide build or not (by default: past
    MAX_COLS columns of either width); the results depend on neither, and
    the plain version has no such builds.

    Returns (z [B, nzp], y, lam [B, nlamp], k [B] int32, e_flag [B] int32
    (1 converged / -1 k_max reached), res [B]).
    """
    B, nzp = q1.shape
    nlamp = r0.shape[1]
    if z0.shape != (B, nzp):
        raise ValueError(f"q1 and z0 must share one shape; got "
                         f"{tuple(q1.shape)} and {tuple(z0.shape)}")
    for t in (r0, y0, lam0):
        if t.shape != (B, nlamp):
            raise ValueError(f"r0, y0 and lam0 must share one shape [B, "
                             f"nlamp]; got {tuple(r0.shape)} and "
                             f"{tuple(t.shape)}")
    if (G_pad.shape != (nlamp, nzp) or GT_pad.shape != (nzp, nlamp)
            or WinvT_pad.shape != (nlamp, nlamp)):
        raise ValueError(f"G_pad must be [{nlamp}, {nzp}], GT_pad "
                         f"[{nzp}, {nlamp}] and WinvT_pad [{nlamp}, "
                         f"{nlamp}]")
    if any(t.numel() != nzp for t in (hinv_pad, LB_pad, UB_pad)):
        raise ValueError(f"hinv_pad and the bounds hold {nzp} entries")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    args = (q1, z0, r0, y0, lam0, G_pad, GT_pad, WinvT_pad, hinv_pad,
            LB_pad, UB_pad)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(tol=tol, k_max=k_max, restart=restart, tile_b=tile_b,
              check_every=check_every, fixed_iters=fixed_iters,
              exact_k=exact_k)
    if q1.device.type == "cpu":
        return fused_fista_reference(*args, **kw)
    if q1.device.type == "cuda":
        return _launch(*args, lanes=lanes, wide=wide, **kw)
    raise ValueError(f"fused_fista_solve takes CPU or CUDA tensors; got "
                     f"{q1.device}")


fused_fista_solve.launches = 0
fused_fista_solve.last_plan = None
