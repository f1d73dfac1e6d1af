"""Fused delta-form box-ADMM: the wrapper of the hand-written CUDA kernel
(csrc/fused_admm.cu) and its plain PyTorch version.

Counterpart of spcies_tpu/kernels/fused_admm.py (`_fused_admm_kernel`).
For each lane the loop runs

    v      = clip(z + rho_i lam, LB, UB)
    lam   += rho (z - v)
    r_p    = max |z - v| ; r_d = max |v - v_prev|
    dq     = rho (z - 2 v + v_prev)          (delta form; dq -> 0)
    z_next = z + dq @ M_q

(with over-relaxation, z in the v/dual updates is alpha z + (1-alpha)
v_prev) in one of four modes:

  checked     check_every=1: exit tests every iteration; a converged lane
              freezes and keeps the z it consumed at exit.
  free-run    check_every=C>1: C-1 plain iterations, then one checked
              iteration; k is recorded at check granularity, converged
              lanes keep iterating until their tile drains, and the output
              z is the prepared iterate.
  exact-k     check_every=C>1, exact_k: free-run windows with a snapshot
              of each lane's state at the start of the window it converges
              in, then a per-iteration replay of that window — the checked
              mode's k, e_flag and exit iterates at free-run speed.
  fixed_iters exactly fixed_iters plain iterations, k = fixed_iters,
              e_flag = 1, residuals 3.4e38.

Padding contract: nz is padded to a multiple of COL_PAD with zero rows and
columns in M_q and [0, 0] bounds, so padded entries stay exactly 0 and
never contribute to the residual norms. The batch is padded to a multiple
of tile_b by the caller.

`fused_admm_solve` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; `fused_admm_solve.launches` counts the launches.

The kernel is built for 8, 16 and 32 lanes a thread block (its product
stage is csrc/tile_product.cuh); `pick_lanes` takes the widest build that
divides the batch, fits the 232,448 bytes of shared memory a block can have
and still gives half of the 132 SMs a block, and `launch_plan` states the
choice. Up to MAX_COLS padded columns a build runs one thread a column;
past that the wide build (fused_admm_wide_kernel<L>) runs WIDE_THREADS
threads of WIDE_CPT columns each, at 8 or 16 lanes a block, and takes
WIDE_THREADS up to WIDE_COLS columns (`check_width` says whether some build
takes a width). Every build gives the same bits, so `lanes=` and `wide=` of
`fused_admm_solve` may name another build, for a check or a timing. The
bf16 mode runs the same kernel with M and dq rounded to bf16.
"""

from __future__ import annotations

import ctypes

import torch

# columns are padded to whole warps: the kernel runs one thread per column
COL_PAD = 32
# plain free-run drains by groups of this many lanes (a tile of tile_b = 8),
# whatever the lanes a block
DRAIN_LANES = 8
# lanes a block the kernel is built for (fused_admm_kernel<L> in
# csrc/fused_admm.cu), widest first
LANES = (32, 16, 8)
# threads per block the kernel is compiled for (__launch_bounds__), and the
# widest padded width of a one-thread-a-column build (K2-K7 share the cap);
# up to NARROW columns a build of its own, with more registers and deeper
# slabs
MAX_COLS = 512
NARROW = 256
# the wide build: WIDE_CPT columns a thread on WIDE_THREADS threads, up to
# WIDE_COLS columns, slabs of WIDE_SLAB_ROWS rows where SLAB_ROWS leave no
# room in shared memory
WIDE_CPT, WIDE_THREADS = 2, 512
WIDE_COLS = WIDE_CPT * WIDE_THREADS
WIDE_SLAB_ROWS = 8
# dynamic shared memory a block can have on an H100, and its SMs
SMEM_MAX = 232448
SMS = 132
# csrc/tile_product.cuh as built: rows a slab of M (and in a narrow
# build), buffers in the ring, floats of padding a row of dq, bytes of the
# ring's mbarriers
SLAB_ROWS, SLAB_ROWS_NARROW, STAGES, DQ_PAD, RING_EXTRA = 16, 32, 2, 4, 64
# the "no residual yet" value of the JAX kernel, rounded to fp32
RBIG = 3.4e38
# the leaves an exact-k snapshot saves per lane: z, v, lam
SNAP_LEAVES = 3
# C signature of fused_admm_launch: 15 tensor pointers (6 inputs, 7 outputs,
# the exact-k snapshot scratch, the bf16 mode's scratch for M rounded); B,
# nzp, lanes, wide, blocks, threads, shared bytes; rho, 1/rho, alpha,
# 1-alpha; relax; tol_p, tol_d; k_max, check_every, fixed_iters, exact_k,
# bf16; the stream
FUSED_ADMM_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 4 + [ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
# plain version: read "all lanes done" on the host every this many
# iterations of the checked loop (extra iterations of frozen lanes are
# exact no-ops)
_SYNC_EVERY = 8


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _iterate(zc, v_prev, lam, M, lb, ub, *, rho, rho_i, alpha, bf16):
    """One ADMM iteration in the kernel's operation order. Returns
    (v_new, lam_new, z_next, r_p, r_d)."""
    zr = zc if alpha == 1.0 else alpha * zc + (1.0 - alpha) * v_prev
    y = zr + rho_i * lam
    v_new = torch.minimum(torch.maximum(y, lb), ub)
    lam_new = lam + rho * (zr - v_new)
    dq = rho * (zr - 2.0 * v_new + v_prev)
    if bf16:
        dq = dq.to(torch.bfloat16).to(zc.dtype)
    z_next = zc + dq @ M
    r_p = torch.amax(torch.abs(zc - v_new), dim=1)
    r_d = torch.amax(torch.abs(v_new - v_prev), dim=1)
    return v_new, lam_new, z_next, r_p, r_d


def fused_admm_reference(z1, v0, lam0, M_q_pad, LB_pad, UB_pad, *,
                         rho: float, tol_p: float, tol_d: float, k_max: int,
                         tile_b: int = 256, bf16: bool = False,
                         relax_alpha: float = 1.0, check_every: int = 1,
                         fixed_iters: int = 0, exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_admm_solve`."""
    B = z1.shape[0]
    dt, dev = z1.dtype, z1.device
    M = M_q_pad.to(torch.bfloat16).to(dt) if bf16 else M_q_pad
    lb, ub = LB_pad.reshape(1, -1), UB_pad.reshape(1, -1)
    C = int(check_every)

    def it_(zc, vp, lm):
        return _iterate(zc, vp, lm, M, lb, ub, rho=float(rho),
                        rho_i=float(1.0 / rho), alpha=float(relax_alpha),
                        bf16=bf16)

    def sel(mask, new, old):
        return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))),
                           new, old)

    def conv_of(r_p, r_d):
        return torch.logical_and(r_p <= tol_p, r_d <= tol_d)

    rbig = torch.full((B,), RBIG, dtype=dt, device=dev)
    zn, v, lam = z1, v0, lam0
    if fixed_iters:
        for _ in range(int(fixed_iters)):
            v, lam, zn, _rp, _rd = it_(zn, v, lam)
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
            snz, snv, snl = sel(a, zn, snz), sel(a, v, snv), sel(a, lam, snl)
            kws = torch.where(a, it, kws)
            # windows may overshoot k_max: the replay budget cuts each
            # lane off at exactly k_max
            for _ in range(C - 1):
                v, lam, zn, _rp, _rd = it_(zn, v, lam)
            v, lam, zn, r_p, r_d = it_(zn, v, lam)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
            it += C
        # replay each lane's last window with per-iteration checks
        budget = torch.clamp(k_max - kws, max=C)
        convd = torch.zeros_like(done)
        k = kws
        z, zn, v, lam = snz, snz, snv, snl
        for j in range(C):
            act = torch.logical_not(convd) & (j < budget)
            v_new, lam_new, z_new, r_p, r_d = it_(zn, v, lam)
            z, zn = sel(act, zn, z), sel(act, z_new, zn)
            v, lam = sel(act, v_new, v), sel(act, lam_new, lam)
            k = k + act.to(torch.int32)
            rp, rd = sel(act, r_p, rp), sel(act, r_d, rd)
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
                v_new, lam_new, z_new, _rp, _rd = it_(zn, v, lam)
                zn, v, lam = (sel(ta, z_new, zn), sel(ta, v_new, v),
                              sel(ta, lam_new, lam))
            v_new, lam_new, z_new, r_p, r_d = it_(zn, v, lam)
            zn, v, lam = (sel(ta, z_new, zn), sel(ta, v_new, v),
                          sel(ta, lam_new, lam))
            a = torch.logical_not(done)
            k = k + a.to(torch.int32) * (n_fast + 1)
            rp, rd = sel(a, r_p, rp), sel(a, r_d, rd)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
            it += n_fast + 1
        z = zn
    else:
        z = zn
        for it in range(k_max):
            if it % _SYNC_EVERY == 0 and bool(done.all()):
                break
            v_new, lam_new, z_new, r_p, r_d = it_(zn, v, lam)
            a = torch.logical_not(done)
            z, zn = sel(a, zn, z), sel(a, z_new, zn)
            v, lam = sel(a, v_new, v), sel(a, lam_new, lam)
            k = k + a.to(torch.int32)
            rp, rd = sel(a, r_p, rp), sel(a, r_d, rd)
            done = torch.logical_or(done, a & conv_of(r_p, r_d))
    e_flag = torch.where(done, 1, -1).to(torch.int32)
    return z, v, lam, k, e_flag, rp, rd


def _smem(nzp: int, lanes: int, slab: int) -> int:
    # the ring of M's slabs, z, v and lam as [nzp][lanes], dq with its
    # padding, the warps' row maxima, the masks, the window starts and the
    # slots' lanes
    return (4 * STAGES * slab * nzp + RING_EXTRA
            + 4 * (nzp * (4 * lanes + DQ_PAD) + nzp // 32 * 2 * lanes + 4
                   + 2 * lanes))


def slab_rows(nzp: int, lanes: int, wide: bool = False) -> int:
    """Rows a slab of M in the build that a launch at this width takes."""
    if not wide:
        return SLAB_ROWS_NARROW if nzp <= NARROW else SLAB_ROWS
    return (SLAB_ROWS if _smem(nzp, lanes, SLAB_ROWS) <= SMEM_MAX
            else WIDE_SLAB_ROWS)


def shared_bytes(nzp: int, lanes: int, wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_admm_smem in the source)."""
    return _smem(nzp, lanes, slab_rows(nzp, lanes, wide))


def check_widths(kernel: str, cap: int, **widths: int) -> None:
    """Raise ValueError, naming `kernel`, the width, the cap and the dense
    backend, unless every padded width (name=width) is a multiple of
    COL_PAD from COL_PAD up to cap."""
    for name, w in widths.items():
        if w % COL_PAD or not 0 < w <= cap:
            raise ValueError(
                f"the {kernel} takes a padded {name} that is a multiple of "
                f"{COL_PAD} up to {cap}; this operator has {w}: use "
                f'backend="dense"')


def check_width(nzp: int) -> None:
    """Raise ValueError unless some build of the kernel takes nzp padded
    columns (a plain check, no CUDA: the fused builders call it when they
    build for the card)."""
    check_widths("fused box-ADMM kernel (K1, csrc/fused_admm.cu)",
                 WIDE_COLS, width=nzp)


def pick_lanes(B: int, nzp: int, wide: bool = False) -> int:
    """Lanes a block for a batch of B lanes of width nzp: the widest build
    that divides the batch, fits shared memory and still gives half of the
    SMs a block (one round of 32-lane blocks beat two of 16-lane blocks at
    B = 4096 on an H100); the narrowest that fits when the batch is smaller
    than that."""
    fits = [L for L in LANES
            if B % L == 0 and shared_bytes(nzp, L, wide) <= SMEM_MAX
            and not (wide and L > 16)]
    if not fits:
        raise ValueError(f"no build of the kernel takes batch {B} at padded "
                         f"width {nzp}")
    for L in fits:
        if B // L >= SMS // 2:
            return L
    return fits[-1]


def launch_plan(B: int, nzp: int, *, tile_b: int, check_every: int,
                exact_k: bool, fixed_iters: int, lanes: int | None = None,
                wide: bool | None = None):
    """The build a launch takes and its geometry, as a dict: lanes a block,
    wide, blocks, threads, dynamic shared bytes, rows a slab. `lanes` names
    a build in place of `pick_lanes`' choice, `wide` the wide build (by
    default taken past MAX_COLS columns alone); raises ValueError on a shape
    or mode no build takes."""
    check_width(nzp)
    if wide is None:
        wide = nzp > MAX_COLS
    if not wide and nzp > MAX_COLS:
        raise ValueError(f"a build of one thread a column takes up to "
                         f"{MAX_COLS} columns; got {nzp}")
    if wide and nzp < WIDE_THREADS:
        raise ValueError(f"the wide build takes {WIDE_THREADS} columns or "
                         f"more; got {nzp}")
    if tile_b % DRAIN_LANES:
        raise ValueError(f"tile_b must be a multiple of {DRAIN_LANES}; "
                         f"got {tile_b}")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    if (check_every > 1 and not exact_k and not fixed_iters
            and tile_b != DRAIN_LANES):
        # in plain free-run the output iterates depend on when a lane's
        # tile drains, and the kernel drains per group of DRAIN_LANES lanes
        raise ValueError(
            f"plain free-run (check_every > 1 without exact_k) takes "
            f"tile_b={DRAIN_LANES} on the GPU; got {tile_b}")
    if lanes is None:
        lanes = pick_lanes(B, nzp, wide)
    elif (lanes not in LANES or B % lanes or (wide and lanes > 16)
          or shared_bytes(nzp, lanes, wide) > SMEM_MAX):
        raise ValueError(f"no build of the kernel takes {lanes} lanes a "
                         f"block at batch {B}, padded width {nzp}"
                         f"{' (wide)' if wide else ''}")
    return dict(lanes=lanes, wide=bool(wide), blocks=B // lanes,
                threads=WIDE_THREADS if wide else nzp,
                smem=shared_bytes(nzp, lanes, wide),
                slab=slab_rows(nzp, lanes, wide))


def launch_geometry(B: int, nzp: int, **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, nzp, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(z1, v0, lam0, M_q_pad, LB_pad, UB_pad, *, rho, tol_p, tol_d,
            k_max, tile_b, bf16, relax_alpha, check_every, fixed_iters,
            exact_k, lanes, wide):
    args = (z1, v0, lam0, M_q_pad, LB_pad, UB_pad)
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, nzp = z1.shape
    plan = launch_plan(B, nzp, tile_b=tile_b, check_every=check_every,
                       exact_k=exact_k, fixed_iters=fixed_iters, lanes=lanes,
                       wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    launch = load_kernel("fused_admm", "fused_admm_launch",
                         FUSED_ADMM_ARGTYPES)
    dev = z1.device
    z, v, lam = (torch.empty_like(z1) for _ in range(3))
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    rp, rd = (torch.empty((B,), dtype=torch.float32, device=dev)
              for _ in range(2))
    exact = check_every > 1 and exact_k and not fixed_iters
    snap = torch.empty((B if exact else 0, SNAP_LEAVES * nzp),
                       dtype=torch.float32, device=dev)
    # the bf16 mode's launch rounds M to bf16 into this before its loop
    m_round = torch.empty((nzp if bf16 else 0, nzp), dtype=torch.float32,
                          device=dev)
    ptrs = [t.data_ptr() for t in (z1, v0, lam0, M_q_pad, LB_pad, UB_pad, z,
                                   v, lam, k, done, rp, rd, snap, m_round)]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    alpha = float(relax_alpha)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, nzp, plan["lanes"], int(plan["wide"]), plan["blocks"],
            plan["threads"], plan["smem"],
            float(rho), float(1.0 / rho), alpha, 1.0 - alpha,
            int(alpha != 1.0), float(tol_p), float(tol_d), int(k_max),
            int(check_every), int(fixed_iters), int(bool(exact_k)),
            int(bool(bf16)), stream)
    if err != 0:
        raise RuntimeError(f"fused_admm kernel launch failed with CUDA "
                           f"error {err} ({plan})")
    fused_admm_solve.launches += 1
    fused_admm_solve.last_plan = plan
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return z, v, lam, k, e_flag, rp, rd


def fused_admm_solve(z1, v0, lam0, M_q_pad, LB_pad, UB_pad, *,
                     rho: float, tol_p: float, tol_d: float, k_max: int,
                     tile_b: int = 256, bf16: bool = False,
                     relax_alpha: float = 1.0, check_every: int = 1,
                     fixed_iters: int = 0, exact_k: bool = False,
                     lanes: int | None = None, wide: bool | None = None):
    """Run the fused ADMM loop on [B, nzp] tensors (padded as the module
    docstring says; B a multiple of tile_b). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise. `lanes` names the
    build to launch (one of LANES) in place of `pick_lanes`' choice, and
    `wide` the wide build or not (by default: past MAX_COLS columns); the
    results do not depend on either, and the plain version has no builds.

    Returns (z, v, lam [B, nzp], k [B] int32, e_flag [B] int32 (1
    converged / -1 k_max reached), r_p [B], r_d [B]).
    """
    B, nzp = z1.shape
    for t in (v0, lam0):
        if t.shape != (B, nzp):
            raise ValueError(f"z1, v0 and lam0 must share one shape; got "
                             f"{tuple(z1.shape)} and {tuple(t.shape)}")
    if (M_q_pad.shape != (nzp, nzp) or LB_pad.numel() != nzp
            or UB_pad.numel() != nzp):
        raise ValueError(f"M_q_pad must be [{nzp}, {nzp}] and the bounds "
                         f"hold {nzp} entries")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    devices = {t.device for t in (z1, v0, lam0, M_q_pad, LB_pad, UB_pad)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(rho=rho, tol_p=tol_p, tol_d=tol_d, k_max=k_max, tile_b=tile_b,
              bf16=bf16, relax_alpha=relax_alpha, check_every=check_every,
              fixed_iters=fixed_iters, exact_k=exact_k)
    if z1.device.type == "cpu":
        return fused_admm_reference(z1, v0, lam0, M_q_pad, LB_pad, UB_pad,
                                    **kw)
    if z1.device.type == "cuda":
        return _launch(z1, v0, lam0, M_q_pad, LB_pad, UB_pad, lanes=lanes,
                       wide=wide, **kw)
    raise ValueError(f"fused_admm_solve takes CPU or CUDA tensors; got "
                     f"{z1.device}")


fused_admm_solve.launches = 0
fused_admm_solve.last_plan = None
