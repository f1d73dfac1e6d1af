"""Fused three-block EADMM for MPCT: the wrapper of the hand-written CUDA
kernel (csrc/fused_eadmm.cu) and its plain PyTorch version.

Counterpart of spcies_tpu/kernels/fused_eadmm.py (`_fused_eadmm_kernel`).
Everything lives in one padded lane layout of Z columns, the z1/z3
decision layout (N+1)(n+m) padded to a multiple of COL_PAD: z2 is carried
in broadcast form z2b = z2 (x) 1_{N+1}, the duals of the middle constraint
rows as lm, and those of the head rows (lanes 0..n) and tail rows (the last
stage block's lanes) as lht. For each lane one iteration is

    s_ht = rht (mt z2b - x0b) + lht
    q1   = -(rm (z2b + z3) + lm) + (mh - mt) s_ht
    z1   = clip(-q1 h1i, lb, ub)
    v2m  = rm (z3 - z1) + lm ;  v2t = mt (rht (-z1) + lht)
    z2bn = z2acc + (v2m - v2m_p) @ C2m + (v2t - v2t_p) @ C2t
    q3   = rm (z2bn - z1) + lm
    z3n  = z3acc + (q3 - q3_p) @ M3p
    midR = z2bn + z3n - z1 ;  htR = mh z1 - x0b + mt (z2bn - z1)
    lm'  = lm + rm midR ;  lht' = lht + rht htR
    r_pf = max(max|midR mr|, max|htR|), r_z2 = max|(z2bn - z2b) mr|,
    r_z3 = max|(z3n - z3) mr|

with the three products in delta form against the previous inputs
(v2m_p, v2t_p, q3_p) and the accumulators (z2acc, z3acc), which start at
(z2refb, 0) with zero previous inputs, so the first iteration computes the
full products under a warm start too. A lane exits when all three
residuals are <= tol. Modes:

  checked     check_every=1: exit tests every iteration; a converged lane
              freezes all its carries, and its residuals are those at exit.
  free-run    check_every=C>1: C-1 plain iterations, then one tested
              iteration; k is recorded at check granularity, converged
              lanes keep iterating until their tile drains, and a done
              lane's residuals stay at its exit.
  exact-k     check_every=C>1, exact_k: free-run windows with a snapshot
              of each active lane's nine in-loop leaves at the window
              start, then a per-iteration replay of each lane's last window
              with the checked semantics (budget min(C, k_max - kws)) — the
              checked mode's k, e_flag and iterates at free-run speed.

Padding contract: the columns beyond the layout carry zero rows and columns
in C2m, C2t and M3p, zero rm, rht, mh, mt, mr and h1i and [0, 0] bounds, so
they stay exactly 0 and never enter a residual. The batch is padded to a
multiple of tile_b by the caller.

`fused_eadmm_solve` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; `fused_eadmm_solve.launches` counts the launches
and `fused_eadmm_solve.last_plan` holds the last launch's build and
geometry.

The kernel runs M3p's product on the product stage csrc/tile_product.cuh,
built for 8 and 16 lanes a block (32 do not fit shared memory;
kernels/stage.py plans the launch, with no refill: every mode keeps a block
of L lanes, and plain free-run freezes each group of 8 lanes once its lanes
are done, as a tile of tile_b = 8 drains). The z2 product runs over the
distinct columns of C2m and C2t (`distinct_columns`): columns that are
equal in both matrices, byte for byte, give the same fmaf chain, so the
kernel computes one chain a class and lane and gives the bits of the
one-column-per-thread parent (csrc/variants/fused_eadmm_parent.cu). Every
build gives the same bits, so `lanes=` of `fused_eadmm_solve` may name
another build, for a check or a timing.

Past MAX_COLS columns, up to WIDE_COLS, the wide build
(fused_eadmm_wide_kernel, csrc/wide_cols.cuh) runs 512 threads of two
columns, t and t + 512, at 8 lanes a block, no refill, with its nine state
vectors in global memory and C2d in shared memory (so it too refuses
classes of columns that do not fit); `wide=` of `fused_eadmm_solve` names
it at any width, for a check of bits.
"""

from __future__ import annotations

import ctypes

import torch

from spcies_tpu_torch.kernels import stage
from spcies_tpu_torch.kernels.fused_admm import (COL_PAD, DQ_PAD, MAX_COLS,
                                                 RBIG, SMEM_MAX, WIDE_COLS,
                                                 check_widths, round_up)

__all__ = ["check_width", "COL_PAD", "MAX_COLS", "round_up",
           "distinct_columns", "fused_eadmm_reference", "fused_eadmm_solve",
           "launch_geometry", "launch_plan", "narrow_operands", "shared_bytes"]

# C signature of fused_eadmm_launch: 30 pointers (18 inputs: the six tiles,
# C2m's and C2t's representative columns, the class of each column, M3p and
# the eight rows; 10 outputs; the exact-k snapshot scratch; int32 scratch
# for clock counts); B, Z, nd, lanes, blocks, threads, shared bytes; tol;
# k_max, check_every, exact_k; the stream
FUSED_EADMM_ARGTYPES = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 7
                        + [ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
# and of fused_eadmm_wide_launch: 30 pointers (the clock counts' place holds
# the blocks' global state); B, Z, nd, blocks, threads, shared bytes; tol;
# k_max, check_every, exact_k; the stream
FUSED_EADMM_WIDE_ARGTYPES = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 6
                             + [ctypes.c_float] + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
# lanes a block -> (rows a slab of M3p's ring, blocks an SM) of its build
# (Build<L> in csrc/fused_eadmm.cu; the blocks an SM up to NARROW columns)
BUILDS = {8: (8, 2), 16: (16, 1)}
# lanes a block -> whether its build copies C2d to shared memory for the z2
# chains (EA_STAGE_C2D_<L> in the source: not at 8 lanes, whose two blocks
# an SM have no room for it)
C2D_STAGED = {8: False, 16: True}
# rows a slab reckoned for a number of lanes no build has: the smallest ring
# the 16-lane build would take
SLAB_ROWS_OTHER = 16
# up to this width each lanes a block has its build of BUILDS (NARROW in
# the source); wider, one block of up to MAX_COLS threads an SM
NARROW = 256
WARP = 32
# the state vectors a block keeps as [Z][lanes]: z2b, z3, lm, lht, the three
# previous product inputs, z1 and x0b
STATE_LEAVES = 9
# the leaves an exact-k snapshot saves per lane in the kernel: z2b, z3, lm,
# lht and the three previous product inputs (the accumulators equal z2b and
# z3 after the first iteration, which the kernel marks instead)
SNAP_LEAVES = 7
# plain version: read "all lanes done" on the host every this many
# iterations of the checked loop (extra iterations of frozen lanes are
# exact no-ops)
_SYNC_EVERY = 8


def _sel(mask, new, old):
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


class _Ops:
    """One iteration in the kernel's operation order, over padded
    operators."""

    def __init__(self, x0b, C2m, C2t, M3p, rm, rht, mh, mt, mr, h1i, lb,
                 ub):
        self.x0b, self.C2m, self.C2t, self.M3p = x0b, C2m, C2t, M3p
        self.rm, self.rht, self.mh, self.mt, self.mr, self.h1i, self.lb, \
            self.ub = (r.reshape(1, -1) for r in (rm, rht, mh, mt, mr, h1i,
                                                  lb, ub))
        self.sign_ht = self.mh - self.mt

    def iterate(self, z2b, z3, lm, lht, z2acc, z3acc, v2m_p, v2t_p, q3_p):
        """One EADMM iteration (code_MPCT_EADMM_C.c:85-459 phase order).
        Returns (z1, the nine new leaves, (r_pf, r_z2, r_z3))."""
        rm, rht, mh, mt, mr = self.rm, self.rht, self.mh, self.mt, self.mr
        x0b = self.x0b
        # P1: q1 = A1'(rho.*rows(0, z2, z3, x0) + lam); clipped diag solve
        s_ht = rht * (mt * z2b - x0b) + lht
        q1 = -(rm * (z2b + z3) + lm) + self.sign_ht * s_ht
        z1 = torch.minimum(torch.maximum(-q1 * self.h1i, self.lb), self.ub)
        # P2: z2 = W2 (q2_ref + A2'(rho.*rows(z1, 0, z3, 0) + lam)) in
        # broadcast form through the folded C2m/C2t
        v2m = rm * (z3 - z1) + lm
        v2t = mt * (rht * (-z1) + lht)
        z2bn = z2acc + (v2m - v2m_p) @ self.C2m + (v2t - v2t_p) @ self.C2t
        # P3: z3 = M3 (A3'(rho.*rows(z1, z2n, 0, 0) + lam)), mid rows only
        q3 = rm * (z2bn - z1) + lm
        z3n = z3acc + (q3 - q3_p) @ self.M3p
        # residual rows and dual ascent
        midR = z2bn + z3n - z1
        htR = mh * z1 - x0b + mt * (z2bn - z1)
        lm_n = lm + rm * midR
        lht_n = lht + rht * htR
        r_pf = torch.maximum(torch.amax(torch.abs(midR * mr), dim=1),
                             torch.amax(torch.abs(htR), dim=1))
        r_z2 = torch.amax(torch.abs((z2bn - z2b) * mr), dim=1)
        r_z3 = torch.amax(torch.abs((z3n - z3) * mr), dim=1)
        return (z1, (z2bn, z3n, lm_n, lht_n, z2bn, z3n, v2m, v2t, q3),
                (r_pf, r_z2, r_z3))


def _conv(r, tol):
    return (r[0] <= tol) & (r[1] <= tol) & (r[2] <= tol)


def fused_eadmm_reference(x0b, z2refb, z2b0, z30, lm0, lht0, C2m, C2t, M3p,
                          rm_row, rht_row, mh_row, mt_row, mr_row, h1i_row,
                          lb_row, ub_row, *, tol: float, k_max: int,
                          tile_b: int = 256, check_every: int = 1,
                          exact_k: bool = False):
    """Plain PyTorch version of the fused kernel, for any float dtype and
    device. Same arguments and returns as `fused_eadmm_solve`."""
    B = x0b.shape[0]
    dt, dev = x0b.dtype, x0b.device
    ops = _Ops(x0b, C2m, C2t, M3p, rm_row, rht_row, mh_row, mt_row, mr_row,
               h1i_row, lb_row, ub_row)
    C = int(check_every)
    zero = torch.zeros_like(x0b)
    rbig = torch.full((B,), RBIG, dtype=dt, device=dev)
    st = (z2b0, z30, lm0, lht0, z2refb, zero, zero, zero, zero)
    z1 = zero
    r = (rbig, rbig, rbig)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)

    if C > 1 and exact_k:
        sn = st
        kws = torch.zeros_like(k)
        it = 0
        while it < k_max and not bool(done.all()):
            a = torch.logical_not(done)
            sn = tuple(_sel(a, x, s) for x, s in zip(st, sn))
            kws = torch.where(a, it, kws)
            # windows may overshoot k_max: the replay budget cuts each
            # lane off at exactly k_max
            for _ in range(C - 1):
                _, st, _ = ops.iterate(*st)
            _, st, rw = ops.iterate(*st)
            done = torch.logical_or(done, a & _conv(rw, tol))
            it += C
        # replay each lane's last window with per-iteration checks
        budget = torch.clamp(k_max - kws, max=C)
        convd = torch.zeros_like(done)
        k = kws
        st = sn
        for j in range(C):
            act = torch.logical_not(convd) & (j < budget)
            z1n, new, rn = ops.iterate(*st)
            st = tuple(_sel(act, x, s) for x, s in zip(new, st))
            z1 = _sel(act, z1n, z1)
            r = tuple(torch.where(act, x, s) for x, s in zip(rn, r))
            k = k + act.to(torch.int32)
            convd = torch.logical_or(convd, act & _conv(rn, tol))
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
                _, new, _ = ops.iterate(*st)
                st = tuple(_sel(ta, x, s) for x, s in zip(new, st))
            z1n, new, rn = ops.iterate(*st)
            st = tuple(_sel(ta, x, s) for x, s in zip(new, st))
            z1 = _sel(ta, z1n, z1)
            a = torch.logical_not(done)
            k = k + a.to(torch.int32) * (n_fast + 1)
            r = tuple(torch.where(a, x, s) for x, s in zip(rn, r))
            done = torch.logical_or(done, a & _conv(rn, tol))
            it += n_fast + 1
    else:
        for it in range(k_max):
            if it % _SYNC_EVERY == 0 and bool(done.all()):
                break
            z1n, new, rn = ops.iterate(*st)
            a = torch.logical_not(done)
            st = tuple(_sel(a, x, s) for x, s in zip(new, st))
            z1 = _sel(a, z1n, z1)
            r = tuple(torch.where(a, x, s) for x, s in zip(rn, r))
            k = k + a.to(torch.int32)
            done = torch.logical_or(done, a & _conv(rn, tol))
    e_flag = torch.where(done, 1, -1).to(torch.int32)
    return (z1, st[0], st[1], st[2], st[3], k, e_flag) + r


def distinct_columns(C2m, C2t):
    """The classes of the columns of the stacked [C2m; C2t] that are equal
    byte for byte, on the matrices' device. Returns (reps, col_of): reps
    [nd] int64, the first column of each class in ascending order, and
    col_of [Z] int32, the class of each column. A column is a copy only if
    it is one in both matrices; +0.0 and -0.0 are told apart."""
    Z = C2m.shape[1]
    cols = torch.cat([C2m, C2t]).T.contiguous()
    key = cols.view(torch.int32) if cols.dtype == torch.float32 else \
        cols.view(torch.int64)
    _, inverse = torch.unique(key, dim=0, return_inverse=True)
    nd = int(inverse.max()) + 1
    first = torch.full((nd,), Z, dtype=torch.int64, device=cols.device)
    first.scatter_reduce_(0, inverse, torch.arange(Z, device=cols.device),
                          reduce="amin")
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(nd, device=cols.device)
    return first[order], rank[inverse].to(torch.int32)


def narrow_operands(C2m, C2t):
    """The z2 product's operands as the kernel takes them: (C2d, C2td,
    col_of), C2d = C2m[:, reps] and C2td = C2t[:, reps] ([Z, nd],
    contiguous) over `distinct_columns`' classes."""
    reps, col_of = distinct_columns(C2m, C2t)
    return (C2m[:, reps].contiguous(), C2t[:, reps].contiguous(), col_of)


def shared_bytes(Z: int, lanes: int, nd: int = 1, wide: bool = False) -> int:
    """Dynamic shared bytes of a block (fused_eadmm_smem in the source) at
    nd classes of columns: the ring of M3p's slabs, the nine state vectors
    as [Z][lanes], dv2m/dq3 with its padding, dv2t, the chains' results,
    C2d's copy where the build makes one (C2D_STAGED), the row maxima, the
    masks, the window starts, the slots' lanes and the row bounds. A number
    of lanes no build has is reckoned with SLAB_ROWS_OTHER rows a slab and
    a copy of C2d. The wide build's (fused_eadmm_wide_smem): dv2m, dv2t
    and dq3 as [Z][8], the warps' row maxima and C2d as [Z][nd]."""
    if wide:
        return 4 * (3 * Z * stage.WIDE_LANES
                    + 3 * stage.WIDE_WARPS * stage.WIDE_LANES + Z * nd)
    slab = BUILDS.get(lanes, (SLAB_ROWS_OTHER, 1))[0]
    D = lanes + DQ_PAD
    return stage.ring_bytes(Z, slab) + 4 * (
        STATE_LEAVES * Z * lanes + Z * D + Z * lanes + 2 * nd * D
        + (Z * nd if C2D_STAGED.get(lanes, True) else 0)
        + Z // WARP * lanes + Z + 4 + 2 * lanes + 4)


def check_width(Z: int, nd: int = 1) -> None:
    """Raise ValueError unless some build of the kernel takes this padded
    width at nd classes of columns (a plain check, no CUDA: the fused
    builder calls it when it builds for the card): up to MAX_COLS columns
    the narrow builds, past it the wide build."""
    kernel = "fused MPCT-EADMM kernel (K3, csrc/fused_eadmm.cu)"
    check_widths(kernel, WIDE_COLS, width=Z)
    need = (shared_bytes(Z, 8, nd, wide=True) if Z > MAX_COLS else
            min(shared_bytes(Z, L, nd) for L in BUILDS))
    if need > SMEM_MAX:
        raise ValueError(
            f"no build of the {kernel} fits padded width {Z} with {nd} "
            f"classes of columns in {SMEM_MAX} bytes of shared memory: use "
            f'backend="dense"')


def launch_plan(B: int, Z: int, nd: int, *, tile_b: int, check_every: int,
                exact_k: bool, k_max: int, lanes: int | None = None,
                wide: bool | None = None):
    """The build a launch takes and its geometry, as a dict: lanes a block,
    blocks, threads, dynamic shared bytes, refill (always False; and
    wide=True for the wide build). nd is the number of classes of columns.
    `lanes` names a build (a key of BUILDS) in place of the dispatch's
    choice, `wide` the wide build or not (by default: past MAX_COLS
    columns); raises ValueError on a shape or mode no build takes."""
    check_width(Z, nd)
    if not 0 < nd <= Z:
        raise ValueError(f"the classes of columns number 1 to {Z}; got {nd}")
    if k_max < 1:
        raise ValueError(f"k_max must be at least 1; got {k_max}")
    stage.check_mode(B, tile_b=tile_b, check_every=check_every,
                     exact_k=exact_k)
    if stage.use_wide(Z, wide):
        return stage.wide_plan(B, shared_bytes(Z, 8, nd, wide=True), lanes)
    return stage.plan(B, Z, lambda L: shared_bytes(Z, L, nd), BUILDS,
                      refill=False, lanes=lanes)


def launch_geometry(B: int, Z: int, nd: int, **kw):
    """(blocks, threads, dynamic shared bytes) of a kernel launch; the
    arguments of `launch_plan`."""
    plan = launch_plan(B, Z, nd, **kw)
    return plan["blocks"], plan["threads"], plan["smem"]


def _launch(*args, tol, k_max, tile_b, check_every, exact_k, classes=None,
            lanes=None, wide=None):
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel takes float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    B, Z = args[0].shape
    C2d, C2td, col_of = (narrow_operands(args[6], args[7]) if classes is None
                         else classes)
    nd = C2d.shape[1]
    if (C2d.shape != (Z, nd) or C2td.shape != (Z, nd)
            or col_of.shape != (Z,) or col_of.dtype != torch.int32
            or C2d.dtype != torch.float32 or C2td.dtype != torch.float32
            or not (C2d.is_contiguous() and C2td.is_contiguous())):
        raise ValueError("classes are (C2d, C2td, col_of) as "
                         "narrow_operands gives them")
    plan = launch_plan(B, Z, nd, tile_b=tile_b, check_every=check_every,
                       exact_k=exact_k, k_max=k_max, lanes=lanes, wide=wide)
    from spcies_tpu_torch.kernels._build import load_kernel
    wide = plan.get("wide", False)
    launch = (load_kernel("fused_eadmm", "fused_eadmm_wide_launch",
                          FUSED_EADMM_WIDE_ARGTYPES) if wide else
              load_kernel("fused_eadmm", "fused_eadmm_launch",
                          FUSED_EADMM_ARGTYPES))
    dev = args[0].device
    outs = tuple(torch.empty_like(args[0]) for _ in range(5))
    k, done = (torch.empty((B,), dtype=torch.int32, device=dev)
               for _ in range(2))
    res = tuple(torch.empty((B,), dtype=torch.float32, device=dev)
                for _ in range(3))
    exact = check_every > 1 and exact_k
    snap = torch.empty((B if exact else 0, SNAP_LEAVES * Z),
                       dtype=torch.float32, device=dev)
    # each block's kilo-clocks of P1, of the z2 chains, of P2, and of P3
    # and the keepers (in a build with TP_CLOCKS; else zeros); the wide
    # build: the blocks' state, nine leaves
    nb = plan["blocks"]
    ext = (torch.empty((B * STATE_LEAVES * Z,), dtype=torch.float32,
                       device=dev) if wide else
           torch.zeros((4 * nb,), dtype=torch.int32, device=dev))
    ins = args[:6] + (C2d, C2td, col_of) + args[8:]
    ptrs = [t.data_ptr() for t in ins + outs + (k, done) + res + (snap, ext)]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("the fused kernel takes 16-byte aligned tensors")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build = ([] if wide else [plan["lanes"]]) + [plan["blocks"],
                                                 plan["threads"],
                                                 plan["smem"]]
    with torch.cuda.device(dev):
        err = launch(
            *ptrs, B, Z, nd, *build, float(tol), int(k_max),
            int(check_every), int(bool(exact_k)), stream)
    if err != 0:
        raise RuntimeError(f"fused_eadmm kernel launch failed with CUDA "
                           f"error {err} ({plan})")
    fused_eadmm_solve.launches += 1
    fused_eadmm_solve.last_plan = (
        dict(plan, nd=nd) if wide else
        dict(plan, nd=nd, block_clocks=ext.view(nb, 4)))
    e_flag = torch.where(done == 1, 1, -1).to(torch.int32)
    return outs + (k, e_flag) + res


def fused_eadmm_solve(x0b, z2refb, z2b0, z30, lm0, lht0, C2m, C2t, M3p,
                      rm_row, rht_row, mh_row, mt_row, mr_row, h1i_row,
                      lb_row, ub_row, *, tol: float, k_max: int,
                      tile_b: int = 256, check_every: int = 1,
                      exact_k: bool = False, classes=None,
                      lanes: int | None = None, wide: bool | None = None):
    """Run the fused EADMM loop: six [B, Z] tiles, three [Z, Z] matrices
    and eight rows of Z entries (padded as the module docstring says; B a
    multiple of tile_b). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise. `classes` is `narrow_operands(C2m, C2t)`,
    computed once per operator by a caller that launches many times (the
    launch computes it when left out); `lanes` names the build to launch (a
    key of BUILDS) in place of the dispatch's choice, `wide` the wide build
    or not (by default: past MAX_COLS columns). The results depend on none
    of these, and the plain version takes none.

    Returns (z1, z2b, z3, lm, lht [B, Z], k [B] int32, e_flag [B] int32
    (1 converged / -1 k_max reached), r_pf, r_z2, r_z3 [B]).
    """
    args = (x0b, z2refb, z2b0, z30, lm0, lht0, C2m, C2t, M3p, rm_row,
            rht_row, mh_row, mt_row, mr_row, h1i_row, lb_row, ub_row)
    B, Z = x0b.shape
    if any(t.shape != (B, Z) for t in args[1:6]):
        raise ValueError(f"the six tiles must share one shape [B, Z]; got "
                         f"{[tuple(t.shape) for t in args[:6]]}")
    if any(t.shape != (Z, Z) for t in args[6:9]):
        raise ValueError(f"C2m, C2t and M3p must be [{Z}, {Z}]")
    if any(t.numel() != Z for t in args[9:]):
        raise ValueError(f"the eight rows hold {Z} entries each")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device; got {devices}")
    kw = dict(tol=tol, k_max=k_max, tile_b=tile_b, check_every=check_every,
              exact_k=exact_k)
    if x0b.device.type == "cpu":
        return fused_eadmm_reference(*args, **kw)
    if x0b.device.type == "cuda":
        return _launch(*args, classes=classes, lanes=lanes, wide=wide, **kw)
    raise ValueError(f"fused_eadmm_solve takes CPU or CUDA tensors; got "
                     f"{x0b.device}")


fused_eadmm_solve.launches = 0
fused_eadmm_solve.last_plan = None
