"""Launch geometry of the kernels that run on the product stage
csrc/tile_product.cuh with a build for each lanes a block: K2
(kernels/fused_fista.py, no refill), K3 (kernels/fused_eadmm.py, no
refill), K4 (kernels/fused_ellip.py), K5
(kernels/fused_soc.py) and K6 (kernels/fused_hmpc.py).

Each kernel is built for 8, 16 and 32 lanes a block (LANES; K3,
kernels/fused_eadmm.py, for 8 and 16: a build is a key of `builds`), and up to
NARROW columns each of those has a build of its own (`builds`: lanes -> rows
a slab of the matrix, blocks an SM it is compiled for); wider shapes take one
block an SM with 16-row slabs, and no 32-lane build. With refill (every mode
but exact-k) the blocks are persistent, about the SMs times the blocks an SM,
and take groups of 8 lanes from a queue, so the batch need only be whole
groups; exact-k runs one block per L lanes. `pick_lanes` takes the widest
build that fits the 232,448 bytes of shared memory a block can have and
still gives half of the SMs a block, as kernels/fused_admm.py `pick_lanes`
does.

Past MAX_COLS columns each of K2-K7 runs its wide build
(csrc/wide_cols.cuh): WIDE_LANES lanes a block on WIDE_THREADS threads of
two columns each, up to WIDE_COLS columns, one block per WIDE_LANES lanes,
no refill (`use_wide`, `wide_plan`). A wide build also takes the narrow
widths when it is named (`wide=True`), for a check of bits.
"""

from __future__ import annotations

from spcies_tpu_torch.kernels.fused_admm import (DRAIN_LANES, LANES,
                                                 MAX_COLS, RING_EXTRA,
                                                 SMEM_MAX, SMS, STAGES,
                                                 WIDE_THREADS)

# shared memory of an H100 SM, and what each block resident on it reserves
SMEM_SM, SMEM_RESERVED = 233472, 1024
# up to this width each lanes a block has its own build; wider ones take
# WIDE_BUILD (rows a slab, blocks an SM)
NARROW = 320
WIDE_BUILD = (16, 1)
# the wide builds of K2-K7: lanes a block (one group of 8, which plain
# free-run drains), and warps a block
WIDE_LANES = DRAIN_LANES
WIDE_WARPS = WIDE_THREADS // 32


def ring_bytes(P: int, slab: int) -> int:
    """Bytes of the ring of slabs of a matrix with P columns, and its
    mbarriers (tp::ring_bytes)."""
    return 4 * STAGES * slab * P + RING_EXTRA


def build_of(builds: dict, width: int, lanes: int) -> tuple[int, int]:
    """(rows a slab, blocks an SM) of the build that runs `width` threads at
    `lanes` lanes a block."""
    return builds[lanes] if width <= NARROW else WIDE_BUILD


def check_mode(B: int, *, tile_b: int, check_every: int, exact_k: bool):
    """Raise ValueError on a tile or mode the kernels do not take."""
    if tile_b % DRAIN_LANES:
        raise ValueError(f"tile_b must be a multiple of {DRAIN_LANES}; "
                         f"got {tile_b}")
    if B % tile_b:
        raise ValueError(f"batch {B} is not a multiple of tile_b {tile_b}")
    if check_every > 1 and not exact_k and tile_b != DRAIN_LANES:
        # in plain free-run the output iterates depend on when a lane's
        # tile drains, and the kernels drain per group of DRAIN_LANES lanes
        raise ValueError(
            f"plain free-run (check_every > 1 without exact_k) takes "
            f"tile_b={DRAIN_LANES} on the GPU; got {tile_b}")


def _takes(B, width, smem_of, lanes, refill):
    """Whether the build of `lanes` lanes a block takes the launch."""
    return (smem_of(lanes) <= SMEM_MAX and (lanes < 32 or width <= NARROW)
            and (refill or B % lanes == 0))


def _blocks(B, width, smem_of, builds, lanes, refill):
    """Blocks of a launch: with refill about the SMs times the blocks an SM
    the build fits, never more than the groups fill; else one per L
    lanes."""
    if not refill:
        return B // lanes
    per_sm = min(build_of(builds, width, lanes)[1],
                 SMEM_SM // (smem_of(lanes) + SMEM_RESERVED))
    groups, slots = B // DRAIN_LANES, lanes // DRAIN_LANES
    return max(1, min(-(-groups // slots), SMS * max(1, per_sm)))


def pick_lanes(B: int, width: int, smem_of, builds: dict, *,
               refill: bool) -> int:
    """The widest build that takes the launch and still gives half of the
    SMs a block; the narrowest that takes it when none does."""
    fits = [L for L in LANES
            if L in builds and _takes(B, width, smem_of, L, refill)]
    if not fits:
        raise ValueError(f"no build of the kernel takes batch {B} at width "
                         f"{width}")
    return next((L for L in fits
                 if _blocks(B, width, smem_of, builds, L, refill) >= SMS // 2),
                fits[-1])


def plan(B: int, width: int, smem_of, builds: dict, *, refill: bool,
         lanes: int | None = None) -> dict:
    """The build a launch of B lanes (whole groups of DRAIN_LANES) on
    `width` threads takes, as a dict: lanes a block, blocks, threads,
    dynamic shared bytes (`smem_of(lanes)`), refill. `lanes` names a build
    in place of `pick_lanes`' choice; raises ValueError when no build takes
    the shape."""
    if lanes is None:
        lanes = pick_lanes(B, width, smem_of, builds, refill=refill)
    elif (lanes not in LANES or lanes not in builds
          or not _takes(B, width, smem_of, lanes, refill)):
        raise ValueError(f"no build of the kernel takes {lanes} lanes a "
                         f"block at batch {B}, width {width}")
    return dict(lanes=lanes,
                blocks=_blocks(B, width, smem_of, builds, lanes, refill),
                threads=width, smem=smem_of(lanes), refill=refill)


def use_wide(width: int, wide: bool | None) -> bool:
    """Whether a launch at this padded width (the wider of a kernel's
    widths) takes the wide build: `wide` names it or not; by default, past
    MAX_COLS columns alone. Raises ValueError where a build of one thread a
    column is named past MAX_COLS."""
    if wide is None:
        return width > MAX_COLS
    if not wide and width > MAX_COLS:
        raise ValueError(f"a build of one thread a column takes up to "
                         f"{MAX_COLS} columns; got {width}")
    return bool(wide)


def wide_plan(B: int, smem: int, lanes: int | None = None) -> dict:
    """The launch of a wide build (up to WIDE_COLS columns, checked by the
    kernel's `check_width`) of B lanes, whole groups of WIDE_LANES, with
    `smem` dynamic shared bytes: one block per WIDE_LANES lanes of
    WIDE_THREADS threads, no refill. Raises ValueError where `lanes` names
    another build or the block does not fit shared memory."""
    if lanes not in (None, WIDE_LANES):
        raise ValueError(f"the wide build runs {WIDE_LANES} lanes a block; "
                         f"got lanes={lanes}")
    if B % WIDE_LANES:
        raise ValueError(f"batch {B} is not whole groups of {WIDE_LANES}")
    if smem > SMEM_MAX:
        raise ValueError(f"the wide build's block needs {smem} bytes of "
                         f"shared memory, past {SMEM_MAX}")
    return dict(lanes=WIDE_LANES, blocks=B // WIDE_LANES,
                threads=WIDE_THREADS, smem=smem, refill=False, wide=True)
