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
"""

from __future__ import annotations

from spcies_tpu_torch.kernels.fused_admm import (DRAIN_LANES, LANES,
                                                 RING_EXTRA, SMEM_MAX, SMS,
                                                 STAGES)

# shared memory of an H100 SM, and what each block resident on it reserves
SMEM_SM, SMEM_RESERVED = 233472, 1024
# up to this width each lanes a block has its own build; wider ones take
# WIDE_BUILD (rows a slab, blocks an SM)
NARROW = 320
WIDE_BUILD = (16, 1)


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
