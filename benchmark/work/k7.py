"""K7, the fused split ADMM kernel (csrc/fused_split.cu): the operations
and bytes one launch needs, counted from the problem's unpadded shapes
and each lane's own iterations, whatever the kernel's layout.

Operations: one product of the step's increment (over z and s, dim + n_s
entries) with the KKT map a lane-iteration, 2 FLOP for each structural
nonzero of the map (the s-s block of the problem's map has zeros). The
element-wise work and the cones' projections, O(dim + n_s) a
lane-iteration, are left out: the count is a floor.
Bytes: the inputs (aux1, zs0, lm0 [lanes, dim + n_s], the map, four
rows of bounds and scales) read once and the outputs (zs, lm, aux
[lanes, dim + n_s], k, e_flag, r_p, r_d [lanes]) written once, in
float32 and int32.
"""

from __future__ import annotations

import numpy as np

TRACE_NAME = "fused_split"
# the program's library of the kernel (its build record)
LIBRARY = "fused_split"


def launches() -> int:
    """The program's own count of K7 launches."""
    from spcies_tpu_torch.kernels.fused_split import fused_split_solve
    return fused_split_solve.launches


def nonzeros(problem) -> int:
    """Structural nonzeros of the problem's map, counted once."""
    if not hasattr(problem, "map_nonzeros"):
        P = np.abs(problem.P_q)
        problem.map_nonzeros = int(np.count_nonzero(P > 1e-12 * P.max()))
    return problem.map_nonzeros


def flops(problem, k) -> float:
    return 2.0 * nonzeros(problem) * float(np.sum(k, dtype=np.float64))


def nbytes(problem, lanes: int) -> float:
    cols = problem.dim + problem.n_s
    return 4.0 * (6 * lanes * cols + nonzeros(problem) + 4 * cols
                  + 4 * lanes)
