"""K1, the fused box-ADMM kernel (csrc/fused_admm.cu): the operations and
bytes one launch needs, counted from the problem's unpadded shapes and
each lane's own iterations, whatever the kernel's layout.

Operations: one product of the step's increment with the z-step map a
lane-iteration, 2 FLOP for each structural nonzero of the map (nz x nz,
dense for laxMPC). The element-wise work, O(nz) a lane-iteration, is
left out: the count is a floor.
Bytes: the inputs (z1, v0, lam0 [lanes, nz], the map, the two bounds)
read once and the outputs (z, v, lam [lanes, nz], k, e_flag, r_p, r_d
[lanes]) written once, in float32 and int32.
"""

from __future__ import annotations

import numpy as np

# the substring of the kernel's name in the device trace
TRACE_NAME = "fused_admm"
# the program's library of the kernel (its build record)
LIBRARY = "fused_admm"


def launches() -> int:
    """The program's own count of K1 launches."""
    from spcies_tpu_torch.kernels.fused_admm import fused_admm_solve
    return fused_admm_solve.launches


def nonzeros(problem) -> int:
    """Structural nonzeros of the problem's map, counted once."""
    if not hasattr(problem, "map_nonzeros"):
        P = np.abs(problem.P_q)
        problem.map_nonzeros = int(np.count_nonzero(P > 1e-12 * P.max()))
    return problem.map_nonzeros


def flops(problem, k) -> float:
    return 2.0 * nonzeros(problem) * float(np.sum(k, dtype=np.float64))


def nbytes(problem, lanes: int) -> float:
    nz = problem.nz
    return 4.0 * (6 * lanes * nz + nonzeros(problem) + 2 * nz + 4 * lanes)
