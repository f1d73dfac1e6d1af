"""update_ms: the mean of the program's own `update` phase
(res.sol["times_ms"], BatchedSolver.__call__'s input promotion and copy,
CUDA events) over the window's requests; nothing where the requests do
not pass through BatchedSolver.__call__."""

import numpy as np


def read(ctx):
    times = [r["times_ms"]["update"] for r in ctx.records
             if r.get("times_ms") and "update" in r["times_ms"]]
    return float(np.mean(times)) if times else None
