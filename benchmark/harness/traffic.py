"""The one traffic generator: it reads a traffic file
(benchmark/traffic/<mix>.json) and draws the run's pool of request
batches from the seed.

A traffic file holds only parameters:

    driver      "requests" (one BatchedSolver call a request) or
                "rollout" (one closed_loop_rollout call a request)
    batch       lanes a request
    pool        distinct batches made at set-up, cycled through in the
                window
    lanes_seed  the seed of the pool's lanes and of the batches they form,
                lanes in order: every run serves the same batches, so
                that every seed gets the same work
    steps       closed-loop steps an episode (rollout)
    warm_start  the rollout's warm start (rollout)
    x0          {"low": [...], "high": [...]}: each entry of the initial
                state uniform between the two
    ur          {"low": l, "high": h}: each input's set point uniform
                between the two; the state's set point xr is its steady
                state, (A - I) xr = -B ur
    readback    what the caller copies to the host after each request
"""

from __future__ import annotations

import numpy as np


def draw_pool(traffic: dict, A, B, seed: int):
    """The pool: a list of (x0, xr, ur) NumPy batches, the same for the
    same seed. The lanes, and the batches they form, lanes in order, are
    drawn from the traffic's `lanes_seed`; the run's seed orders the
    batches. How long a batch takes depends on which lanes share it and
    in what order (the slowest lane of a block or of a batch sets its
    time, and a refill queue starts the lanes in order), so the seed
    changes no batch."""
    rng = np.random.default_rng(int(traffic["lanes_seed"]))
    n, m = A.shape[0], B.shape[1]
    lo = np.asarray(traffic["x0"]["low"], float)
    hi = np.asarray(traffic["x0"]["high"], float)
    if lo.shape != (n,) or hi.shape != (n,):
        raise ValueError(f"the traffic's x0 ranges have {lo.size} entries; "
                         f"the plant has {n} states")
    steady = -np.linalg.solve(A - np.eye(n), B)       # xr = steady @ ur
    size, count = int(traffic["batch"]), int(traffic["pool"])
    x0 = rng.uniform(lo, hi, (size * count, n))
    ur = rng.uniform(traffic["ur"]["low"], traffic["ur"]["high"],
                     (size * count, m))
    xr = ur @ steady.T
    order = np.random.default_rng(int(seed)).permutation(count)
    # the caller holds float64 NumPy, as a controls user's code does
    return [tuple(a[p * size:(p + 1) * size] for a in (x0, xr, ur))
            for p in order]
