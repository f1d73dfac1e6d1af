"""iters_mean: the mean per-lane k the program returned over the
window's requests (every step of every episode in a closed-loop cell)."""

import numpy as np


def read(ctx):
    total, lanes = 0.0, 0
    for k in ctx.launch_ks():
        total += float(np.sum(k, dtype=np.float64))
        lanes += np.size(k)
    return total / lanes if lanes else None
