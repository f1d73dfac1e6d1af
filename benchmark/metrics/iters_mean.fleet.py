"""iters_mean.fleet: iters_mean (benchmark/metrics/iters_mean.py) read in a closed-loop fleet
cell, where it moves plant_steps_per_s."""

from harness.spec import load_module


def read(ctx):
    return load_module("metrics", "iters_mean").read(ctx)
