"""step_mfu.fleet: step_mfu (benchmark/metrics/step_mfu.py) read in a closed-loop fleet
cell, where it moves plant_steps_per_s."""

from harness.spec import load_module


def read(ctx):
    return load_module("metrics", "step_mfu").read(ctx)
