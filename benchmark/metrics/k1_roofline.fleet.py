"""k1_roofline.fleet: k1_roofline (benchmark/metrics/k1_roofline.py) read in a closed-loop fleet
cell, where it moves plant_steps_per_s."""

from harness.spec import load_module


def read(ctx):
    return load_module("metrics", "k1_roofline").read(ctx)
