"""idle_share.fleet: idle_share (benchmark/metrics/idle_share.py) read in a closed-loop fleet
cell, where it moves plant_steps_per_s."""

from harness.spec import load_module


def read(ctx):
    return load_module("metrics", "idle_share").read(ctx)
