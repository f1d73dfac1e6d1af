"""plant_steps_per_s: a closed-loop fleet's plant steps (one solve and
one plant update a plant) in the window over the window's seconds (host
clock), all the work and all the time of the window. It is
solves_per_s's reading (benchmark/metrics/solves_per_s.py) under a name
of its own: a host-paced fleet's rate spreads with the host's speed, and
a bound of its own keeps that spread out of the other cells' bound."""

from harness.spec import load_module


def read(ctx):
    return load_module("metrics", "solves_per_s").read(ctx)
