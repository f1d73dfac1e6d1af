"""solves_per_s: lanes solved in the window over the window's seconds
(host clock), all the work and all the time of the window. In a
closed-loop cell a solve is one plant's step."""


def read(ctx):
    lanes = int(ctx.traffic["batch"]) * int(ctx.traffic.get("steps", 1))
    return len(ctx.records) * lanes / ctx.window_s if ctx.window_s else None
