"""rollout_host_ms.fleet: host clock from the closed_loop_rollout call to
its return, before the caller copies the episode to the host, averaged
over the window's episodes (the step loop reads nothing back from the
device, so this is the host's own time); nothing outside a rollout
cell."""

import numpy as np


def read(ctx):
    times = [r["host_ms"] for r in ctx.records if "host_ms" in r]
    return float(np.mean(times)) if times else None
