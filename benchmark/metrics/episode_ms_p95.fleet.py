"""episode_ms_p95.fleet: the 95th percentile of the window's episodes,
each timed on the host clock from the closed_loop_rollout call to its
results on the host. The host sets a host-paced fleet's pace, so its
tail is a per-layer reading there; nothing outside a rollout cell."""

import numpy as np

from harness.drivers import latencies_ms


def read(ctx):
    if ctx.driver_kind != "rollout":
        return None
    return float(np.percentile(latencies_ms(ctx.records), 95))
