"""request_ms_p95: the 95th percentile over all requests of the window,
each timed on the host clock from the call to its results on the host.
In a closed-loop cell a request is an episode."""

import numpy as np

from harness.drivers import latencies_ms


def read(ctx):
    return float(np.percentile(latencies_ms(ctx.records), 95))
