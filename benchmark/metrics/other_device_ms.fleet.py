"""other_device_ms.fleet: device time an episode outside K1 (the
adapter's first solves and padding, the rollout's shift and plant
update, the copies), from the profiler's trace; nothing without one or
outside a rollout cell."""


def read(ctx):
    if ctx.trace is None or ctx.driver_kind != "rollout":
        return None
    return (ctx.trace.device_ns - ctx.kernel_ns) / len(ctx.records) / 1e6
