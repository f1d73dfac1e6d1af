"""other_device_ms: device time a request (episode) outside the cell's
fused kernel: the adapter's padding, lane order and first solve, the
api's copies, the rollout's shift and plant update, the readback. From
the profiler's trace; nothing without one."""


def read(ctx):
    if ctx.trace is None:
        return None
    return (ctx.trace.device_ns - ctx.kernel_ns) / len(ctx.records) / 1e6
