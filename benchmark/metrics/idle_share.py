"""idle_share: the share of the traced window in which no operation ran
on the device (1 - union of the device's busy intervals / window)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
