"""k7_roofline: K7's share of its roofline over the traced window:
the least time the card needs for every K7 launch (the larger of its
operations over the float32 peak and its bytes over the HBM peak,
benchmark/work/k7.py) over K7's time in the device trace. Nothing in
a cell that K7 does not serve."""

WORK = "k7"


def read(ctx):
    if ctx.trace is None or ctx.config["kernel"] != WORK:
        return None
    fp, bw = ctx.peaks["fp32_flops"], ctx.peaks["hbm_bytes"]
    bound_s = sum(max(f / fp, b / bw) for f, b in ctx.kernel_work())
    return 100.0 * bound_s / (ctx.kernel_ns / 1e9)
