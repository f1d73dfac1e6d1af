"""step_mfu: the whole request's share of the card's float32 peak: the
operations that every kernel launch of the traced window needs
(benchmark/work/<kernel>.py, from the problem's shapes and the lanes'
own k) over the traced window's seconds times the peak. It bounds every
kernel's roofline share from above on the requests' whole path."""


def read(ctx):
    if ctx.trace is None:
        return None
    flops = sum(f for f, _ in ctx.kernel_work())
    return 100.0 * flops / (ctx.trace.window_s * ctx.peaks["fp32_flops"])
