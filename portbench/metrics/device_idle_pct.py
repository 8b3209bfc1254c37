"""device_idle_pct: the share of the traced window (first surface's start
to last surface's end) in which no kernel, copy or memset ran on the
card, from the torch.profiler timeline."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.has_device:
        return None
    a, b = ctx.window_us
    return 100.0 * (1.0 - ctx.trace.busy_us(a, b) / (b - a))
