"""cf_launches_per_surface: device launches of Cooper-Frye kernels (the
kernels and their partial-sum adds) in the traced window, per surface."""

PATTERNS = (r"cooper_frye", r"add_partials")


def read(ctx):
    if ctx.trace is None or not ctx.trace.has_device:
        return None
    a, b = ctx.window_us
    return len(ctx.trace.kernels(PATTERNS, a, b)) / len(ctx.records)
