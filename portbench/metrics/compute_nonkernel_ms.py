"""compute_nonkernel_ms: the driver's ``stage_seconds["compute"]`` (which
ends in a synchronise) less the device time of the surface's Cooper-Frye
kernels, the mean over the window's surfaces: the per-cell physics, the
feqmod prep, the fold, the packs and the dispatch."""

PATTERNS = (r"cooper_frye", r"add_partials")


def read(ctx):
    v = []
    for r in ctx.records:
        k = ctx.kernel_s(r.index, PATTERNS)
        if k is None or "compute" not in r.stages:
            return None
        v.append(r.stages["compute"] - k)
    return 1e3 * sum(v) / len(v)
