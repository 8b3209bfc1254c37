"""setup_stage_ms: the driver's per-surface set-up (``_setup``: the PDG
list, the tables, the delta-f coefficients, the densities), from its
``stage_seconds["setup"]``, the mean over the window's surfaces."""


def read(ctx):
    v = [r.stages["setup"] for r in ctx.records if "setup" in r.stages]
    return 1e3 * sum(v) / len(v) if v else None
