"""idle_unnamed_pct: the share of the traced window's device-idle time
that no program span other than ``is3d2::particlization`` covers: host
time in no named stage while the card waits.  It checks the program's
instrumentation, which the other span metrics rest on."""

from portbench.harness import program_spans


def read(ctx):
    t = ctx.trace
    if t is None or not t.has_device:
        return None
    named = program_spans.named(t)
    if not named:
        return None
    gaps = t.gaps(*ctx.window_us)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0.0:
        return 0.0
    return 100.0 * (1.0 - program_spans.covered_us(gaps, named) / idle)
