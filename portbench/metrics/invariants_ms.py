"""invariants_ms: the program's ``is3d2::invariants`` span (the driver's
``check_invariants`` between set-up and compute, f64 host work while the
card waits), the mean over the window's surfaces."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, ("invariants",))
