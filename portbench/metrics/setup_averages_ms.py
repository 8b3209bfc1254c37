"""setup_averages_ms: the program's ``is3d2::setup.averages`` span, inside
the driver's per-surface ``_setup``: the surface-averaged thermodynamics
and their hand-off file.  The mean over the window's surfaces."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, ("setup.averages",))
