"""setup_tables_ms: the program's ``is3d2::setup.tables`` span, inside
the driver's per-surface ``_setup``: the PDG list, the chosen list, the
Gauss and momentum tables and the delta-f tables.  The mean over the
window's surfaces."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, ("setup.tables",))
