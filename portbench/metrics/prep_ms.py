"""prep_ms: the program's ``is3d2::prepare_cells``, ``is3d2::cell_physics``
and ``is3d2::pack`` spans inside compute (host padding and uploads, the
per-cell delta-f coefficients or the feqmod prep, the eta fold and the
kernel packs), summed, the mean over the window's surfaces."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, ("prepare_cells", "cell_physics",
                                       "pack"))
