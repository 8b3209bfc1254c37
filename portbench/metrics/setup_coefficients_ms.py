"""setup_coefficients_ms: the program's ``is3d2::setup.coefficients``
span, inside the driver's per-surface ``_setup``: ``DeltafData``, the PTB
lambda scan (``compute_jonah_coefficients``) and
``compute_particle_densities``.  The mean over the window's surfaces."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, ("setup.coefficients",))
