"""is3d2_tpu_torch — the PyTorch/CUDA port of is3d2_tpu.

A second package beside the JAX package ``is3d2_tpu``, which stays the
reference.  The layout mirrors it so each module has a counterpart:

  - io/        numpy readers and writers (parameters, quadrature tables, PDG
               lists, surfaces of modes 0-7 and in memory, delta-f tables,
               result files) and the native I/O library (g++ at
               first use, ctypes);
  - physics/   per-cell physics on torch f64 tensors (spline, rest-frame
               algebra, delta-f coefficients, the VAH reconstruction);
  - core/      the Cooper-Frye engines (the torch f64 engines and the
               kernel routes), the spacetime distributions dN/dX, the
               Monte-Carlo hadron sampler and the spin polarization;
  - ops/       hand-written CUDA kernels for Hopper, their plain torch
               versions and the nvcc build;
  - parallel/  the engines, the sampler's events and an ensemble's
               surfaces sharded over the local devices (use_mesh);
  - tools/     delta-f table generator, the synthetic-workdir builder,
               the kernels' check and bench harnesses, and the JAX
               package's tools and campaign scripts: the df x corrections
               sweep, the modified-distribution matrix, the oversampling
               campaign, the post-run analysis and the particle presets
               (``python -m is3d2_tpu_torch.tools.<name>``).

The port covers operations 0 (dN/dX, df 1-4; like the reference, none
for df 5), 1 (continuous spectra, df 1-5) and 2 (the sampler, df 1-5),
in 2+1d and in 3+1d (dimension 3), on surfaces of modes 0-7 or handed
over in memory, with or without group_particles, single surfaces and
ensembles, and after any of them the thermal-vorticity spin polarization
of a mode-5 surface, in 2+1d and in 3+1d, with every use_pallas and
compute_dtype, on one device or sharded over the local devices
(use_mesh, parallel/).  Importing it never imports jax.
"""

from .constants import hbarC, two_pi, two_pi2_hbarC3, four_pi2_hbarC3  # noqa: F401
from .config import Config  # noqa: F401

__version__ = "0.1.0"

__all__ = ["hbarC", "two_pi", "two_pi2_hbarC3", "four_pi2_hbarC3", "Config"]
