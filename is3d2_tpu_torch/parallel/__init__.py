"""The engines, the sampler and an ensemble sharded over the local devices
(counterpart of is3d2_tpu/parallel)."""

from .sharding import make_mesh, sharded_spectra

__all__ = ["make_mesh", "sharded_spectra"]
