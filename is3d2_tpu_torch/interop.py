"""Build the port's engine state from dicts of numpy arrays.

Lets a caller hand the port exactly the state another implementation holds
(for instance the JAX package's CellArrays converted with ``np.asarray``),
so each stage can be compared in isolation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.cells import CellArrays
from .core.feqmod import FeqmodCellData
from .core.spectra import MomentumGridDevice, SpeciesArrays


def _tensors(d: dict, names, device) -> dict:
    return {n: torch.as_tensor(np.array(d[n], dtype=np.float64),
                               device=device) for n in names}


def cells_from_numpy(d: dict, device="cpu") -> CellArrays:
    """CellArrays from a dict holding (at least) every CellArrays field."""
    names = [f.name for f in dataclasses.fields(CellArrays)]
    return CellArrays(**_tensors(d, names, device))


def coeffs_from_numpy(d: dict, device="cpu") -> dict:
    """The df12 coefficient-column dict."""
    return _tensors(d, list(d), device)


def species_from_numpy(d: dict, device="cpu") -> SpeciesArrays:
    return SpeciesArrays(**_tensors(d, ("mass", "sign", "degeneracy",
                                        "baryon"), device))


def grid_from_numpy(d: dict, device="cpu") -> MomentumGridDevice:
    names = [f.name for f in dataclasses.fields(MomentumGridDevice)]
    return MomentumGridDevice(**_tensors(d, names, device))


def feqmod_from_numpy(d: dict, device="cpu") -> FeqmodCellData:
    """FeqmodCellData from a dict holding every field (``breaks_down`` as
    bool, the rest f64)."""
    names = [f.name for f in dataclasses.fields(FeqmodCellData)]
    out = _tensors(d, [n for n in names if n != "breaks_down"], device)
    out["breaks_down"] = torch.as_tensor(np.array(d["breaks_down"], dtype=bool),
                                         device=device)
    return FeqmodCellData(**out)


def famod_from_numpy(d: dict, device="cpu"):
    """FamodCellData from a dict holding every field (the three masks as
    bool, the rest f64)."""
    from .core.spectra_famod import FamodCellData
    masks = ("breaks_down", "pl_negative", "recon_failed")
    names = [f.name for f in dataclasses.fields(FamodCellData)]
    out = _tensors(d, [n for n in names if n not in masks], device)
    for n in masks:
        out[n] = torch.as_tensor(np.array(d[n], dtype=bool), device=device)
    return FamodCellData(**out)


def sampler_setup_from_numpy(d: dict, device="cpu"):
    """SamplerSetup from a dict of numpy values: ``cells`` and ``fq``
    (None or a dict) as above, ``df_cols`` a dict of columns,
    ``breaks_down`` bool, every other field an f64 column."""
    from .core.sampler import SamplerSetup
    names = [f.name for f in dataclasses.fields(SamplerSetup)]
    plain = [n for n in names
             if n not in ("cells", "fq", "df_cols", "breaks_down")]
    return SamplerSetup(
        cells=cells_from_numpy(d["cells"], device),
        fq=None if d["fq"] is None else feqmod_from_numpy(d["fq"], device),
        df_cols=_tensors(d["df_cols"], list(d["df_cols"]), device),
        breaks_down=torch.as_tensor(np.array(d["breaks_down"], dtype=bool),
                                    device=device),
        **_tensors(d, plain, device))


def copy_species_densities(src, dst) -> None:
    """Carry the cached densities of compute_particle_densities from one
    species table (any object with the three arrays) to the port's."""
    for name in ("equilibrium_density", "bulk_density", "diff_density"):
        setattr(dst, name, np.array(getattr(src, name), dtype=np.float64))
