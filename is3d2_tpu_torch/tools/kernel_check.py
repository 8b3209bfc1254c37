"""Check the compensated kernel against its plain version and the f64 engine.

One harness for ``chip_smoke.py`` and ``tests/test_torch_gpu.py``: the df 1/2
engines' state for a surface, the cases every check covers (df 1/2 with the
clip, outflow and diffusion branches) and the relative error on bins
>= FLOOR of each species' peak.  On a CPU device ``cooper_frye_comp`` is
the plain version, so there only the comparison with the f64 engine says
something.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..core.spectra import PREFACTOR, df12_state, spectra_df12
from ..driver import IS3D
from ..ops import cooper_frye_comp as ck
from ..ops.spectra_fast_common import CompOperands, comp_operands
from .synthetic import make_surface

TOL = 1e-6     # relative, on bins >= FLOOR of their species' peak
FLOOR = 1e-4

# name -> (config fields, make_surface options); the workdir needs
# include_baryon=True for the diffusion cases
CASES = {
    "df1": ({"df_mode": 1}, {}),
    "df2": ({"df_mode": 2}, {}),
    "df1-clip-outflow": ({"df_mode": 1, "regulate_deltaf": 1, "outflow": 1},
                         {"shear_scale": 0.03}),
    "df2-clip-outflow": ({"df_mode": 2, "regulate_deltaf": 1, "outflow": 1},
                         {"shear_scale": 0.03}),
    "df1-baryon-diffusion": ({"df_mode": 1, "include_baryon": 1,
                              "include_baryondiff_deltaf": 1},
                             {"include_baryon": True}),
    "df2-baryon-diffusion": ({"df_mode": 2, "include_baryon": 1,
                              "include_baryondiff_deltaf": 1},
                             {"include_baryon": True}),
}


def max_rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    """Max |out - ref| / |ref| over bins >= FLOOR of their row's peak; rows
    are species."""
    out = np.asarray(out).reshape(ref.shape[0], -1)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    peak = np.abs(ref).max(axis=1, keepdims=True)
    sig = np.abs(ref) >= FLOOR * peak
    return float((np.abs(out - ref)[sig] / np.abs(ref)[sig]).max())


def engine_state(workdir: str | Path, cfg: Config, surf, device):
    """The df 1/2 engines' inputs for ``surf`` with the workdir's tables."""
    run = IS3D(workdir, cfg=cfg, device=device)
    run.surface = surf
    run._setup()
    return df12_state(surf, run.species, run.chosen_idx, run.grids,
                      run.df_data, cfg, device)


def kernel_args(ops: CompOperands, cfg: Config) -> tuple:
    return ops.cell, ops.qm, ops.eta, ops.eta_w, ops.mom, cfg


def spectra_units(state, flat: torch.Tensor) -> np.ndarray:
    """The kernel's (M,) partials as (S, M / S) spectra on the host."""
    species = state[2]
    scale = PREFACTOR * species.degeneracy[:, None]
    return (scale * flat.reshape(species.mass.shape[0], -1)).cpu().numpy()


@dataclasses.dataclass
class CaseResult:
    kernel: np.ndarray    # (S, M / S) spectra
    plain: np.ndarray
    f64: np.ndarray
    launches: int         # kernel launches of the checked call
    repeats: bool         # a second call gave the same bits

    @property
    def vs_plain(self) -> float:
        return max_rel_err(self.kernel, self.plain)

    @property
    def vs_f64(self) -> float:
        return max_rel_err(self.kernel, self.f64)

    @property
    def plain_vs_f64(self) -> float:
        return max_rel_err(self.plain, self.f64)

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.kernel).all() and self.repeats
                    and self.vs_plain <= TOL and self.vs_f64 <= TOL)


def check_case(workdir: str | Path, case: str, n_cells: int, seed: int,
               device, **cfg_fields) -> CaseResult:
    """Run CASES[case] on a make_surface(n_cells, seed) surface through
    the kernel (its plain version on a CPU device), the plain version and
    the f64 engine."""
    fields, surf_kw = CASES[case]
    cfg = Config(compute_dtype="f32c", **fields, **cfg_fields)
    surf = make_surface(n_cells, seed=seed, **surf_kw)
    state = engine_state(workdir, cfg, surf, device)
    args = kernel_args(comp_operands(*state, cfg), cfg)
    before = ck.cooper_frye_comp.launches
    out = ck.cooper_frye_comp(*args)
    launches = ck.cooper_frye_comp.launches - before
    repeats = torch.equal(ck.cooper_frye_comp(*args), out)
    kern = spectra_units(state, out)
    plain = spectra_units(state, ck.cooper_frye_comp_plain(*args))
    ref = spectra_df12(*state, cfg).reshape(kern.shape).cpu().numpy()
    return CaseResult(kern, plain, ref, launches, repeats)
