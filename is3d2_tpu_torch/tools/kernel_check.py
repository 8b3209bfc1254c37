"""Check the kernels against their plain versions and the f64 engines.

One harness for ``chip_smoke.py`` and ``tests/test_torch_gpu.py``:

  * kernel B1 (compensated, df 1/2): the df 1/2 engines' state for a
    surface, the cases every check covers (df 1/2 with the clip, outflow
    and diffusion branches), bar TOL;
  * kernel B2 (plain f32, df 1/2): the same state, the cases F32_CASES
    (those of tests/test_torch_f32_kernel.py), bars F32_TOL_PLAIN against
    the plain version and F32_TOL_F64 against the f64 engine;
  * kernel B3 (feqmod, df 3/4): the feqmod state on a surface with large
    viscous corrections (FEQMOD_SURFACE, so that cells break down), the
    cases FEQMOD_CASES, bars FEQMOD_TOL_PLAIN against the plain version and
    FEQMOD_TOL_F64 against the f64 engine; and its famod mode (df 5) on the
    famod prep of an EOS-consistent surface (FAMOD_SURFACE), with the same
    bars against its plain version and the f64 famod engine.

Operation 0 (dN/dX) runs B1 and B3 (its dan-weighted convention) once per
non-empty bin of each axis: ``check_dX_case`` holds that per-bin kernel
route to the plain versions on the same bins and to the f64 engines'
binned per-cell sums, normalized, with the same bars; DX_DAN draws the
2+1d surface's dsigma_eta, which the spacetime convention weights.  The
driver's df-1/2 route runs B1's per-cell mode once instead:
``check_dX_cells_case`` holds its per-cell sums to its plain version
(TOL per (cell, species) in units of the cell's sum of |terms|,
``cells_scale``: a cell's terms of either sign cancel), its bins to the
per-bin kernel route (CELLS_TOL_PER_BIN: the same f32 terms) and to the
f64 engines (TOL), and runs it twice for the same bits.

Kernel B1's 3+1d mode (df 1/2 on a 3+1d surface): ``check_3d_case`` runs
the CASES on a make_surface(dimension=3) surface against its plain version
(TOL) and the f64 engine, the latter at the JAX package's 3+1d budget
(Case3dResult); its ragged case also runs on RAGGED_Y's rapidity counts,
which its y tile does not divide.

Kernel B3's 3+1d mode (df 3/4/5 on a 3+1d surface):
``check_feqmod_3d_case`` runs FEQMOD_3D_CASES against its plain version
(FEQMOD_TOL_PLAIN) and the f64 engines (FEQMOD_TOL_F64), optionally on a
surface that puts cells' eta within detA of a y node
(``narrow_window_surface``: the narrow window, counted by
``narrow_pairs``); its ragged case runs on RAGGED_Y's rapidity counts.

Kernel P1 (spin polarization, mode 5): ``check_polarization_case`` holds
it to its plain version (POLZN_TOL_PLAIN) and to the f64 polarization
engine (never folded) at the JAX package's bars for its f32 route
(POLZN_TOL_NORM on Snorm, POLZN_TOL_P on P^mu = S^mu / Snorm;
``polarization_errors``) on a surface with vorticity, in the instantiation
the route's fold gate picks (``polarization_operands``): folded with the
default ``eta_fold``, general with ``eta_fold = 0`` or an odd source
(``un_scale``, ``dan_scale``).

Kernel P1's 3+1d mode: ``check_polarization_3d_case`` holds it to its
plain version and to the f64 engine at the same bars on a 3+1d surface
with vorticity, also on one whose cells sit within NEAR_Y of a y node
(``near_cancellation_surface``: the pure pn spin terms take mT sinh(y -
eta) there); its ragged case runs on RAGGED_Y's rapidity counts.

Each kernel also has a ragged case (RAGGED: rows of 7 phi under a register
tile of 4, fewer momenta than one block owns, a cell count that fills
neither the last tile nor the last split), cut from a case's operands and
held to the plain version.  A workdir with an eta table of more nodes than
one launch takes (ETA_NODES, unfolded with ``eta_fold = 0``) runs any case
chunk by chunk.

Errors are relative, on bins >= FLOOR of each species' peak.  On a CPU
device the wrappers run the plain versions, so there only the comparison
with the f64 engine says something.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..core import spacetime
from ..core.polarization import (delta_eta, fold_polarization_eta,
                                 polarization_f64, polarization_state)
from ..core.spectra import PREFACTOR, df12_state, spectra_df12
from ..core.spectra_famod import famod_state, spectra_famod
from ..core.spectra_feqmod import feqmod_state, spectra_feqmod
from ..driver import IS3D
from ..io.pdg import read_pdg
from ..io.tables import GaussLaguerre
from ..ops import cooper_frye_comp as ck
from ..ops import cooper_frye_f32 as b2
from ..ops import cooper_frye_feqmod as fk
from ..ops import polarization_f32 as pz
from ..ops.launch_geometry import over_eta_chunks
from ..ops.spectra_fast_common import (comp_operands, comp_operands_3d,
                                       f32_operands)
from .synthetic import add_dsigma_eta, make_eos_consistent, make_surface

TOL = 1e-6     # relative, on bins >= FLOOR of their species' peak
FLOOR = 1e-4
FEQMOD_TOL_PLAIN = 1e-5   # kernel B3 vs its plain version
FEQMOD_TOL_F64 = 1e-4     # kernel B3 vs the f64 engine (the JAX kernel's bar)
F32_TOL_PLAIN = 1e-5      # kernel B2 vs its plain version
F32_TOL_F64 = 2e-5        # kernel B2 vs the f64 engine (JAX's f32 paths: ~5e-6)

# the kernel instantiation each full-size main path launches (df 1 with shear
# and bulk; df 4; df 2; P1 folded), as a pattern of its mangled name
MAIN_PATH_KERNEL = {
    "cooper_frye_comp": r"cooper_frye_comp_kernelILb1ELb0ELb0ELb0ELb0EE",
    # op 0's per-cell mode
    "cooper_frye_comp_cells":
        r"cooper_frye_comp_kernel_cellsILb1ELb0ELb0ELb0ELb0EE",
    "cooper_frye_feqmod": r"cooper_frye_feqmod_kernelILi4ELb0ELb0ELb0EE",
    "cooper_frye_f32": r"cooper_frye_f32_kernelILb1ELb0ELb0ELb0ELb1EE",
    "polarization_f32": r"polarization_f32_kernelILb1EE",
    # the 3+1d mode's tile shape comes first among its template parameters
    "cooper_frye_comp_3d":
        r"cooper_frye_comp_3d_kernelI(?:Li\d+E)*Lb1ELb0ELb0ELb0ELb0EE",
    # B3's 3+1d mode, df 4 with neither outflow nor regulation: its mixed
    # kernel and its clean kernel
    "cooper_frye_feqmod_3d": r"cooper_frye_feqmod_3d_kernelILi4ELb0ELb0EE",
    "cooper_frye_feqmod_3d_clean":
        r"cooper_frye_feqmod_3d_clean_kernelILb0EE",
    # P1's 3+1d mode: its one instantiation, the tile's shape
    "polarization_f32_3d": r"polarization_f32_3d_kernelI(?:Li\d+E)+E",
}

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


# name -> (config fields, make_surface options), the cases of
# tests/test_torch_f32_kernel.py; compute_dtype f64 with use_pallas 1, the
# route that runs kernel B2
F32_CASES = {
    "df1": ({"df_mode": 1}, {}),
    "df2": ({"df_mode": 2}, {}),
    "df1-regulate": ({"df_mode": 1, "regulate_deltaf": 1},
                     {"shear_scale": 0.03}),
    "df2-regulate-outflow": ({"df_mode": 2, "regulate_deltaf": 1,
                              "outflow": 1}, {"shear_scale": 0.03}),
    "df1-outflow": ({"df_mode": 1, "outflow": 1}, {}),
    "df1-baryon-diffusion": CASES["df1-baryon-diffusion"],
    "df2-baryon-diffusion": CASES["df2-baryon-diffusion"],
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


def _run(kernel, plain, args: tuple):
    """Kernel (twice: launches, repeatability) and plain version; a
    ``functools.partial`` of a wrapper counts the wrapper's launches."""
    counter = getattr(kernel, "func", kernel)
    before = counter.launches
    out = kernel(*args)
    launches = counter.launches - before
    repeats = torch.equal(kernel(*args), out)
    return out, plain(*args), launches, repeats


def _check_df12(workdir, case: tuple, cfg: Config, n_cells: int, seed: int,
                device, operands, kernel, plain, result=CaseResult):
    """One df 1/2 case through a kernel, its plain version and the f64
    engine."""
    surf = make_surface(n_cells, seed=seed, **case[1])
    state = engine_state(workdir, cfg, surf, device)
    out, pl, launches, repeats = _run(kernel, plain,
                                      (*operands(*state, cfg), cfg))
    kern = spectra_units(state, out)
    ref = spectra_df12(*state, cfg).reshape(kern.shape).cpu().numpy()
    return result(kern, spectra_units(state, pl), ref, launches, repeats)


# the ragged case: species, pT and phi kept of the momentum grid, and cells
RAGGED = {"species": 3, "pT": 5, "phi": 7, "cells": 1000}

# eta nodes of the chunked case: three launches of at most 32 nodes
ETA_NODES = 80


def _ragged_momenta(mom: torch.Tensor, species, grid) -> torch.Tensor:
    """The momentum rows (k, S * NpT * Nphi) cut to RAGGED's grid."""
    full = mom.reshape(mom.shape[0], species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0])
    cut = full[:, :RAGGED["species"], :RAGGED["pT"], :RAGGED["phi"]]
    return cut.reshape(mom.shape[0], -1).contiguous()


def _ragged_result(kernel, plain, args, result, **extra):
    out, pl, launches, repeats = _run(kernel, plain, args)
    pl = pl.cpu().numpy()[None]
    return result(out.cpu().numpy()[None], pl, pl, launches, repeats, **extra)


def check_ragged_case(workdir: str | Path, n_cells: int, seed: int,
                      device) -> CaseResult:
    """Kernel B1 against its plain version (which also stands in for f64) on
    the df-1 operands cut to RAGGED."""
    cfg = Config(compute_dtype="f32c", df_mode=1)
    state = engine_state(workdir, cfg, make_surface(n_cells, seed=seed),
                         device)
    ops = comp_operands(*state, cfg)
    n = RAGGED["cells"]
    args = (ops.cell[:n].contiguous(), ops.qm[:n].contiguous(), ops.eta,
            ops.eta_w, _ragged_momenta(ops.mom, state[2], state[3]), cfg)
    return _ragged_result(ck.cooper_frye_comp, ck.cooper_frye_comp_plain,
                          args, CaseResult)


def check_case(workdir: str | Path, case: str, n_cells: int, seed: int,
               device, **cfg_fields) -> CaseResult:
    """Run CASES[case] on a make_surface(n_cells, seed) surface through
    kernel B1 (its plain version on a CPU device), the plain version and
    the f64 engine."""
    cfg = Config(compute_dtype="f32c", **CASES[case][0], **cfg_fields)
    return _check_df12(workdir, CASES[case], cfg, n_cells, seed, device,
                       lambda *st: comp_operands(*st).args(),
                       ck.cooper_frye_comp, ck.cooper_frye_comp_plain)


@dataclasses.dataclass
class F32CaseResult(CaseResult):
    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.kernel).all() and self.repeats
                    and self.vs_plain <= F32_TOL_PLAIN
                    and self.vs_f64 <= F32_TOL_F64)


def check_f32_case(workdir: str | Path, case: str, n_cells: int, seed: int,
                   device, **cfg_fields) -> F32CaseResult:
    """Run F32_CASES[case] (compute_dtype f64, use_pallas 1) on a
    make_surface(n_cells, seed) surface through kernel B2 (its plain version
    on a CPU device), the plain version and the f64 engine."""
    cfg = Config(compute_dtype="f64", use_pallas=1, **F32_CASES[case][0],
                 **cfg_fields)
    return _check_df12(workdir, F32_CASES[case], cfg, n_cells, seed, device,
                       lambda *st: f32_operands(*st).args(),
                       b2.cooper_frye_f32, b2.cooper_frye_f32_plain,
                       F32CaseResult)


def check_f32_ragged_case(workdir: str | Path, n_cells: int, seed: int,
                          device) -> F32CaseResult:
    """Kernel B2 (df 2) against its plain version (which also stands in for
    f64) on the operands cut to RAGGED."""
    cfg = Config(compute_dtype="f64", use_pallas=1, df_mode=2)
    state = engine_state(workdir, cfg, make_surface(n_cells, seed=seed),
                         device)
    ops = f32_operands(*state, cfg)
    n = RAGGED["cells"]
    args = (ops.cell[:n].contiguous(), ops.eta, ops.eta_w,
            _ragged_momenta(ops.mom, state[2], state[3]), cfg)
    return _ragged_result(b2.cooper_frye_f32, b2.cooper_frye_f32_plain,
                          args, F32CaseResult)


# ----------------------------------------------------------------------
# kernel B1's 3+1d mode
# ----------------------------------------------------------------------

# B1's 3+1d mode against the f64 engine is held to the JAX package's own
# budget for its 3+1d f32c path, as its test computes it
# (tests/test_spectra_golden_3d.py:56-79): TOL relative on the bins >= FLOOR
# of the largest bin of all species (``global_rel_err``), and ABS_TOL_3D of
# that bin on every bin, held here of each species' own peak (stricter).
# Relative to each species' own peak (``max_rel_err``, printed) no f32
# scheme holds TOL on every surface: where delta-f nears -1 (the Grad
# expansion at large |y - eta| and pT), 1 + df cancels ~50-fold, and the
# plain-f32 pi:pp carries its last places into the term.  At phase 23's
# 2,048 cells the JAX package's f32c path is 1.2e-6 off its f64 engine by
# that measure (ROADMAP C11).  The kernel follows its plain version at
# TOL relative to each species' peak.
ABS_TOL_3D = 2.5e-7


def peak_err(out: np.ndarray, ref: np.ndarray) -> float:
    """Max |out - ref| over each row's (species') peak |ref|."""
    out = np.asarray(out).reshape(ref.shape[0], -1)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    peak = np.abs(ref).max(axis=1, keepdims=True)
    return float((np.abs(out - ref) / peak).max())


def global_rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    """Max |out - ref| / |ref| over the bins >= FLOOR of the largest |ref|
    of all rows."""
    out, ref = np.asarray(out), np.asarray(ref).reshape(np.shape(out))
    sig = np.abs(ref) >= FLOOR * np.abs(ref).max()
    return float((np.abs(out - ref)[sig] / np.abs(ref)[sig]).max())


@dataclasses.dataclass
class Case3dResult(CaseResult):
    @property
    def vs_f64_global(self) -> float:
        return global_rel_err(self.kernel, self.f64)

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.kernel).all() and self.repeats
                    and self.vs_plain <= TOL and self.vs_f64_global <= TOL
                    and peak_err(self.kernel, self.plain) <= ABS_TOL_3D
                    and peak_err(self.kernel, self.f64) <= ABS_TOL_3D)


def f64_in_kernel_order(state, cfg: Config) -> np.ndarray:
    """The f64 engine's 3+1d spectra, (S, NpT * Ny * Nphi) in the order of
    the 3+1d mode's momenta (species, pT, y, phi)."""
    out = spectra_df12(*state, cfg).permute(0, 1, 3, 2)
    return out.reshape(out.shape[0], -1).cpu().numpy()


def check_3d_case(workdir: str | Path, case: str, n_cells: int, seed: int,
                  device, compute_dtype: str = "f32c",
                  **cfg_fields) -> Case3dResult:
    """Run CASES[case] in 3+1d on a make_surface(n_cells, seed,
    dimension=3) surface through B1's 3+1d mode (its plain version on a
    CPU device), the plain version and the f64 engine; the workdir's y
    table gives the rapidities."""
    cfg = Config(compute_dtype=compute_dtype, dimension=3, **CASES[case][0],
                 **cfg_fields)
    surf = make_surface(n_cells, seed=seed, dimension=3, **CASES[case][1])
    state = engine_state(workdir, cfg, surf, device)
    ops = comp_operands_3d(*state, cfg)
    out, pl, launches, repeats = _run(
        functools.partial(ck.cooper_frye_comp_3d, **ops.layout()),
        ck.cooper_frye_comp_3d_plain, (*ops.args(), cfg))
    return Case3dResult(spectra_units(state, out), spectra_units(state, pl),
                        f64_in_kernel_order(state, cfg), launches, repeats)


# rapidities of the 3+1d ragged cases: 3 (the cut of RAGGED's grid), and y
# counts that the y tiles (3 and 7 rows) do not divide: 5, and 1, fewer
# than a tile
RAGGED_Y = (3, 5, 1)


def check_3d_ragged_case(workdir: str | Path, n_cells: int, seed: int,
                         device, n_y: int = 3) -> Case3dResult:
    """B1's 3+1d mode against its plain version (which also stands in for
    f64) on the df-1 operands cut to RAGGED and to the first ``n_y``
    rapidities."""
    cfg = Config(compute_dtype="f32c", df_mode=1, dimension=3)
    state = engine_state(workdir, cfg, make_surface(n_cells, seed=seed,
                                                    dimension=3), device)
    ops = comp_operands_3d(*state, cfg)
    species, grid = state[2], state[3]
    full = ops.mom.reshape(ops.mom.shape[0], species.mass.shape[0],
                           grid.pT.shape[0], grid.y.shape[0],
                           grid.cos_phi.shape[0])
    mom = full[:, :RAGGED["species"], :RAGGED["pT"], :n_y, :RAGGED["phi"]]
    args = (ops.cell[:RAGGED["cells"]].contiguous(),
            mom.reshape(mom.shape[0], -1).contiguous(), cfg)
    return _ragged_result(
        functools.partial(ck.cooper_frye_comp_3d, row_len=RAGGED["phi"],
                          n_y=n_y),
        ck.cooper_frye_comp_3d_plain, args, Case3dResult)


# ----------------------------------------------------------------------
# kernel B3
# ----------------------------------------------------------------------

# make_surface options under which a few percent of the cells break down
FEQMOD_SURFACE = {"shear_scale": 0.2, "bulk_scale": 0.1}

# name -> config fields (compute_dtype f32; the workdir's chosen species)
FEQMOD_CASES = {
    "df3": {"df_mode": 3},
    "df4": {"df_mode": 4},
    "df3-outflow-regulate": {"df_mode": 3, "outflow": 1, "regulate_deltaf": 1},
    "df4-regulate": {"df_mode": 4, "regulate_deltaf": 1},
}


def feqmod_engine_state(workdir: str | Path, cfg: Config, surf, device):
    """The df 3/4 engines' inputs for ``surf`` with the workdir's tables:
    (cells, feqmod prep, species, grid)."""
    run = IS3D(workdir, cfg=cfg, device=device)
    run.surface = surf
    run._setup()
    return feqmod_state(surf, run.species, run.chosen_idx, run.grids,
                        run.df_data, cfg, device, run.laguerre)


def breakdown_cells(state) -> int:
    cells, fq = state[0], state[1]
    return int((fq.breaks_down & (cells.mask > 0)).sum().item())


@dataclasses.dataclass
class FeqmodCaseResult(CaseResult):
    breakdown_cells: int = 0

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.kernel).all() and self.repeats
                    and self.breakdown_cells > 0
                    and self.vs_plain <= FEQMOD_TOL_PLAIN
                    and self.vs_f64 <= FEQMOD_TOL_F64)


def _run_b3(ops: fk.FeqmodOperands, cfg: Config):
    return _run(fk.cooper_frye_feqmod, fk.cooper_frye_feqmod_plain,
                (*ops.args(), cfg, ops.kind))


def check_feqmod_case(workdir: str | Path, case: str, n_cells: int, seed: int,
                      device, **cfg_fields) -> FeqmodCaseResult:
    """Run FEQMOD_CASES[case] on a make_surface(n_cells, seed,
    **FEQMOD_SURFACE) surface through kernel B3 (its plain version on a
    CPU device), the plain version and the f64 engine."""
    cfg = Config(compute_dtype="f32", **FEQMOD_CASES[case], **cfg_fields)
    surf = make_surface(n_cells, seed=seed, **FEQMOD_SURFACE)
    state = feqmod_engine_state(workdir, cfg, surf, device)
    out, plain, launches, repeats = _run_b3(fk.feqmod_operands(*state, cfg),
                                            cfg)
    ref = spectra_feqmod(*state, cfg).cpu().numpy()
    kern = spectra_units(state, out)
    return FeqmodCaseResult(kern, spectra_units(state, plain),
                            ref.reshape(kern.shape), launches, repeats,
                            breakdown_cells(state))


def check_feqmod_ragged_case(workdir: str | Path, n_cells: int, seed: int,
                             device) -> FeqmodCaseResult:
    """Kernel B3 (df 4) against its plain version (which also stands in for
    f64) on the FEQMOD_SURFACE operands cut to RAGGED."""
    cfg = Config(compute_dtype="f32", df_mode=4)
    surf = make_surface(n_cells, seed=seed, **FEQMOD_SURFACE)
    state = feqmod_engine_state(workdir, cfg, surf, device)
    return _b3_ragged(state, fk.feqmod_operands(*state, cfg), cfg)


def _b3_ragged(state, ops: fk.FeqmodOperands, cfg: Config):
    """B3's kernel and plain version on ``ops`` cut to RAGGED."""
    n, S = RAGGED["cells"], RAGGED["species"]
    args = (ops.cols[:n].contiguous(),
            _ragged_momenta(ops.mom, state[2], state[3]),
            ops.renorm[:n, :S].contiguous(), ops.red[:n, :S].contiguous(),
            ops.eta, RAGGED["pT"] * RAGGED["phi"], cfg, ops.kind)
    n_break = int((ops.cols[:n, fk.BREAKS] != 0).sum().item())
    return _ragged_result(fk.cooper_frye_feqmod, fk.cooper_frye_feqmod_plain,
                          args, FeqmodCaseResult, breakdown_cells=n_break)


# make_surface options of the famod (df 5) checks, on an EOS-consistent
# surface (make_eos_consistent): ~1 % of the cells break down (pl < 0, a
# failed reconstruction)
FAMOD_SURFACE = {"shear_scale": 0.1, "bulk_scale": 0.05}


def famod_surface(workdir: str | Path, n_cells: int, seed: int, device,
                  dimension: int = 2):
    """make_surface(n_cells, seed, **FAMOD_SURFACE) (of ``dimension``)
    with the HRG (E, P) of the workdir's species list."""
    workdir = Path(workdir)
    surf = make_surface(n_cells, seed=seed, dimension=dimension,
                        **FAMOD_SURFACE)
    return make_eos_consistent(
        surf, read_pdg(3, workdir / "PDG"),
        GaussLaguerre.from_file(workdir / "tables/gauss/gla_roots_weights.txt"),
        device)


def famod_engine_state(workdir: str | Path, cfg: Config, surf, device):
    """The df-5 engines' inputs for ``surf`` with the workdir's tables:
    (cells, famod prep, species, grid)."""
    run = IS3D(workdir, cfg=cfg, device=device)
    run.surface = surf
    run._setup()
    return famod_state(surf, run.species, run.chosen_idx, run.grids, cfg,
                       device)


def check_famod_case(workdir: str | Path, n_cells: int, seed: int, device,
                     surf=None, **cfg_fields) -> FeqmodCaseResult:
    """Kernel B3's famod mode (its plain version on a CPU device), the
    plain version and the f64 famod engine on the famod prep of
    famod_surface(n_cells, seed) (or of ``surf``, a mode-2/3 surface's
    variables included), compute_dtype f32."""
    cfg = Config(compute_dtype="f32", df_mode=5, **cfg_fields)
    if surf is None:
        surf = famod_surface(workdir, n_cells, seed, device)
    state = famod_engine_state(workdir, cfg, surf, device)
    out, plain, launches, repeats = _run_b3(fk.famod_operands(*state, cfg),
                                            cfg)
    ref = spectra_famod(*state, cfg).cpu().numpy()
    kern = spectra_units(state, out)
    return FeqmodCaseResult(kern, spectra_units(state, plain),
                            ref.reshape(kern.shape), launches, repeats,
                            breakdown_cells(state))


def check_famod_ragged_case(workdir: str | Path, n_cells: int, seed: int,
                            device) -> FeqmodCaseResult:
    """Kernel B3's famod mode against its plain version (which also stands
    in for f64) on the famod operands cut to RAGGED."""
    cfg = Config(compute_dtype="f32", df_mode=5)
    state = famod_engine_state(workdir, cfg,
                               famod_surface(workdir, n_cells, seed, device),
                               device)
    return _b3_ragged(state, fk.famod_operands(*state, cfg), cfg)


# ----------------------------------------------------------------------
# kernel B3's 3+1d mode
# ----------------------------------------------------------------------

# name -> config fields (compute_dtype f32, dimension 3): df 3 and df 4 on
# a 3+1d FEQMOD_SURFACE (cells break down), the famod mode on the famod
# prep of an EOS-consistent 3+1d FAMOD_SURFACE
FEQMOD_3D_CASES = {
    "df3": {"df_mode": 3},
    "df4": {"df_mode": 4},
    "df3-outflow-regulate": {"df_mode": 3, "outflow": 1, "regulate_deltaf": 1},
    "df4-regulate": {"df_mode": 4, "regulate_deltaf": 1},
    "famod": {"df_mode": 5},
    "famod-outflow": {"df_mode": 5, "outflow": 1},
}


@dataclasses.dataclass
class Feqmod3dCaseResult(FeqmodCaseResult):
    """A 3+1d B3 case; ``narrow_pairs``: the (cell, y) pairs of its
    operands inside the narrow window (``narrow_pairs``)."""

    narrow_pairs: int = 0


def narrow_pairs(ops: fk.FeqmodOperands3d) -> int:
    """The (cell, y) pairs of ``ops`` inside the narrow window."""
    return int(ops.window().sum())


def narrow_window_surface(workdir: str | Path, cfg: Config, n_cells: int,
                          seed: int, device):
    """A 3+1d FEQMOD_SURFACE whose cells with deta_min < detA < 0.01 (not
    broken down) sit within detA / 2 of a y node: each one's eta moved to
    y_k + detA / 2, the table's nodes y_k with |y_k| <= 2 in turn.  A
    cell's eta enters neither A nor the breakdown test, so the prep of the
    moved surface keeps every detA."""
    surf = make_surface(n_cells, seed=seed, dimension=3, **FEQMOD_SURFACE)
    cells, fq, _, grid = feqmod_engine_state(workdir, cfg, surf, device)
    det = fq.detA.cpu().numpy()[:n_cells]
    keep = ((cells.mask.cpu().numpy()[:n_cells] > 0)
            & ~fq.breaks_down.cpu().numpy()[:n_cells]
            & (det > cfg.deta_min) & (det < fk.NARROW_DET))
    idx = np.flatnonzero(keep)
    y = grid.y.cpu().numpy()
    y = y[np.abs(y) <= 2.0]
    surf.eta[idx] = y[np.arange(idx.size) % y.size] + 0.5 * det[idx]
    return surf


def _state_3d(workdir, cfg: Config, n_cells: int, seed: int, device,
              narrow: bool = False):
    """(engine state, operands) of a 3+1d df 3/4 (feqmod) or df 5 (famod)
    case."""
    if cfg.df_mode == 5:
        state = famod_engine_state(
            workdir, cfg, famod_surface(workdir, n_cells, seed, device, 3),
            device)
        return state, fk.famod_operands_3d(*state, cfg)
    surf = (narrow_window_surface(workdir, cfg, n_cells, seed, device)
            if narrow else make_surface(n_cells, seed=seed, dimension=3,
                                        **FEQMOD_SURFACE))
    state = feqmod_engine_state(workdir, cfg, surf, device)
    return state, fk.feqmod_operands_3d(*state, cfg)


def f64_3d(state, cfg: Config) -> np.ndarray:
    """The f64 feqmod or famod engine's 3+1d spectra, (S, NpT * Ny * Nphi)
    in the order of the 3+1d mode's momenta (species, pT, y, phi)."""
    engine = spectra_famod if cfg.df_mode == 5 else spectra_feqmod
    out = engine(*state, cfg).permute(0, 1, 3, 2)
    return out.reshape(out.shape[0], -1).cpu().numpy()


def feqmod_3d_operands(workdir: str | Path, case: str, n_cells: int,
                       seed: int, device, narrow: bool = False,
                       **cfg_fields):
    """(cfg, engine state, 3+1d operands) of FEQMOD_3D_CASES[case], as
    ``check_feqmod_3d_case`` makes them."""
    cfg = Config(compute_dtype="f32", dimension=3, **FEQMOD_3D_CASES[case],
                 **cfg_fields)
    return (cfg, *_state_3d(workdir, cfg, n_cells, seed, device, narrow))


def check_feqmod_3d_case(workdir: str | Path, case: str, n_cells: int,
                         seed: int, device, narrow: bool = False,
                         **cfg_fields) -> Feqmod3dCaseResult:
    """Run FEQMOD_3D_CASES[case] on a 3+1d surface of ``n_cells`` cells
    (``narrow``: narrow_window_surface) through B3's 3+1d mode (its plain
    version on a CPU device), the plain version and the f64 engine; the
    workdir's y table gives the rapidities."""
    cfg, state, ops = feqmod_3d_operands(workdir, case, n_cells, seed,
                                         device, narrow, **cfg_fields)
    out, plain, launches, repeats = _run(
        functools.partial(fk.cooper_frye_feqmod_3d, **ops.layout()),
        functools.partial(fk.cooper_frye_feqmod_3d_plain, **ops.layout()),
        (*ops.args(), cfg, ops.kind))
    return Feqmod3dCaseResult(spectra_units(state, out),
                              spectra_units(state, plain),
                              f64_3d(state, cfg), launches, repeats,
                              breakdown_cells(state), narrow_pairs(ops))


def check_feqmod_3d_ragged_case(workdir: str | Path, n_cells: int,
                                seed: int, device,
                                n_y: int = 3) -> Feqmod3dCaseResult:
    """B3's 3+1d mode (df 4) against its plain version (which also stands
    in for f64) on the operands cut to RAGGED (its cells: the first live
    cells before the clean ones were put first) and to the first ``n_y``
    rapidities."""
    cfg = Config(compute_dtype="f32", df_mode=4, dimension=3)
    state, ops = _state_3d(workdir, cfg, n_cells, seed, device)
    species, grid = state[2], state[3]
    S = RAGGED["species"]
    cut = ops.first(RAGGED["cells"])
    full = ops.mom.reshape(ops.mom.shape[0], species.mass.shape[0],
                           grid.pT.shape[0], grid.y.shape[0],
                           grid.cos_phi.shape[0])
    mom = full[:, :S, :RAGGED["pT"], :n_y, :RAGGED["phi"]]
    layout = {"row_len": RAGGED["phi"], "n_y": n_y}
    args = (cut.cols, cut.cold, mom.reshape(mom.shape[0], -1).contiguous(),
            ops.y[:n_y].contiguous(), cut.renorm[:, :S].contiguous(),
            cut.red[:, :S].contiguous(),
            RAGGED["pT"] * n_y * RAGGED["phi"], cfg, ops.kind)
    n_break = int((cut.cols[:, fk.BREAKS_3] != 0).sum().item())
    return _ragged_result(
        functools.partial(fk.cooper_frye_feqmod_3d, **layout),
        functools.partial(fk.cooper_frye_feqmod_3d_plain, **layout), args,
        Feqmod3dCaseResult, breakdown_cells=n_break)


# ----------------------------------------------------------------------
# operation 0 (dN/dX) through B1 and B3
# ----------------------------------------------------------------------

# dsigma_eta / tau of the operation-0 checks' 2+1d surfaces (add_dsigma_eta)
DX_DAN = 0.05


@dataclasses.dataclass
class DXCaseResult:
    """Normalized (S, bins) of the three axes side by side."""

    kernel: np.ndarray
    plain: np.ndarray
    f64: np.ndarray
    launches: int         # kernel launches of the kernel route
    bins: int             # non-empty bins, over the three axes
    breakdown_cells: int
    tol_plain: float
    tol_f64: float

    @property
    def vs_plain(self) -> float:
        return _axes_err(self.kernel, self.plain)

    @property
    def vs_f64(self) -> float:
        return _axes_err(self.kernel, self.f64)

    @property
    def plain_vs_f64(self) -> float:
        return _axes_err(self.plain, self.f64)

    @property
    def ok(self) -> bool:
        return bool(all(np.isfinite(a).all() for a in self.kernel)
                    and self.vs_plain <= self.tol_plain
                    and self.vs_f64 <= self.tol_f64)


def _axes_err(out, ref) -> float:
    return max(max_rel_err(a, b) for a, b in zip(out, ref))


def dX_state(workdir: str | Path, cfg: Config, surf, device):
    """The operation-0 engines' inputs for ``surf``: df 1/2 (cells,
    coefficients, species, grid) or df 3/4 (cells, feqmod prep, ...)."""
    if cfg.df_mode in (1, 2):
        return engine_state(workdir, cfg, surf, device)
    return feqmod_engine_state(workdir, cfg, surf, device)


def check_dX_case(workdir: str | Path, cfg: Config, n_cells: int, seed: int,
                  device, **surface_kw) -> DXCaseResult:
    """Operation 0 on make_surface(n_cells, seed, **surface_kw) with a
    dsigma_eta (DX_DAN): the kernel route (B1 for df 1/2, B3 dan-weighted
    for df 3/4; the plain versions on a CPU device), the same bins through
    the plain versions, and the f64 engines' binned per-cell sums."""
    surf = add_dsigma_eta(make_surface(n_cells, seed=seed, **surface_kw),
                          seed, DX_DAN)
    state = dX_state(workdir, cfg, surf, device)
    cells = state[0]
    ops = spacetime.kernel_operands(*state, cfg)
    kernel = ck.cooper_frye_comp if cfg.df_mode in (1, 2) \
        else fk.cooper_frye_feqmod
    before = kernel.launches
    out = spacetime.kernel_bins(cells, ops, *state[2:], cfg)
    launches = kernel.launches - before
    plain = spacetime.kernel_bins(
        cells, ops, *state[2:], cfg,
        lambda o, c: spacetime.run_kernel(o, c, plain=True))
    ref = spacetime.f64_bins(*state, cfg)
    mask = cells.mask.cpu().numpy()
    bins = sum(len(spacetime.binned_cells(idx, n, mask)[1])
               for idx, n in spacetime.bin_indices(cells, cfg))

    def norm(acc):
        return spacetime.distributions(acc, cfg).normalized(cfg)

    feqmod = cfg.df_mode in (3, 4)
    return DXCaseResult(
        norm(out), norm(plain), norm(ref), launches, bins,
        breakdown_cells(state) if feqmod else 0,
        FEQMOD_TOL_PLAIN if feqmod else TOL,
        FEQMOD_TOL_F64 if feqmod else TOL)


# B1's per-cell route against its per-bin route: the same f32 terms (the
# kernels share their evaluation), added in f64 in another order
CELLS_TOL_PER_BIN = 1e-12


def cells_scale(cell, qm, eta, eta_w, mom, w, cfg: Config) -> np.ndarray:
    """(C, S): each cell's sum over a species' momenta of w |eta sum of
    its terms| (the plain version's parts), the scale of a per-cell
    comparison: a cell's dN/dy adds terms of either sign (p.dsigma), so
    where they cancel a last place of each term moves the sum by more than
    its own last places."""
    S = mom.shape[1] // w.shape[0]

    def chunk(e0, e1):
        parts = [p.abs().to(torch.float64).reshape(p.shape[0], S, -1) @ w
                 for p in ck.plain_parts(cell, qm[:, e0:e1], eta[e0:e1],
                                          eta_w[e0:e1], mom, cfg)]
        return torch.cat(parts)
    return over_eta_chunks(eta.shape[0], ck.ETA_CHUNK, chunk).cpu().numpy()


def max_scaled_err(out: np.ndarray, ref: np.ndarray,
                   scale: np.ndarray) -> float:
    """Max |out - ref| / scale over the (cell, species) entries whose scale
    is >= FLOOR of the species' largest."""
    sig = scale >= FLOOR * scale.max(axis=0, keepdims=True)
    return float((np.abs(out - ref)[sig] / scale[sig]).max())


@dataclasses.dataclass
class DXCellsResult:
    """Operation 0 through B1's per-cell mode: the (C, S) per-cell sums of
    the kernel and of its plain version and their scale (cells_scale), and
    the three axes' normalized bins of the per-cell route, of the per-bin
    kernel route and of the f64 engines."""

    cells: np.ndarray        # (C, S) kernel
    cells_plain: np.ndarray  # (C, S) plain version
    scale: np.ndarray        # (C, S) cells_scale
    binned: list
    per_bin: list
    f64: list
    launches: int            # per-cell launches of the route
    repeats: bool            # a second run gave the same bits, per cell
                             # and binned

    @property
    def vs_plain(self) -> float:
        """Per (cell, species), in units of the cell's scale."""
        return max_scaled_err(self.cells, self.cells_plain, self.scale)

    @property
    def vs_per_bin(self) -> float:
        return _axes_err(self.binned, self.per_bin)

    @property
    def vs_f64(self) -> float:
        return _axes_err(self.binned, self.f64)

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.cells).all() and self.repeats
                    and self.vs_plain <= TOL
                    and self.vs_per_bin <= CELLS_TOL_PER_BIN
                    and self.vs_f64 <= TOL)


def cells_operands(state, ops, cfg: Config):
    """(operands, arguments) of B1's per-cell mode as the op-0 route
    (spacetime.comp_cell_bins) launches it: the rows of ``ops``
    (spacetime.kernel_operands of ``state``) of the cells that some axis
    bins, and the wrapper's arguments with the (pT, phi) weights."""
    cells, grid = state[0], state[3]
    bins = spacetime.bin_indices(cells, cfg)
    keep = spacetime.cell_bin_columns(bins, cells.mask.cpu().numpy())[0]
    kept = spacetime.cell_rows(ops, torch.as_tensor(keep,
                                                    device=ops.cell.device))
    w = (grid.pT_weight[:, None] * grid.phi_weight[None, :]).reshape(-1)
    return kept, (*kept.args(), w.contiguous(), cfg)


def check_dX_cells_case(workdir: str | Path, cfg: Config, n_cells: int,
                        seed: int, device, **surface_kw) -> DXCellsResult:
    """Operation 0 (df 1/2) on make_surface(n_cells, seed, **surface_kw)
    with a dsigma_eta (DX_DAN) through B1's per-cell route
    (spacetime.comp_cell_bins, twice), its per-cell sums against the plain
    version's, its bins against the per-bin kernel route's and the f64
    engines'."""
    surf = add_dsigma_eta(make_surface(n_cells, seed=seed, **surface_kw),
                          seed, DX_DAN)
    state = dX_state(workdir, cfg, surf, device)
    cells = state[0]
    ops = spacetime.kernel_operands(*state, cfg)
    kept, args = cells_operands(state, ops, cfg)
    dN = ck.cooper_frye_comp_cells(*args, row_len=kept.row_len)
    plain = ck.cooper_frye_comp_cells_plain(*args)
    before = ck.cooper_frye_comp_cells.launches
    binned = spacetime.comp_cell_bins(*state, cfg)
    launches = ck.cooper_frye_comp_cells.launches - before
    repeats = (torch.equal(dN, ck.cooper_frye_comp_cells(
                   *args, row_len=kept.row_len))
               and all(torch.equal(a, b) for a, b in zip(
                   binned, spacetime.comp_cell_bins(*state, cfg))))

    def norm(acc):
        return spacetime.distributions(acc, cfg).normalized(cfg)

    return DXCellsResult(
        dN.cpu().numpy(), plain.cpu().numpy(), cells_scale(*args),
        norm(binned),
        norm(spacetime.kernel_bins(cells, ops, *state[2:], cfg)),
        norm(spacetime.f64_bins(*state, cfg)), launches, repeats)


# ----------------------------------------------------------------------
# kernel P1 (spin polarization, mode 5)
# ----------------------------------------------------------------------

# The JAX package's bars for its f32 polarization route against its f64
# engine (tests/test_f32_paths.py::test_polarization_f32_matches_f64):
# Snorm relative on bins >= POLZN_NORM_FLOOR of its max, and each
# P^mu = S^mu / Snorm absolute, in units of max |P|, on bins whose Snorm
# is >= POLZN_P_FLOOR of its max (the spin sums cancel across cells, so a
# relative error of S^mu would measure rounding noise)
POLZN_TOL_NORM = 2e-5
POLZN_TOL_P = 1e-5
POLZN_TOL_PLAIN = 1e-5    # kernel P1 vs its plain version, both metrics
POLZN_NORM_FLOOR = 1e-6
POLZN_P_FLOOR = 1e-3


def polarization_errors(out: np.ndarray, ref: np.ndarray
                        ) -> tuple[float, float]:
    """(Snorm relative error, max |P^mu - P^mu_ref| / max |P_ref|) of the
    (5, ...) sums ``out`` against ``ref``, on the bins above."""
    out = np.asarray(out).reshape(5, -1)
    ref = np.asarray(ref).reshape(5, -1)
    n_out, n_ref = out[4], ref[4]
    sig = n_ref > POLZN_NORM_FLOOR * n_ref.max()
    norm_err = float((np.abs(n_out - n_ref)[sig] / n_ref[sig]).max())
    good = n_ref > POLZN_P_FLOOR * n_ref.max()
    p_err = 0.0
    for k in range(4):
        p_ref = ref[k][good] / n_ref[good]
        p_out = out[k][good] / n_out[good]
        p_err = max(p_err, float(np.abs(p_out - p_ref).max()
                                 / max(np.abs(p_ref).max(), 1e-300)))
    return norm_err, p_err


def polarization_units(out: np.ndarray, ref: np.ndarray) -> float:
    """max |P^mu - P^mu_ref| over the four components on the bins whose
    Snorm is >= POLZN_P_FLOOR of its max: the error of the observable."""
    out = np.asarray(out).reshape(5, -1)
    ref = np.asarray(ref).reshape(5, -1)
    good = ref[4] > POLZN_P_FLOOR * ref[4].max()
    return float(max(np.abs(out[k][good] / out[4][good]
                            - ref[k][good] / ref[4][good]).max()
                     for k in range(4)))


@dataclasses.dataclass
class PolarizationCaseResult:
    kernel: np.ndarray    # (5, M) sums
    plain: np.ndarray
    f64: np.ndarray
    launches: int         # kernel launches of the checked call
    repeats: bool         # a second call gave the same bits
    folded: bool          # the instantiation: eta-folded or general
    # the bars against the f64 engine: Snorm, P
    f64_bars: tuple[float, float] = (POLZN_TOL_NORM, POLZN_TOL_P)

    @property
    def vs_plain(self) -> tuple[float, float]:
        return polarization_errors(self.kernel, self.plain)

    @property
    def vs_f64(self) -> tuple[float, float]:
        return polarization_errors(self.kernel, self.f64)

    @property
    def plain_vs_f64(self) -> tuple[float, float]:
        return polarization_errors(self.plain, self.f64)

    @property
    def ok(self) -> bool:
        norm, p = self.vs_f64
        return bool(np.isfinite(self.kernel).all() and self.repeats
                    and max(self.vs_plain) <= POLZN_TOL_PLAIN
                    and norm <= self.f64_bars[0] and p <= self.f64_bars[1])


def polarization_engine_state(workdir: str | Path, cfg: Config, surf,
                              device):
    """The polarization's inputs for ``surf`` with the workdir's tables:
    (cells, species, grid, surface-averaged T, delta_eta)."""
    run = IS3D(workdir, cfg=cfg, device=device)
    run.surface = surf
    run._setup()
    return (*polarization_state(surf, run.species, run.chosen_idx, run.grids,
                                cfg, device),
            float(run.plasma.temperature), delta_eta(run.grids))


def polarization_operands(state, cfg: Config) -> pz.PolarizationOperands:
    """P1's operands for the engine state, as the f32/f32c route packs them:
    on the folded grid where its gate allows (delta_eta stays the unfolded
    table's, as the state carries it)."""
    cells, species, grid, T, d_eta = state
    grid, folded = fold_polarization_eta(cells, grid, cfg)
    return pz.pack_inputs(cells, species, grid, T, d_eta, folded)


def _polarization_result(state, args) -> PolarizationCaseResult:
    out, plain, launches, repeats = _run(pz.polarization_f32,
                                         pz.polarization_f32_plain, args)
    return PolarizationCaseResult(
        out.cpu().numpy(), plain.cpu().numpy(),
        polarization_f64(*state).reshape(5, -1).cpu().numpy(), launches,
        repeats, args[-1])


def polarization_surface(n_cells: int, seed: int, un_scale: float = 0.0,
                         dan_scale: float = 0.0):
    """make_surface(n_cells, seed, vorticity=True), with un / 1 fm^-1 and
    dsigma_eta / tau drawn uniform in +-un_scale and +-dan_scale from
    streams of their own where these are not 0: sources odd in eta, which
    the fold gate refuses."""
    surf = make_surface(n_cells, seed=seed, vorticity=True)
    if un_scale:
        surf.un = np.random.default_rng([seed, 2]).uniform(
            -un_scale, un_scale, n_cells)
    if dan_scale:
        add_dsigma_eta(surf, seed, dan_scale)
    return surf


def check_polarization_case(workdir: str | Path, n_cells: int, seed: int,
                            device, un_scale: float = 0.0,
                            dan_scale: float = 0.0,
                            **cfg_fields) -> PolarizationCaseResult:
    """Kernel P1 (its plain version on a CPU device), the plain version and
    the f64 engine on polarization_surface(n_cells, seed, un_scale,
    dan_scale) with the workdir's species and tables (mode 5, f32c)."""
    cfg = Config(compute_dtype="f32c", mode=5, **cfg_fields)
    surf = polarization_surface(n_cells, seed, un_scale, dan_scale)
    state = polarization_engine_state(workdir, cfg, surf, device)
    return _polarization_result(state,
                                polarization_operands(state, cfg).args())


def check_polarization_ragged_case(workdir: str | Path, n_cells: int,
                                   seed: int, device, **cfg_fields
                                   ) -> PolarizationCaseResult:
    """Kernel P1 against its plain version (which also stands in for f64)
    on the operands cut to RAGGED."""
    cfg = Config(compute_dtype="f32c", mode=5, **cfg_fields)
    surf = make_surface(n_cells, seed=seed, vorticity=True)
    state = polarization_engine_state(workdir, cfg, surf, device)
    ops = polarization_operands(state, cfg)
    n = RAGGED["cells"]
    args = (ops.cell[:n].contiguous(), ops.eta,
            _ragged_momenta(ops.mom, state[1], state[2]), ops.folded)
    out, plain, launches, repeats = _run(pz.polarization_f32,
                                         pz.polarization_f32_plain, args)
    plain = plain.cpu().numpy()
    return PolarizationCaseResult(out.cpu().numpy(), plain, plain, launches,
                                  repeats, ops.folded)


# ----------------------------------------------------------------------
# kernel P1's 3+1d mode (spin polarization, mode 5, dimension 3)
# ----------------------------------------------------------------------

# cells moved next to a y node (near_cancellation_surface): |y - eta| below
NEAR_Y = 1e-4


def f64_polarization_3d(state) -> np.ndarray:
    """The f64 engine's 3+1d sums, (5, S * NpT * Ny * Nphi) in the order
    of the 3+1d mode's momenta (species, pT, y, phi)."""
    out = polarization_f64(*state, dimension=3).permute(0, 1, 2, 4, 3)
    return out.reshape(5, -1).cpu().numpy()


def polarization_operands_3d(state) -> pz.PolarizationOperands3d:
    """P1's 3+1d operands for the engine state, as the route packs them."""
    cells, species, grid, T, _ = state
    return pz.pack_inputs_3d(cells, species, grid, T)


def near_cancellation_surface(workdir: str | Path, n_cells: int, seed: int):
    """A 3+1d make_surface(n_cells, seed, vorticity=True) surface whose
    even cells sit within NEAR_Y of a y node of the workdir's table (its
    nodes with |y| <= 2 in turn; the offset uniform in +-NEAR_Y from a
    stream of its own): there mT sinh(y - eta) is ~1e-4 mT, and the pure
    pn spin terms (wxy, wty, wtx, nonzero here) take it."""
    from ..io.tables import MomentumGrids
    surf = make_surface(n_cells, seed=seed, dimension=3, vorticity=True)
    y = MomentumGrids.from_dir(Path(workdir) / "tables").y
    y = y[np.abs(y) <= 2.0]
    idx = np.arange(0, n_cells, 2)
    rng = np.random.default_rng([seed, 3])
    surf.eta[idx] = (y[np.arange(idx.size) % y.size]
                     + rng.uniform(-NEAR_Y, NEAR_Y, idx.size))
    return surf


# A cold, fast-flowing 3+1d surface (fast_flow_surface): every cell at
# FAST_FLOW_T, |u_perp| within 5 % of FAST_FLOW_U.  There, at pT ~ 3 GeV,
# log2(e) |u_perp| pT / T reaches ~170: split into its (cell, y) and (cell,
# phi) factors without P1's shift, 2^(u.p log2(e) / T) would be inf times
# 0 for the cells flowing along phi.
FAST_FLOW_U = 3.0
FAST_FLOW_T = 0.08      # GeV
# The bar there against the f64 engine, on Snorm and P: with |u.p| / T up
# to ~250, one f32 rounding of an exponent's piece (e0 = qe0 mT, cosh d,
# A = qa pT, ...) is ~1.5e-5 of it and moves the term by ~1e-5, in any
# order of the arithmetic: the plain version is as far from the f64
# engine as the kernel, and so is the JAX package's f32 program
# (tests/test_torch_polarization_3d.py::
# test_p1_3d_shifted_factors_stay_finite_on_fast_cold_cells prints the
# port's and its).  The bar is a few such roundings: it catches a wrong
# shift or a lost factor, not the f32 route's own limit.
FAST_FLOW_TOL = 1e-4


def fast_flow_surface(n_cells: int, seed: int):
    """A 3+1d make_surface(n_cells, seed, vorticity=True) surface at
    FAST_FLOW_T whose transverse flow is FAST_FLOW_U in size (within 5 %)
    and random in direction, from a stream of its own."""
    surf = make_surface(n_cells, seed=seed, dimension=3, vorticity=True)
    rng = np.random.default_rng([seed, 4])
    u = FAST_FLOW_U * rng.uniform(0.95, 1.05, n_cells)
    phi = rng.uniform(0.0, 2.0 * np.pi, n_cells)
    surf.ux, surf.uy = u * np.cos(phi), u * np.sin(phi)
    surf.T = np.full(n_cells, FAST_FLOW_T)
    return surf


def check_polarization_3d_case(workdir: str | Path, n_cells: int, seed: int,
                               device, near: bool = False,
                               fast_flow: bool = False,
                               **cfg_fields) -> PolarizationCaseResult:
    """P1's 3+1d mode (its plain version on a CPU device), the plain
    version and the f64 engine on a 3+1d surface with thermal vorticity
    (``near``: near_cancellation_surface; ``fast_flow``:
    fast_flow_surface, held to the f64 engine at FAST_FLOW_TOL) with the
    workdir's species and tables (mode 5, f32c, dimension 3)."""
    cfg = Config(compute_dtype="f32c", mode=5, dimension=3, **cfg_fields)
    if fast_flow:
        surf = fast_flow_surface(n_cells, seed)
    elif near:
        surf = near_cancellation_surface(workdir, n_cells, seed)
    else:
        surf = make_surface(n_cells, seed=seed, dimension=3, vorticity=True)
    state = polarization_engine_state(workdir, cfg, surf, device)
    ops = polarization_operands_3d(state)
    out, plain, launches, repeats = _run(
        functools.partial(pz.polarization_f32_3d, **ops.layout()),
        functools.partial(pz.polarization_f32_3d_plain, **ops.layout()),
        ops.args())
    bars = ((FAST_FLOW_TOL, FAST_FLOW_TOL) if fast_flow
            else (POLZN_TOL_NORM, POLZN_TOL_P))
    return PolarizationCaseResult(out.cpu().numpy(), plain.cpu().numpy(),
                                  f64_polarization_3d(state), launches,
                                  repeats, False, bars)


def check_polarization_3d_ragged_case(workdir: str | Path, n_cells: int,
                                      seed: int, device, n_y: int = 3
                                      ) -> PolarizationCaseResult:
    """P1's 3+1d mode against its plain version (which also stands in for
    f64) on the operands cut to RAGGED and to the first ``n_y``
    rapidities."""
    cfg = Config(compute_dtype="f32c", mode=5, dimension=3)
    surf = make_surface(n_cells, seed=seed, dimension=3, vorticity=True)
    state = polarization_engine_state(workdir, cfg, surf, device)
    ops = polarization_operands_3d(state)
    full = ops.mom.reshape(ops.mom.shape[0], state[1].mass.shape[0],
                           state[2].pT.shape[0], ops.n_y, ops.row_len)
    mom = full[:, :RAGGED["species"], :RAGGED["pT"], :n_y, :RAGGED["phi"]]
    n = RAGGED["cells"]
    args = (ops.cell[:n].contiguous(), ops.ytab[:n, :n_y].contiguous(),
            mom.reshape(mom.shape[0], -1).contiguous())
    layout = {"row_len": RAGGED["phi"], "n_y": n_y}
    out, plain, launches, repeats = _run(
        functools.partial(pz.polarization_f32_3d, **layout),
        functools.partial(pz.polarization_f32_3d_plain, **layout), args)
    plain = plain.cpu().numpy()
    return PolarizationCaseResult(out.cpu().numpy(), plain, plain, launches,
                                  repeats, False)
