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
non-empty bin of each axis: ``check_dX_case`` holds the kernel route to
the plain versions on the same bins and to the f64 engines' binned
per-cell sums, normalized, with the same bars; DX_DAN draws the 2+1d
surface's dsigma_eta, which the spacetime convention weights.

Kernel P1 (spin polarization, mode 5): ``check_polarization_case`` holds
it to its plain version (POLZN_TOL_PLAIN) and to the f64 polarization
engine at the JAX package's bars for its f32 route (POLZN_TOL_NORM on
Snorm, POLZN_TOL_P on P^mu = S^mu / Snorm; ``polarization_errors``) on a
surface with vorticity.

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
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..core import spacetime
from ..core.polarization import delta_eta, polarization_f64, polarization_state
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
from ..ops.spectra_fast_common import comp_operands, f32_operands
from .synthetic import add_dsigma_eta, make_eos_consistent, make_surface

TOL = 1e-6     # relative, on bins >= FLOOR of their species' peak
FLOOR = 1e-4
FEQMOD_TOL_PLAIN = 1e-5   # kernel B3 vs its plain version
FEQMOD_TOL_F64 = 1e-4     # kernel B3 vs the f64 engine (the JAX kernel's bar)
F32_TOL_PLAIN = 1e-5      # kernel B2 vs its plain version
F32_TOL_F64 = 2e-5        # kernel B2 vs the f64 engine (JAX's f32 paths: ~5e-6)

# the kernel instantiation each full-size main path launches (df 1 with shear
# and bulk; df 4; df 2; P1 has one), as a pattern of its mangled name
MAIN_PATH_KERNEL = {
    "cooper_frye_comp": r"cooper_frye_comp_kernelILb1ELb0ELb0ELb0ELb0EE",
    "cooper_frye_feqmod": r"cooper_frye_feqmod_kernelILi4ELb0ELb0ELb0EE",
    "cooper_frye_f32": r"cooper_frye_f32_kernelILb1ELb0ELb0ELb0ELb1EE",
    "polarization_f32": r"polarization_f32_kernel",
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
    """Kernel (twice: launches, repeatability) and plain version."""
    before = kernel.launches
    out = kernel(*args)
    launches = kernel.launches - before
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


def famod_surface(workdir: str | Path, n_cells: int, seed: int, device):
    """make_surface(n_cells, seed, **FAMOD_SURFACE) with the HRG (E, P) of
    the workdir's species list."""
    workdir = Path(workdir)
    surf = make_surface(n_cells, seed=seed, **FAMOD_SURFACE)
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
                    and norm <= POLZN_TOL_NORM and p <= POLZN_TOL_P)


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


def _polarization_result(state, args) -> PolarizationCaseResult:
    out, plain, launches, repeats = _run(pz.polarization_f32,
                                         pz.polarization_f32_plain, args)
    return PolarizationCaseResult(
        out.cpu().numpy(), plain.cpu().numpy(),
        polarization_f64(*state).reshape(5, -1).cpu().numpy(), launches,
        repeats)


def check_polarization_case(workdir: str | Path, n_cells: int, seed: int,
                            device, **cfg_fields) -> PolarizationCaseResult:
    """Kernel P1 (its plain version on a CPU device), the plain version and
    the f64 engine on make_surface(n_cells, seed, vorticity=True) with the
    workdir's species and tables (mode 5, f32c)."""
    cfg = Config(compute_dtype="f32c", mode=5, **cfg_fields)
    surf = make_surface(n_cells, seed=seed, vorticity=True)
    state = polarization_engine_state(workdir, cfg, surf, device)
    return _polarization_result(state, pz.pack_inputs(*state).args())


def check_polarization_ragged_case(workdir: str | Path, n_cells: int,
                                   seed: int, device
                                   ) -> PolarizationCaseResult:
    """Kernel P1 against its plain version (which also stands in for f64)
    on the operands cut to RAGGED."""
    cfg = Config(compute_dtype="f32c", mode=5)
    surf = make_surface(n_cells, seed=seed, vorticity=True)
    state = polarization_engine_state(workdir, cfg, surf, device)
    ops = pz.pack_inputs(*state)
    n = RAGGED["cells"]
    args = (ops.cell[:n].contiguous(), ops.eta, ops.eta_w,
            _ragged_momenta(ops.mom, state[1], state[2]), ops.inv_T)
    out, plain, launches, repeats = _run(pz.polarization_f32,
                                         pz.polarization_f32_plain, args)
    plain = plain.cpu().numpy()
    return PolarizationCaseResult(out.cpu().numpy(), plain, plain, launches,
                                  repeats)
