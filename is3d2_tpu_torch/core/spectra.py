"""Continuous Cooper-Frye momentum spectra dN/(pT dpT dphi dy).

Counterpart of is3d2_tpu/core/spectra.py (the reference's
MomentumSpectra.cpp:32-415) and its dispatcher over df modes.  For df 1/2:

  * the torch f64 engine (``spectra_df12``): the integrand on broadcast
    axes (cell, species, pT, phi, y, eta), summed block by block over the
    cells.  It is the port's own yardstick, the counterpart of
    ``_spectra_df12_jit``;
  * the compensated-f32 kernel B1 (``compute_dtype`` "f32c" or "f32"):
    the hand-written CUDA kernel ops/cooper_frye_comp.py on a GPU, its
    plain torch version on the CPU (ops/spectra_fast_common.py);
  * the plain-f32 kernel B2 (``use_pallas = 1`` with "f64"):
    ops/cooper_frye_f32.py, likewise.

df 3/4 (feqmod) run the torch f64 engine of core/spectra_feqmod.py or
kernel B3 (ops/cooper_frye_feqmod.py); df 5 (famod) the torch f64 engine of
core/spectra_famod.py or kernel B3's famod mode.

All data-dependent per-cell branches of the reference (u.dsigma <= 0 skip,
outflow Theta, |df| <= 1 regulation) are masks and where's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config
from ..constants import hbarC
from ..io.pdg import SpeciesTable
from ..io.tables import MomentumGrids
from ..physics.deltaf import DeltafData
from .cells import CellArrays, evaluate_cell_deltaf, prepare_cells

PREFACTOR = (2.0 * math.pi * hbarC) ** -3  # CF prefactor (MomentumSpectra.cpp:38)

# elements of one (cells x species x pT x phi x y x eta) f64 block of the
# f64 engine: bounds its working set (~a dozen live blocks of 32 MB)
_F64_BLOCK_ELEMENTS = 1 << 22

f64 = torch.float64


@dataclasses.dataclass
class SpeciesArrays:
    """Chosen-species properties as f64 tensors on the run's device."""

    mass: torch.Tensor        # (S,)
    sign: torch.Tensor
    degeneracy: torch.Tensor
    baryon: torch.Tensor

    @classmethod
    def from_table(cls, table: SpeciesTable, indices: np.ndarray,
                   device) -> "SpeciesArrays":
        def t(a):
            return torch.as_tensor(a[indices], dtype=f64, device=device)
        return cls(mass=t(table.mass), sign=t(table.sign),
                   degeneracy=t(table.gspin), baryon=t(table.baryon))


@dataclasses.dataclass
class MomentumGridDevice:
    """Momentum and eta quadrature as f64 tensors (2+1d: y = 0)."""

    pT: torch.Tensor
    pT_weight: torch.Tensor
    cos_phi: torch.Tensor
    sin_phi: torch.Tensor
    phi_weight: torch.Tensor
    y: torch.Tensor
    eta: torch.Tensor
    eta_weight: torch.Tensor

    @classmethod
    def from_grids(cls, g: MomentumGrids, device) -> "MomentumGridDevice":
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=f64, device=device)
        return cls(pT=t(g.pT), pT_weight=t(g.pT_weight),
                   cos_phi=t(np.cos(g.phi)), sin_phi=t(np.sin(g.phi)),
                   phi_weight=t(g.phi_weight), y=t(np.zeros(1)),
                   eta=t(g.eta), eta_weight=t(g.eta_weight))


def df12_cell_coefficients(cells: CellArrays, df_data: DeltafData,
                           cfg: Config) -> dict:
    """Per-cell shear/bulk/diffusion coefficient columns
    (MomentumSpectra.cpp:213-246)."""
    df = evaluate_cell_deltaf(cells, df_data, cfg)
    T = cells.T
    bulkPi = cells.bulkPi
    if cfg.df_mode == 1:
        return {
            "shear": 1.0 / df.shear14,
            "bulk0": (df.c0 - df.c2) * bulkPi,
            "bulk1": df.c1 * bulkPi,
            "bulk2": (4.0 * df.c2 - df.c0) * bulkPi,
            "diff0": df.c3,
            "diff1": df.c4,
        }
    if cfg.df_mode == 2:
        return {
            "shear": 0.5 / (df.betapi * T),
            "bulk0": df.F / (T * T * df.betabulk) * bulkPi,
            "bulk1": df.G / df.betabulk * bulkPi,
            "bulk2": bulkPi / (3.0 * T * df.betabulk),
            "diff0": cells.baryon_enthalpy_ratio / df.betaV,
            "diff1": 1.0 / df.betaV,
        }
    raise ValueError("df12_cell_coefficients requires df_mode 1 or 2")


def _momentum_tensors(c: CellArrays, grid: MomentumGridDevice,
                      species: SpeciesArrays):
    """2+1d kinematics for one cell block: pt[c,s,p,y,e], pn[c,s,p,y,e],
    px[p,f], py[p,f] (y = 0, eta from the table)."""
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)  # (s,p)
    px = grid.pT[:, None] * grid.cos_phi[None, :]                        # (p,f)
    py = grid.pT[:, None] * grid.sin_phi[None, :]
    delta = -grid.eta[None, None, :]                                     # (c=1,y=1,e)
    sinh_d = torch.sinh(delta)
    cosh_d = torch.sqrt(1.0 + sinh_d * sinh_d)
    pt = mT[None, :, :, None, None] * cosh_d[:, None, None, :, :]
    pn = (mT[None, :, :, None, None] / c.tau[:, None, None, None, None]
          * sinh_d[:, None, None, :, :])
    return pt, pn, px, py


def df12_weighted_value(c: CellArrays, coeffs: dict, species: SpeciesArrays,
                        grid: MomentumGridDevice, cfg: Config):
    """eta_weight * (p.dsigma) * f on axes (c,s,p,f,y,e) for df modes 1/2
    (the hot loop of MomentumSpectra.cpp:250-377), in f64."""
    pt5, pn5, px2, py2 = _momentum_tensors(c, grid, species)

    def C(a):  # cell scalar -> (c,1,1,1,1,1)
        return a[:, None, None, None, None, None]

    def S(a):  # species scalar -> (1,s,1,1,1,1)
        return a[None, :, None, None, None, None]

    pt = pt5[:, :, :, None, :, :]
    pn = pn5[:, :, :, None, :, :]
    px = px2[None, None, :, :, None, None]
    py = py2[None, None, :, :, None, None]
    tau2 = c.tau * c.tau

    # p.dsigma (momentum contravariant, dsigma covariant)
    pdd = pt * C(c.dat) + px * C(c.dax) + py * C(c.day) + pn * C(c.dan)
    # u.p (LRF energy)
    E_lrf = pt * C(c.ut) - px * C(c.ux) - py * C(c.uy) - pn * C(tau2 * c.un)

    chem = S(species.baryon) * C(c.alphaB)
    sgn = S(species.sign)
    feq = 1.0 / (torch.exp(E_lrf / C(c.T) - chem) + sgn)
    feqbar = 1.0 - sgn * feq

    # pi^munu p_mu p_nu (MomentumSpectra.cpp:323-324)
    pimunu_pp = (C(c.pitt) * pt * pt + C(c.pixx) * px * px + C(c.piyy) * py * py
                 + C(tau2 * tau2 * c.pinn) * pn * pn
                 + 2.0 * (-(C(c.pitx) * px + C(c.pity) * py) * pt
                          + C(c.pixy) * px * py
                          + C(tau2) * pn * (C(c.pixn) * px + C(c.piyn) * py
                                            - C(c.pitn) * pt)))
    # V^mu p_mu
    V_pp = pt * C(c.Vt) - px * C(c.Vx) - py * C(c.Vy) - pn * C(tau2 * c.Vn)

    mass2 = S(species.mass ** 2)
    b_s = S(species.baryon)
    k = coeffs
    if cfg.df_mode == 1:
        df_shear = C(k["shear"]) * pimunu_pp
        df_bulk = C(k["bulk0"]) * mass2 \
            + (C(k["bulk1"]) * b_s + C(k["bulk2"]) * E_lrf) * E_lrf
        df_diff = (C(k["diff0"]) * b_s + C(k["diff1"]) * E_lrf) * V_pp
    elif cfg.df_mode == 2:
        df_shear = C(k["shear"]) * pimunu_pp / E_lrf
        df_bulk = C(k["bulk0"]) * E_lrf + C(k["bulk1"]) * b_s \
            + C(k["bulk2"]) * (E_lrf - mass2 / E_lrf)
        df_diff = (C(k["diff0"]) - C(k["diff1"]) * b_s / E_lrf) * V_pp
    else:
        raise ValueError("df12 engine supports df_mode 1/2 only")

    df = feqbar * (df_shear + df_bulk + df_diff)
    if cfg.regulate_deltaf:
        df = torch.clamp(df, -1.0, 1.0)
    f = feq * (1.0 + df)
    if cfg.outflow:
        pdd = torch.where(pdd > 0.0, pdd, 0.0)
    w_eta = grid.eta_weight[None, None, None, None, None, :]
    return w_eta * pdd * f


def spectra_df12(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                 grid: MomentumGridDevice, cfg: Config) -> torch.Tensor:
    """The torch f64 engine: (S, NpT, Nphi, Ny) spectra, summed over cell
    blocks of at most _F64_BLOCK_ELEMENTS integrand points."""
    S = species.mass.shape[0]
    shape = (S, grid.pT.shape[0], grid.cos_phi.shape[0], grid.y.shape[0])
    per_cell = math.prod(shape) * grid.eta.shape[0]
    C = cells.n_padded
    blk = max(1, min(C, _F64_BLOCK_ELEMENTS // per_cell))
    acc = torch.zeros(shape, dtype=f64, device=cells.tau.device)
    for i in range(0, C, blk):
        cb = CellArrays(**{f.name: getattr(cells, f.name)[i:i + blk]
                           for f in dataclasses.fields(cells)})
        kb = {k: v[i:i + blk] for k, v in coeffs.items()}
        value = df12_weighted_value(cb, kb, species, grid, cfg)
        w_cell = cb.mask[:, None, None, None, None, None]
        acc += torch.sum(w_cell * value, dim=(0, 5))
    return PREFACTOR * species.degeneracy[:, None, None, None] * acc


def engine_inputs(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                  grids: MomentumGrids, cfg: Config, device, report=None):
    """Per-cell tensors, species and grid on ``device``.  ``report`` (a
    report.RunReport) collects the skipped-cell count."""
    cells = prepare_cells(surf, cfg, device)
    if report is not None:
        report.n_cells = surf.n_cells
        report.skipped_cells = surf.n_cells - int(cells.mask.sum().item())
    return (cells, SpeciesArrays.from_table(species_table, chosen_idx, device),
            MomentumGridDevice.from_grids(grids, device))


def df12_state(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
               grids: MomentumGrids, df_data: DeltafData, cfg: Config,
               device, report=None):
    """Cells, coefficient columns, species and grid on ``device``:
    everything the df 1/2 engines take."""
    cells, species, grid = engine_inputs(surf, species_table, chosen_idx,
                                         grids, cfg, device, report)
    return cells, df12_cell_coefficients(cells, df_data, cfg), species, grid


def uses_feqmod_kernel(cfg: Config) -> bool:
    """df 3/4/5 through kernel B3 (as is3d2_tpu/core/spectra.py:428-442 and
    :449-465 choose its Pallas kernel or XLA fast path): always with
    use_pallas = 1, and for f32/f32c unless use_pallas = 0."""
    return cfg.use_pallas == 1 or (cfg.compute_dtype in ("f32", "f32c")
                                   and cfg.use_pallas != 0)


def compute_spectra(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                    grids: MomentumGrids, df_data: DeltafData, cfg: Config,
                    device, laguerre=None, report=None) -> np.ndarray:
    """Continuous spectra dN/(pT dpT dphi dy), shape (S, NpT, Nphi, Ny).

    df 1/2, routed as the JAX package routes one device
    (is3d2_tpu/core/spectra.py:354-389): "f32" and "f32c" run the
    compensated kernel B1; "f64" runs the plain-f32 kernel B2 with
    use_pallas = 1 and the torch f64 engine otherwise.  df 3/4 (``laguerre``
    needed): the feqmod prep,
    then kernel B3 (see uses_feqmod_kernel) or the torch f64 feqmod engine.
    df 5: the famod prep (the VAH reconstruction, or a mode-2/3 surface's
    own variables), then kernel B3's famod mode (the same routes) or the
    torch f64 famod engine.  A kernel runs as CUDA on a GPU device and as
    its plain version on the CPU.

    With cfg.group_particles, species within particle_diff_tolerance in
    mass (same sign, and baryon number with baryons on) share one spectra
    evaluation on every route, rescaled by degeneracy
    (SpeciesTable.group_species; is3d2_tpu/core/spectra.py:310-321).
    """
    cfg.validate_slice()
    if cfg.group_particles and len(chosen_idx) > 1:
        chosen_idx = np.asarray(chosen_idx)
        rep_pos, group_of = species_table.group_species(
            chosen_idx, cfg.particle_diff_tolerance, bool(cfg.include_baryon))
        if len(rep_pos) < len(chosen_idx):
            rep_out = compute_spectra(
                surf, species_table, chosen_idx[rep_pos], grids, df_data,
                dataclasses.replace(cfg, group_particles=0), device,
                laguerre, report)
            deg = species_table.gspin[chosen_idx]
            scale = deg / deg[rep_pos][group_of]
            return rep_out[group_of] * scale[:, None, None, None]
    if cfg.df_mode == 5:
        from .spectra_famod import famod_state, spectra_famod
        state = famod_state(surf, species_table, chosen_idx, grids, cfg,
                            device, report)
        if uses_feqmod_kernel(cfg):
            from ..ops.cooper_frye_feqmod import compute_spectra_famod_kernel
            out = compute_spectra_famod_kernel(*state, cfg)
        else:
            out = spectra_famod(*state, cfg)
        return out.cpu().numpy()
    if cfg.df_mode in (3, 4):
        from .spectra_feqmod import feqmod_state, spectra_feqmod
        state = feqmod_state(surf, species_table, chosen_idx, grids, df_data,
                             cfg, device, laguerre, report)
        if uses_feqmod_kernel(cfg):
            from ..ops.cooper_frye_feqmod import compute_spectra_feqmod_kernel
            out = compute_spectra_feqmod_kernel(*state, cfg)
        else:
            out = spectra_feqmod(*state, cfg)
        return out.cpu().numpy()
    state = df12_state(surf, species_table, chosen_idx, grids, df_data, cfg,
                       device, report)
    # use_pallas = -1 means "the kernel" in the port on any device (on the
    # CPU, its plain version), where the JAX package runs its XLA fast
    # paths on the CPU backend; validate_slice rejects use_pallas = 0 with
    # f32/f32c (those XLA paths are not ported)
    if cfg.compute_dtype in ("f32", "f32c"):
        from ..ops.spectra_fast_common import compute_spectra_comp
        out = compute_spectra_comp(*state, cfg)
    elif cfg.use_pallas == 1:
        from ..ops.spectra_fast_common import compute_spectra_f32
        out = compute_spectra_f32(*state, cfg)
    else:
        out = spectra_df12(*state, cfg)
    return out.cpu().numpy()
