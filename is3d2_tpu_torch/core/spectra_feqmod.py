"""Continuous spectra with modified equilibrium distributions (df 3 PTM /
4 PTB), 2+1d and 3+1d: the torch f64 engine.

Counterpart of is3d2_tpu/core/spectra_feqmod.py
(calculate_dN_pTdpTdphidy_feqmod, MomentumSpectra.cpp:419-1044).  Both the
feqmod branch and the linearised-df breakdown fallback are computed for
every point and where-selected by the per-cell breakdown mask (in 3+1d
also by the narrow |y - eta| < detA window), the reference's
data-dependent branch (MomentumSpectra.cpp:863-929).  It is the port's
f64 yardstick for kernel B3 (ops/cooper_frye_feqmod.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config
from ..io.pdg import SpeciesTable
from ..io.tables import GaussLaguerre, MomentumGrids
from ..physics.deltaf import DeltafData
from ..tracing import span
from .cells import CellArrays
from .feqmod import FeqmodCellData, prepare_feqmod
from .spectra import (_F64_BLOCK_ELEMENTS, PREFACTOR, MomentumGridDevice,
                      SpeciesArrays, engine_inputs)

f64 = torch.float64


def _C(a):  # cell scalar -> (c,1,1,1,1,1)
    return a[:, None, None, None, None, None]


def _solve_pmod(fq: FeqmodCellData, px_lrf, py_lrf, pz_lrf, n_refine: int = 2):
    """p_mod = A^-1 p with iterative refinement
    (MomentumSpectra.cpp:954-971; refinement makes the f64 solve exact)."""
    Ai = fq.Ainv  # (c,3,3)

    def matvec(m, x, y, z):
        return (_C(m[:, 0, 0]) * x + _C(m[:, 0, 1]) * y + _C(m[:, 0, 2]) * z,
                _C(m[:, 1, 0]) * x + _C(m[:, 1, 1]) * y + _C(m[:, 1, 2]) * z,
                _C(m[:, 2, 0]) * x + _C(m[:, 2, 1]) * y + _C(m[:, 2, 2]) * z)

    def Amatvec(x, y, z):
        return (_C(fq.Axx) * x + _C(fq.Axy) * y + _C(fq.Axz) * z,
                _C(fq.Axy) * x + _C(fq.Ayy) * y + _C(fq.Ayz) * z,
                _C(fq.Axz) * x + _C(fq.Ayz) * y + _C(fq.Azz) * z)

    mx, my, mz = matvec(Ai, px_lrf, py_lrf, pz_lrf)
    for _ in range(n_refine):
        rx, ry, rz = Amatvec(mx, my, mz)
        dx, dy, dz = px_lrf - rx, py_lrf - ry, pz_lrf - rz
        cx, cy, cz = matvec(Ai, dx, dy, dz)
        mx, my, mz = mx + cx, my + cy, mz + cz
    return mx, my, mz


def feqmod_weighted_value(c: CellArrays, fq: FeqmodCellData,
                          species: SpeciesArrays, grid: MomentumGridDevice,
                          cfg: Config, dan_weighted: bool = False):
    """Weighted integrand on axes (c,s,p,f,y,e) for df modes 3/4.

    ``dan_weighted`` selects the convention of p.dsigma: the momentum
    spectra's w_eta (pt dat + px dax + py day) + pn dan, where the dan term
    carries no eta weight (MomentumSpectra.cpp:883/936), or the spacetime
    distributions', where w_eta multiplies all four terms
    (SpacetimeDistribution.cpp:1022/1075).  In 3+1d both branches take
    delta = y - eta_cell, with no eta rescale and no eta weight (so the
    two conventions agree), and a cell with detA < 0.01 takes the
    breakdown branch at every y within detA of its eta
    (MomentumSpectra.cpp:863-871)."""

    def S(a):
        return a[None, :, None, None, None, None]

    tau2 = c.tau * c.tau
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)  # (s,p)
    mT6 = mT[None, :, :, None, None, None]
    px = (grid.pT[:, None] * grid.cos_phi[None, :])[None, None, :, :, None, None]
    py = (grid.pT[:, None] * grid.sin_phi[None, :])[None, None, :, :, None, None]

    if cfg.dimension == 2:
        eta = grid.eta[None, :]                               # (1,e)
        delta_break = -eta.expand(c.tau.shape[0], eta.shape[1])
        delta_mod = -(fq.eta_scale[:, None] * eta)            # (c,e)
        d_break = delta_break[:, None, None, None, None, :]
        d_mod = delta_mod[:, None, None, None, None, :]
        w_eta = grid.eta_weight[None, None, None, None, None, :]
    else:
        delta = grid.y[None, :, None] - c.eta[:, None, None]  # (c,y,e=1)
        d_break = d_mod = delta[:, None, None, None, :, :]
        w_eta = torch.ones((1, 1, 1, 1, 1, 1), dtype=f64, device=c.tau.device)

    sgn = S(species.sign)
    b_s = S(species.baryon)
    m2 = S(species.mass ** 2)
    chem = b_s * _C(c.alphaB)
    chem_mod = b_s * _C(fq.alphaB_mod)

    def p_dsigma(pt, pn):
        if dan_weighted:
            return w_eta * (pt * _C(c.dat) + px * _C(c.dax) + py * _C(c.day)
                            + pn * _C(c.dan))
        return w_eta * (pt * _C(c.dat) + px * _C(c.dax) + py * _C(c.day)) \
            + pn * _C(c.dan)

    # ---------------- breakdown (linearised df) branch -------------------
    sinh_b = torch.sinh(d_break)
    cosh_b = torch.sqrt(1.0 + sinh_b * sinh_b)
    pt_b = mT6 * cosh_b
    pn_b = mT6 / _C(c.tau) * sinh_b

    pdd_b = p_dsigma(pt_b, pn_b)
    pdotu_b = (pt_b * _C(c.ut) - px * _C(c.ux) - py * _C(c.uy)
               - pn_b * _C(tau2 * c.un))

    pimunu_pp = (_C(c.pitt) * pt_b * pt_b + _C(c.pixx) * px * px
                 + _C(c.piyy) * py * py + _C(tau2 * tau2 * c.pinn) * pn_b * pn_b
                 + 2.0 * (-(_C(c.pitx) * px + _C(c.pity) * py) * pt_b
                          + _C(c.pixy) * px * py
                          + _C(tau2) * pn_b * (_C(c.pixn) * px + _C(c.piyn) * py
                                               - _C(c.pitn) * pt_b)))

    if cfg.df_mode == 3:
        feq = 1.0 / (torch.exp(pdotu_b / _C(c.T) - chem) + sgn)
        feqbar = 1.0 - sgn * feq
        V_pp = (pt_b * _C(c.Vt) - px * _C(c.Vx) - py * _C(c.Vy)
                - pn_b * _C(tau2 * c.Vn))
        df_shear = _C(fq.shear_coeff) * pimunu_pp / pdotu_b
        df_bulk = (_C(fq.bulk0) * pdotu_b + _C(fq.bulk1) * b_s
                   + _C(fq.bulk2) * (pdotu_b - m2 / pdotu_b)) * _C(fq.bulkPi)
        df_diff = ((_C(c.baryon_enthalpy_ratio) - b_s / pdotu_b) * V_pp
                   / _C(fq.betaV))
        df = feqbar * (df_shear + df_bulk + df_diff)
    else:  # PTB: feq with no chemical potential (MomentumSpectra.cpp:913)
        feq = 1.0 / (torch.exp(pdotu_b / _C(c.T)) + sgn)
        feqbar = 1.0 - sgn * feq
        df_shear = feqbar * _C(fq.shear_coeff) * pimunu_pp / pdotu_b
        df_bulk = _C(fq.delta_z) - 3.0 * _C(fq.delta_lambda) \
            + feqbar * _C(fq.delta_lambda) * (pdotu_b - m2 / pdotu_b) / _C(c.T)
        df = df_shear + df_bulk

    if cfg.regulate_deltaf:
        df = torch.clamp(df, -1.0, 1.0)
    f_break = feq * (1.0 + df)
    if cfg.outflow:
        pdd_b = torch.where(pdd_b > 0.0, pdd_b, 0.0)
    value_break = pdd_b * f_break

    # ---------------- feqmod branch ---------------------------------------
    sinh_m = torch.sinh(d_mod)
    cosh_m = torch.sqrt(1.0 + sinh_m * sinh_m)
    pt_m = mT6 * cosh_m
    pn_m = mT6 / _C(c.tau) * sinh_m

    pdd_m = p_dsigma(pt_m, pn_m)

    tau2_pn = _C(tau2) * pn_m
    px_lrf = (-_C(fq.Xt) * pt_m + _C(fq.Xx) * px + _C(fq.Xy) * py
              + _C(fq.Xn) * tau2_pn)
    py_lrf = _C(fq.Yx) * px + _C(fq.Yy) * py
    pz_lrf = -_C(fq.Zt) * pt_m + _C(fq.Zn) * tau2_pn

    mx, my, mz = _solve_pmod(fq, px_lrf, py_lrf, pz_lrf)
    E_mod = torch.sqrt(m2 + mx * mx + my * my + mz * mz)

    renorm = fq.renorm.abs()[:, :, None, None, None, None]
    renorm = torch.where(torch.isfinite(renorm), renorm, 0.0)
    f_mod = renorm / (torch.exp(E_mod / _C(fq.T_mod) - chem_mod) + sgn)
    if cfg.outflow:
        pdd_m = torch.where(pdd_m > 0.0, pdd_m, 0.0)
    value_mod = pdd_m * f_mod

    # ---------------- branch selection -----------------------------------
    use_break = _C(fq.breaks_down)
    if cfg.dimension == 3:
        use_break = use_break | narrow_window(fq.detA, d_break)
    # a nan/inf renorm makes the reference skip the species entirely
    # (MomentumSpectra.cpp:828-832), so both branches are zeroed there
    finite = torch.isfinite(fq.renorm)[:, :, None, None, None, None]
    return torch.where(use_break, value_break, value_mod) * finite


def narrow_window(det: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The 3+1d fallback of a nearly singular transformation
    (MomentumSpectra.cpp:863-871): det < 0.01 and |y - eta| < det, in f64,
    for the cells' ``det`` (detA, famod's detB) and ``delta`` = y - eta on
    (c, ...) axes."""
    d = det.reshape(-1, *([1] * (delta.dim() - 1)))
    return (d < 0.01) & (delta.abs() < d)


def spectra_feqmod(cells: CellArrays, fq: FeqmodCellData,
                   species: SpeciesArrays, grid: MomentumGridDevice,
                   cfg: Config) -> torch.Tensor:
    """The torch f64 feqmod engine: (S, NpT, Nphi, 1) spectra, summed over
    cell blocks of at most _F64_BLOCK_ELEMENTS integrand points."""
    S = species.mass.shape[0]
    shape = (S, grid.pT.shape[0], grid.cos_phi.shape[0], grid.y.shape[0])
    per_cell = math.prod(shape) * grid.eta.shape[0]
    C = cells.n_padded
    blk = max(1, min(C, _F64_BLOCK_ELEMENTS // per_cell))
    acc = torch.zeros(shape, dtype=f64, device=cells.tau.device)
    for i in range(0, C, blk):
        cb = CellArrays(**{f.name: getattr(cells, f.name)[i:i + blk]
                           for f in dataclasses.fields(cells)})
        fb = FeqmodCellData(**{f.name: getattr(fq, f.name)[i:i + blk]
                               for f in dataclasses.fields(fq)})
        value = feqmod_weighted_value(cb, fb, species, grid, cfg)
        acc += torch.sum(_C(cb.mask) * value, dim=(0, 5))
    return PREFACTOR * species.degeneracy[:, None, None, None] * acc


def feqmod_state(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                 grids: MomentumGrids, df_data: DeltafData, cfg: Config,
                 device, laguerre: GaussLaguerre, report=None):
    """Cells, feqmod prep, species and grid on ``device``: everything the
    df 3/4 engines take.  ``report`` collects the skipped- and
    breakdown-cell counts."""
    cells, species, grid = engine_inputs(surf, species_table, chosen_idx,
                                         grids, cfg, device, report)
    with span("cell_physics"):
        fq = prepare_feqmod(cells, species, df_data, cfg, laguerre)
        if report is not None:
            report.record_breakdown(fq.breaks_down, cells.tau, cells.mask)
    return cells, fq, species, grid
