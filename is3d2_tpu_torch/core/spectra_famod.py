"""Continuous spectra with the modified anisotropic distribution (df 5,
famod), 2+1d.

Counterpart of is3d2_tpu/core/spectra_famod.py
(calculate_dN_pTdpTdphidy_famod, MomentumSpectra.cpp:1049-1682): the
per-cell anisotropic reconstruction (physics/aniso.py), the famod
coefficients, the deformation matrix B = C.A and its inverse, and the torch
f64 famod engine with its famod / f_eq-fallback branches, the port's
yardstick for kernel B3's famod mode (ops/cooper_frye_feqmod.py).

The prep runs on one route: f64 on the run's device, cell-blocked.  The
JAX package's f32 route (an f32 Newton, one f64 chord step and mixed-
precision coefficients, ``_reconstruct_f64_jit``) works around software
f64 on a TPU and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..config import Config
from ..io.pdg import SpeciesTable
from ..io.tables import MomentumGrids
from ..physics import lrf
from ..physics.aniso import (compute_famod_coefficients,
                             find_anisotropic_variables)
from .cells import CellArrays, prepare_cells
from .spectra import (_F64_BLOCK_ELEMENTS, PREFACTOR, MomentumGridDevice,
                      SpeciesArrays)

f64 = torch.float64

# cells of one reconstruction block: one (cells x 320 species x 16 nodes)
# f64 intermediate of the Newton is ~335 MB at 8,192 cells
RECON_BLOCK_CELLS = 8192
MAX_RECON_SPECIES = 320


@dataclasses.dataclass
class FamodCellData:
    """Per-cell famod quantities, (c,) f64 unless noted."""

    Xt: torch.Tensor
    Xx: torch.Tensor
    Xy: torch.Tensor
    Xn: torch.Tensor
    Yx: torch.Tensor
    Yy: torch.Tensor
    Zt: torch.Tensor
    Zn: torch.Tensor
    lam: torch.Tensor
    aT: torch.Tensor
    aL: torch.Tensor
    upsilonB: torch.Tensor
    # B matrix (symmetric) and inverse
    Bxx: torch.Tensor
    Bxy: torch.Tensor
    Bxz: torch.Tensor
    Byy: torch.Tensor
    Byz: torch.Tensor
    Bzz: torch.Tensor
    Binv: torch.Tensor          # (c, 3, 3)
    detB: torch.Tensor
    eta_scale: torch.Tensor
    renorm: torch.Tensor        # eta_scale / detC
    breaks_down: torch.Tensor   # bool
    # diagnostics (MONITOR_FAMOD counters, MomentumSpectra.cpp:1674-1678)
    pl_negative: torch.Tensor   # bool: pl < 0 or pt < 0
    recon_failed: torch.Tensor  # bool: Newton reconstruction failure


@dataclasses.dataclass
class Reconstruction:
    """What the prep's reconstruction did: host seconds (device work
    finished), the Newton iterations of the longest block (0 for a VAH
    surface, which needs none), the cell blocks, and the cells iterated
    summed over the iterations (the Newton's work)."""

    seconds: float = 0.0
    newton_iterations: int = 0
    blocks: int = 0
    lane_iterations: int = 0    # cells iterated, summed over iterations


def reconstruction_species(table: SpeciesTable, device):
    """The (<= 320)-entry PDG species set the reference feeds the VAH
    solver (MomentumSpectra.cpp:1295): (mass, sign, degeneracy) f64."""
    n = min(MAX_RECON_SPECIES, len(table))

    def t(a):
        return torch.as_tensor(np.asarray(a[:n]), dtype=f64, device=device)
    return t(table.mass), t(table.sign), t(table.gspin)


def solver_species(table: SpeciesTable, device):
    """reconstruction_species with the species of equal (mass, sign)
    merged into one entry of summed degeneracy, in order of first
    appearance.  The solver's integrals are degeneracy-weighted sums over
    species of a function of (mass, sign) alone, so the merge changes only
    the order of the additions; antiparticles and isospin multiplets of
    one mass make the synthetic list's first 320 species 141 entries."""
    merged: dict = {}    # (mass, sign) -> degeneracy, in first order
    for m, sg, g in zip(*(t.tolist() for t in
                          reconstruction_species(table, "cpu"))):
        merged[m, sg] = merged.get((m, sg), 0.0) + g
    mass, sign = zip(*merged)

    def t(a):
        return torch.as_tensor(a, dtype=f64, device=device)
    return t(mass), t(sign), t(list(merged.values()))


def vah_from_surface(surf, n_padded: int, device):
    """A legacy VAH surface's (Lambda, aT, aL, upsilonB) columns (surface
    modes 2/3, readindata.cu:812-1055) padded for prepare_famod, upsilonB
    [GeV] turned into the dimensionless upsilonB / Lambda of f_a; None for
    a surface without them."""
    if not getattr(surf, "has_aniso_variables", False):
        return None
    n = surf.n_cells

    def pad(a, fill):
        out = np.full(n_padded, fill, dtype=np.float64)
        out[:n] = a
        return torch.as_tensor(out, device=device)

    lam = np.asarray(surf.Lambda, dtype=np.float64)
    ups = np.zeros(n) if surf.upsilonB is None else np.asarray(surf.upsilonB)
    return {"lam": pad(lam, 1.0), "aT": pad(surf.aT, 1.0),
            "aL": pad(surf.aL, 1.0),
            "upsilonB_over_lam": pad(ups / np.maximum(lam, 1e-300), 0.0)}


def lrf_pressures(c: CellArrays):
    """(Milne basis, LRF shear, pl, pt) of the cells: the longitudinal and
    transverse pressures the reconstruction matches (MomentumSpectra.cpp:
    1192-1204)."""
    basis = lrf.milne_basis(c.tau, c.ux, c.uy, c.un)
    pi = lrf.boost_shear(basis, c.tau, c.pitt, c.pitx, c.pity, c.pitn,
                         c.pixx, c.pixy, c.pixn, c.piyy, c.piyn, c.pinn)
    return basis, pi, c.P + c.bulkPi + pi.zz, c.P + c.bulkPi - pi.zz / 2.0


def _blocks(n: int, blk: int = RECON_BLOCK_CELLS):
    return [(i, min(i + blk, n)) for i in range(0, n, blk)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reconstruct(E, pl, pt, T, mass, sign, deg, stats: Reconstruction):
    """The batched Newton from the equilibrium guess (lambda = T, aT = aL =
    1) and the famod coefficients at its solution, RECON_BLOCK_CELLS cells
    at a time; ``stats`` gets the longest block's iterations."""
    out = {k: [] for k in ("lam", "aT", "aL", "failed", "bpp", "bwp")}
    for i, j in _blocks(E.shape[0]):
        one = torch.ones_like(T[i:j])
        s = find_anisotropic_variables(E[i:j], pl[i:j], pt[i:j], T[i:j],
                                       one, one, mass, sign, deg)
        bpp, bwp = compute_famod_coefficients(s.lam, s.aT, s.aL, mass, sign,
                                              deg)
        for k, v in zip(out, (s.lam, s.aT, s.aL, s.failed, bpp, bwp)):
            out[k].append(v)
        stats.newton_iterations = max(stats.newton_iterations, s.iterations)
        stats.lane_iterations += s.lane_iterations
        stats.blocks += 1
    return {k: torch.cat(v) for k, v in out.items()}


def famod_coefficients(lam, aT, aL, mass, sign, deg, stats: Reconstruction):
    """compute_famod_coefficients, RECON_BLOCK_CELLS cells at a time."""
    bpp, bwp = [], []
    for i, j in _blocks(lam.shape[0]):
        a, b = compute_famod_coefficients(lam[i:j], aT[i:j], aL[i:j], mass,
                                          sign, deg)
        bpp.append(a)
        bwp.append(b)
        stats.blocks += 1
    return torch.cat(bpp), torch.cat(bwp)


def prepare_famod(cells: CellArrays, species_table: SpeciesTable,
                  cfg: Config, vah: dict | None = None,
                  stats: Reconstruction | None = None) -> FamodCellData:
    """VAH reconstruction and famod cell data, in f64 on the cells' device
    (the body of the JAX package's _prepare_famod_body).

    (lambda, aT, aL) come from ``vah`` (vah_from_surface: a legacy VAH
    surface, no Newton; a non-positive variable is a failure) or from the
    Newton (a failed or pl/pt < 0 cell breaks down, and upsilonB is the
    cell's alphaB).  ``stats`` collects the reconstruction's seconds and
    iterations."""
    stats = stats if stats is not None else Reconstruction()
    c = cells
    dev = c.tau.device
    mass, sign, deg = solver_species(species_table, dev)
    t0 = time.perf_counter()

    basis, pi, pl, pt = lrf_pressures(c)

    if cfg.include_shear_deltaf:
        piTxx = (pi.xx - pi.yy) / 2.0
        piTxy = pi.xy
        piTyy = -piTxx
        WTzx = pi.xz
        WTzy = pi.yz
    else:
        zeros = torch.zeros_like(pl)
        piTxx = piTxy = piTyy = WTzx = WTzy = zeros

    pl_negative = (pl < 0) | (pt < 0)
    if vah is not None:
        # legacy VAH surface: (Lambda, aT, aL) are given (modes 2/3)
        lam, aT, aL = vah["lam"], vah["aT"], vah["aL"]
        recon_failed = (lam <= 0.0) | (aT <= 0.0) | (aL <= 0.0)
        breaks = recon_failed
        upsilonB = vah["upsilonB_over_lam"]
        betapiperp, betaWperp = famod_coefficients(lam, aT, aL, mass, sign,
                                                   deg, stats)
    else:
        # reconstruct from the equilibrium guess; negative (pl, pt) inputs
        # are guarded in the solver and mark breakdown anyway
        s = reconstruct(c.E, pl, pt, c.T, mass, sign, deg, stats)
        recon_failed = s["failed"]
        breaks = recon_failed | pl_negative
        lam, aT, aL = s["lam"], s["aT"], s["aL"]
        upsilonB = c.alphaB
        betapiperp, betaWperp = s["bpp"], s["bwp"]
    shear_coeff = 0.5 / betapiperp
    diff_coeff = 1.0 / betaWperp

    detA = aT * aT * aL

    Cxx = 1.0 + shear_coeff * piTxx
    Cxy = shear_coeff * piTxy
    Cxz = diff_coeff * WTzx * aT / (aT + aL)
    Cyy = 1.0 + shear_coeff * piTyy
    Cyz = diff_coeff * WTzy * aT / (aT + aL)
    Czx = diff_coeff * WTzx * aL / (aT + aL)
    Czy = diff_coeff * WTzy * aL / (aT + aL)
    detC = (Cxx * (Cyy * 1.0 - Cyz * Czy) - Cxy * (Cxy * 1.0 - Cyz * Czx)
            + Cxz * (Cxy * Czy - Cyy * Czx))

    Bxx = aT + aT * shear_coeff * piTxx
    Bxy = aT * shear_coeff * piTxy
    Bxz = diff_coeff * WTzx * aT * aL / (aT + aL)
    Byy = aT + aT * shear_coeff * piTyy
    Byz = diff_coeff * WTzy * aT * aL / (aT + aL)
    Bzz = aL

    detB = detC * detA
    detB_bulk_23 = (2.0 * aT + aL) ** 2 / 9.0

    breaks = breaks | (detB <= cfg.deta_min)

    if cfg.dimension == 2:
        eta_scale = torch.where(detB > cfg.deta_min, detB / detB_bulk_23, 1.0)
    else:
        eta_scale = torch.ones_like(detB)

    detC_safe = torch.where(torch.abs(detC) > 1e-300, detC, 1.0)
    renorm = eta_scale / detC_safe
    breaks = breaks | ~torch.isfinite(renorm)

    # symmetric-B adjugate inverse (reference: GSL LU,
    # MomentumSpectra.cpp:1431-1449)
    c00 = Byy * Bzz - Byz * Byz
    c01 = Bxz * Byz - Bxy * Bzz
    c02 = Bxy * Byz - Bxz * Byy
    c11 = Bxx * Bzz - Bxz * Bxz
    c12 = Bxy * Bxz - Bxx * Byz
    c22 = Bxx * Byy - Bxy * Bxy
    # det of symmetric B equals detB = detC*detA in exact arithmetic
    detB_sym = Bxx * c00 + Bxy * c01 + Bxz * c02
    detB_sym = torch.where(torch.abs(detB_sym) > 1e-300, detB_sym, 1.0)
    Binv = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c01, c11, c12], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2) / detB_sym[:, None, None]

    _sync(dev)
    stats.seconds += time.perf_counter() - t0
    return FamodCellData(
        Xt=basis.Xt, Xx=basis.Xx, Xy=basis.Xy, Xn=basis.Xn,
        Yx=basis.Yx, Yy=basis.Yy, Zt=basis.Zt, Zn=basis.Zn,
        lam=lam, aT=aT, aL=aL, upsilonB=upsilonB,
        Bxx=Bxx, Bxy=Bxy, Bxz=Bxz, Byy=Byy, Byz=Byz, Bzz=Bzz,
        Binv=Binv, detB=detB, eta_scale=eta_scale, renorm=renorm,
        breaks_down=breaks, pl_negative=pl_negative,
        recon_failed=recon_failed)


# ----------------------------------------------------------------------
# the torch f64 famod engine
# ----------------------------------------------------------------------

def _C(a):  # cell scalar -> (c,1,1,1,1,1)
    return a[:, None, None, None, None, None]


def _solve_pmod_B(fm: FamodCellData, px_lrf, py_lrf, pz_lrf,
                  n_refine: int = 2):
    """p_mod = B^-1 p with iterative refinement (the refinement makes the
    f64 solve exact)."""
    Bi = fm.Binv

    def matvec(m, x, y, z):
        return (_C(m[:, 0, 0]) * x + _C(m[:, 0, 1]) * y + _C(m[:, 0, 2]) * z,
                _C(m[:, 1, 0]) * x + _C(m[:, 1, 1]) * y + _C(m[:, 1, 2]) * z,
                _C(m[:, 2, 0]) * x + _C(m[:, 2, 1]) * y + _C(m[:, 2, 2]) * z)

    def Bmatvec(x, y, z):
        return (_C(fm.Bxx) * x + _C(fm.Bxy) * y + _C(fm.Bxz) * z,
                _C(fm.Bxy) * x + _C(fm.Byy) * y + _C(fm.Byz) * z,
                _C(fm.Bxz) * x + _C(fm.Byz) * y + _C(fm.Bzz) * z)

    mx, my, mz = matvec(Bi, px_lrf, py_lrf, pz_lrf)
    for _ in range(n_refine):
        rx, ry, rz = Bmatvec(mx, my, mz)
        cx, cy, cz = matvec(Bi, px_lrf - rx, py_lrf - ry, pz_lrf - rz)
        mx, my, mz = mx + cx, my + cy, mz + cz
    return mx, my, mz


def famod_weighted_value(c: CellArrays, fm: FamodCellData,
                         species: SpeciesArrays, grid: MomentumGridDevice,
                         cfg: Config):
    """Weighted integrand on axes (c,s,p,f,y,e) for df 5, 2+1d: the famod
    branch (MomentumSpectra.cpp:1556-1615) at eta_scale * eta and the f_eq
    fallback at (T, alphaB) with no delta-f (:1538-1554), where-selected per
    cell.  Every term of p.dsigma carries the eta weight."""
    def S(a):
        return a[None, :, None, None, None, None]

    tau2 = c.tau * c.tau
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)
    mT6 = mT[None, :, :, None, None, None]
    px = (grid.pT[:, None] * grid.cos_phi[None, :])[None, None, :, :, None, None]
    py = (grid.pT[:, None] * grid.sin_phi[None, :])[None, None, :, :, None, None]

    eta = grid.eta[None, :]
    d_break = -eta.expand(c.tau.shape[0], eta.shape[1])[:, None, None, None,
                                                          None, :]
    d_mod = -(fm.eta_scale[:, None] * eta)[:, None, None, None, None, :]
    w_eta = grid.eta_weight[None, None, None, None, None, :]

    sgn = S(species.sign)
    b_s = S(species.baryon)
    m2 = S(species.mass ** 2)
    chem = b_s * _C(c.alphaB)
    chem_eff = b_s * _C(fm.upsilonB)

    # f_eq fallback branch
    sinh_b = torch.sinh(d_break)
    cosh_b = torch.sqrt(1.0 + sinh_b * sinh_b)
    pt_b = mT6 * cosh_b
    pn_b = mT6 / _C(c.tau) * sinh_b
    pdd_b = pt_b * _C(c.dat) + px * _C(c.dax) + py * _C(c.day) + pn_b * _C(c.dan)
    u_p = (pt_b * _C(c.ut) - px * _C(c.ux) - py * _C(c.uy)
           - pn_b * _C(tau2 * c.un))
    f_break = 1.0 / (torch.exp(u_p / _C(c.T) - chem) + sgn)
    if cfg.outflow:
        pdd_b = torch.where(pdd_b > 0.0, pdd_b, 0.0)
    value_break = pdd_b * f_break

    # famod branch
    sinh_m = torch.sinh(d_mod)
    cosh_m = torch.sqrt(1.0 + sinh_m * sinh_m)
    pt_m = mT6 * cosh_m
    pn_m = mT6 / _C(c.tau) * sinh_m
    pdd_m = pt_m * _C(c.dat) + px * _C(c.dax) + py * _C(c.day) + pn_m * _C(c.dan)
    tau2_pn = _C(tau2) * pn_m
    px_lrf = (-_C(fm.Xt) * pt_m + _C(fm.Xx) * px + _C(fm.Xy) * py
              + _C(fm.Xn) * tau2_pn)
    py_lrf = _C(fm.Yx) * px + _C(fm.Yy) * py
    pz_lrf = -_C(fm.Zt) * pt_m + _C(fm.Zn) * tau2_pn
    mx, my, mz = _solve_pmod_B(fm, px_lrf, py_lrf, pz_lrf)
    E_mod = torch.sqrt(m2 + mx * mx + my * my + mz * mz)
    renorm = torch.abs(_C(fm.renorm))
    f_mod = renorm / (torch.exp(E_mod / _C(fm.lam) - chem_eff) + sgn)
    if cfg.outflow:
        pdd_m = torch.where(pdd_m > 0.0, pdd_m, 0.0)
    value_mod = pdd_m * f_mod

    return w_eta * torch.where(_C(fm.breaks_down), value_break, value_mod)


def spectra_famod(cells: CellArrays, fm: FamodCellData,
                  species: SpeciesArrays, grid: MomentumGridDevice,
                  cfg: Config) -> torch.Tensor:
    """The torch f64 famod engine (the JAX package's _spectra_famod_jit):
    (S, NpT, Nphi, 1) spectra, summed over cell blocks of at most
    _F64_BLOCK_ELEMENTS integrand points."""
    if cfg.dimension != 2:
        raise ValueError("the famod engine implements 2+1d")
    S = species.mass.shape[0]
    shape = (S, grid.pT.shape[0], grid.cos_phi.shape[0], grid.y.shape[0])
    per_cell = math.prod(shape) * grid.eta.shape[0]
    C = cells.n_padded
    blk = max(1, min(C, _F64_BLOCK_ELEMENTS // per_cell))
    acc = torch.zeros(shape, dtype=f64, device=cells.tau.device)
    for i in range(0, C, blk):
        cb = CellArrays(**{f.name: getattr(cells, f.name)[i:i + blk]
                           for f in dataclasses.fields(cells)})
        fb = FamodCellData(**{f.name: getattr(fm, f.name)[i:i + blk]
                              for f in dataclasses.fields(fm)})
        value = famod_weighted_value(cb, fb, species, grid, cfg)
        acc += torch.sum(_C(cb.mask) * value, dim=(0, 5))
    return PREFACTOR * species.degeneracy[:, None, None, None] * acc


def famod_cells(surf, cfg: Config, device) -> CellArrays:
    """The cells with shear and bulk forced on: famod reads the shear
    tensor and the bulk pressure unconditionally (the pl/pt
    reconstruction, MomentumSpectra.cpp:1192-1204); the include_* switches
    only gate the residual piT / WT pieces of the prep."""
    return prepare_cells(surf, dataclasses.replace(
        cfg, include_shear_deltaf=1, include_bulk_deltaf=1), device)


def famod_state(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                grids: MomentumGrids, cfg: Config, device, report=None):
    """Cells, famod prep, species and grid on ``device``: everything the
    df-5 engines take.  ``report`` collects the skipped, breakdown, pl < 0
    and reconstruction-failure counts and the reconstruction's seconds and
    Newton iterations."""
    cells = famod_cells(surf, cfg, device)
    if report is not None:
        report.n_cells = surf.n_cells
        report.skipped_cells = surf.n_cells - int(cells.mask.sum().item())
    stats = Reconstruction()
    fm = prepare_famod(cells, species_table, cfg,
                       vah_from_surface(surf, cells.n_padded, device), stats)
    if report is not None:
        report.record_breakdown(fm.breaks_down, cells.tau, cells.mask,
                                pl_negative=fm.pl_negative,
                                recon_failed=fm.recon_failed)
        report.reconstruction = stats
    return (cells, fm, SpeciesArrays.from_table(species_table, chosen_idx,
                                                device),
            MomentumGridDevice.from_grids(grids, device))
