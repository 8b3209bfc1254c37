"""Thermal-vorticity spin polarization S^mu(p) of a mode-5 surface.

Counterpart of is3d2_tpu/core/polarization.py (the reference's
calculate_spin_polzn, Polarization.cpp:25-263): the Cooper-Frye weighted
polarization vector

    S_mu(p) ~ -(1/8m) (1 - sign f0) 2 (wbar wedge p)_mu

summed per (species, pT, phi, y) with its normalization Sum p.dsigma f0.
As in the JAX package:

  * the temperature is the surface-averaged one (the reference's
    Plasma::temperature), not the cell's;
  * every real cell counts, those with u.dsigma <= 0 too (``pad_mask``,
    not the spectra's ``mask``);
  * the eta weights carry the factor delta_eta = eta[1] - eta[0]
    (Polarization.cpp:68);
  * the species are never grouped: the driver hands over the whole chosen
    list even with group_particles = 1.

In 3+1d (dimension 3) each (cell, y) pair is one term: the cell's eta
enters through y - eta_cell, and there is no eta quadrature, so no eta
weight and no delta_eta (the JAX package's w_eta = 1).

Routes: ``compute_dtype`` "f32" and "f32c" run kernel P1
(ops/polarization_f32.py: CUDA on a GPU, its plain torch version on the
CPU), in 2+1d on the eta >= 0 half of the nodes where
``fold_polarization_eta`` allows it, in 3+1d in its 3+1d mode
(``compute_polarization_kernel_3d``); "f64" runs ``polarization_f64``,
the torch f64 engine on (cell block, species, pT, phi, eta or y)
tensors, never folded: it is the yardstick.  ``use_pallas`` selects
nothing here, as in the JAX package (is3d2_tpu/core/polarization.py:116-128).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config
from ..io.pdg import SpeciesTable
from ..io.surface import ThermoAverages
from ..io.tables import MomentumGrids
from .cells import CellArrays, prepare_cells
from .spectra import MomentumGridDevice, SpeciesArrays
from .spectra_fast import fold_eta_table

# elements of one (cells x species x pT x phi x eta) f64 block of the f64
# engine, as the spectra's f64 engine bounds its working set
_F64_BLOCK_ELEMENTS = 1 << 22


def delta_eta(grids: MomentumGrids) -> float:
    """The factor on the eta weights: eta[1] - eta[0] (1 for one node)."""
    return float(grids.eta[1] - grids.eta[0]) if len(grids.eta) > 1 else 1.0


def fold_polarization_eta(cells: CellArrays, grid: MomentumGridDevice,
                          cfg: Config) -> tuple[MomentumGridDevice, bool]:
    """The polarization's eta fold: (the folded grid, True) where it is
    exact, else (``grid``, False).

    With un = 0 and dsigma_eta = 0, u.p, p.dsigma, f0 and the weight are
    even in eta; so is S_n.  The only odd parts are the pn terms of S_t,
    S_x and S_y (wxy pn, wty pn, wtx pn), which cancel over symmetric
    nodes: the eta >= 0 half with doubled weights, and those terms
    dropped, gives the full quadrature.  Gate: cfg.dimension == 2,
    cfg.eta_fold != 0, at least 2 nodes, a symmetric node and weight
    table, max |un| == 0 and max |dsigma_eta| == 0.  Unlike the spectra's
    gate (core/spectra_fast.py::fold_eta_quadrature) the shear and
    diffusion sources do not matter: the polarization takes f_eq only.
    ``delta_eta`` is read off the unfolded table, before this call."""
    if cfg.eta_fold == 0 or cfg.dimension != 2:
        return grid, False
    folded = fold_eta_table(grid)
    if folded is None:
        return grid, False
    mx = torch.stack([cells.un.abs().max(), cells.dan.abs().max()])
    if mx.cpu().tolist() != [0.0, 0.0]:
        return grid, False
    return folded, True


def _cell_block_polzn(c: CellArrays, species: SpeciesArrays,
                      grid: MomentumGridDevice, T: float,
                      d_eta: float, dimension: int = 2) -> torch.Tensor:
    """The JAX _cell_block_polzn: in 2+1d (5, S, NpT, Nphi) sums over the
    block's cells and the eta nodes of (St, Sx, Sy, Sn, Snorm); in 3+1d
    (5, S, NpT, Nphi, Ny) sums over the block's cells, the last axis
    y - eta_cell and no eta weight."""
    def C(a):   # cell scalar -> (c, 1, 1, 1, 1)
        return a[:, None, None, None, None]

    def S(a):   # species scalar -> (1, s, 1, 1, 1)
        return a[None, :, None, None, None]

    tau2 = c.tau * c.tau
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)
    mT5 = mT[None, :, :, None, None]
    px = (grid.pT[:, None] * grid.cos_phi[None, :])[None, None, :, :, None]
    py = (grid.pT[:, None] * grid.sin_phi[None, :])[None, None, :, :, None]

    if dimension == 2:
        sinh_d = torch.sinh(-grid.eta)[None, None, None, None, :]   # y = 0
        w_eta = (grid.eta_weight * d_eta)[None, None, None, None, :]
        dims = (0, 4)
    else:
        sinh_d = torch.sinh(grid.y[None, :] - c.eta[:, None])[
            :, None, None, None, :]
        w_eta = 1.0
        dims = (0,)
    cosh_d = torch.sqrt(1.0 + sinh_d * sinh_d)
    pt = mT5 * cosh_d
    pn = mT5 / C(c.tau) * sinh_d

    pdd = pt * C(c.dat) + px * C(c.dax) + py * C(c.day) + pn * C(c.dan)
    pdotu = pt * C(c.ut) - px * C(c.ux) - py * C(c.uy) - pn * C(tau2 * c.un)

    sgn = S(species.sign)
    f0 = 1.0 / (torch.exp(pdotu / T) + sgn)

    pref = -(1.0 / (8.0 * S(species.mass))) * (1.0 - sgn * f0) * 2.0
    spin_t = pref * (C(c.wxy) * pn - C(c.wxn) * py + C(c.wyn) * px)
    spin_x = pref * (C(c.wyn) * pt - C(c.wtn) * py + C(c.wty) * pn)
    spin_y = pref * (-C(c.wxn) * pt + C(c.wtn) * px - C(c.wtx) * pn)
    spin_n = pref * (C(c.wtx) * py + C(c.wxy) * pt - C(c.wty) * px)

    w = w_eta * C(c.pad_mask) * pdd * f0
    return torch.stack([torch.sum(w * v, dim=dims)
                        for v in (spin_t, spin_x, spin_y, spin_n)]
                       + [torch.sum(w, dim=dims)])


def polarization_f64(cells: CellArrays, species: SpeciesArrays,
                     grid: MomentumGridDevice, T: float,
                     d_eta: float, dimension: int = 2) -> torch.Tensor:
    """The torch f64 engine: (5, S, NpT, Nphi, Ny) raw sums (Ny = 1 in
    2+1d), cell blocks of at most _F64_BLOCK_ELEMENTS integrand points
    added in order.  ``d_eta`` is not read in 3+1d."""
    shape = (species.mass.shape[0], grid.pT.shape[0], grid.cos_phi.shape[0])
    n_y = grid.y.shape[0] if dimension == 3 else 1
    per_cell = math.prod(shape) * (n_y if dimension == 3
                                   else grid.eta.shape[0])
    C = cells.n_padded
    blk = max(1, min(C, _F64_BLOCK_ELEMENTS // per_cell))
    acc = torch.zeros((5, *shape) + ((n_y,) if dimension == 3 else ()),
                      dtype=torch.float64, device=cells.tau.device)
    for i in range(0, C, blk):
        cb = CellArrays(**{f.name: getattr(cells, f.name)[i:i + blk]
                           for f in dataclasses.fields(cells)})
        acc += _cell_block_polzn(cb, species, grid, T, d_eta, dimension)
    return acc if dimension == 3 else acc[..., None]


def polarization_state(surf, species_table: SpeciesTable,
                       chosen_idx: np.ndarray, grids: MomentumGrids,
                       cfg: Config, device):
    """Cells, species and grid on ``device``: what both routes take."""
    return (prepare_cells(surf, cfg, device),
            SpeciesArrays.from_table(species_table, chosen_idx, device),
            MomentumGridDevice.from_grids(grids, cfg.dimension, device))


def compute_polarization(surf, species_table: SpeciesTable,
                         chosen_idx: np.ndarray, grids: MomentumGrids,
                         plasma: ThermoAverages, cfg: Config, device,
                         mesh=None):
    """Returns (St, Sx, Sy, Sn, Snorm), each (S, NpT, Nphi, Ny) f64 numpy
    raw sums (Ny = 1 in 2+1d); the polarization is S^mu / Snorm
    (io/output.py::write_polarization).  Under ``mesh`` (the driver's,
    parallel/sharding.py::auto_mesh of cfg.use_mesh) the cells are cut over
    its devices."""
    cells, species, grid = polarization_state(surf, species_table,
                                              chosen_idx, grids, cfg, device)
    T = float(plasma.temperature)
    d_eta = delta_eta(grids)   # of the unfolded table
    if mesh is not None:
        from ..parallel import sharding
        # is3d2_tpu/core/polarization.py:113-125: P1 (or its 3+1d mode)
        # with the cells over "cells", the f64 engine over the whole mesh
        meshed = (sharding.sharded_polarization_fast
                  if cfg.compute_dtype in ("f32", "f32c")
                  else sharding.sharded_polarization)
        acc = meshed(cells, species, grid, T, cfg, mesh, delta_eta=d_eta)
    elif cfg.compute_dtype in ("f32", "f32c") and cfg.dimension == 3:
        from ..ops.polarization_f32 import compute_polarization_kernel_3d
        acc = compute_polarization_kernel_3d(cells, species, grid, T)
    elif cfg.compute_dtype in ("f32", "f32c"):
        from ..ops.polarization_f32 import compute_polarization_kernel
        grid, folded = fold_polarization_eta(cells, grid, cfg)
        acc = compute_polarization_kernel(cells, species, grid, T, d_eta,
                                          folded)
    else:
        acc = polarization_f64(cells, species, grid, T, d_eta,
                               cfg.dimension)
    out = acc.cpu().numpy()
    return out[0], out[1], out[2], out[3], out[4]
