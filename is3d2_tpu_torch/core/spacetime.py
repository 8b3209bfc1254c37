"""Spacetime distributions dN/dX (operation 0), 2+1d, df 1-4.

Counterpart of is3d2_tpu/core/spacetime.py (calculate_dN_dX /
calculate_dN_dX_feqmod, SpacetimeDistribution.cpp:31-1250): the momentum
integral of each freezeout cell's Cooper-Frye integrand, contracted with the
(pT, phi) quadrature weights, is the cell's dN/dy; binned by the cell's
(tau, r, phi_s) position it gives dN/(tau dtau dy), dN/(2 pi r dr dy) and
dN/(dphi dy).  Cells outside an axis's range, and cells with
u.dsigma <= 0, are dropped on that axis; bins sum in f64.

Routes (the JAX package's operation 0 ignores use_pallas):

  * f64: the torch f64 engines (df12_weighted_value; feqmod_weighted_value
    with the spacetime distributions' p.dsigma, whose dan term carries the
    eta weight), dN/dy per cell, then binned;
  * f32/f32c: kernel B1 (df 1/2) or kernel B3 in its dan-weighted
    convention (df 3/4).  A kernel sums over the cells it is handed for
    every momentum point, so the cells of each axis are sorted by bin once
    (one gather of the packed operands) and the kernel runs on each
    non-empty bin's run of cells; its (S, pT, phi) result contracted with
    the (pT, phi) weights is the bin.  The JAX package runs its XLA fast
    paths there (ROADMAP C7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..io.pdg import SpeciesTable
from ..io.tables import GaussLaguerre, MomentumGrids
from ..physics.deltaf import DeltafData
from .cells import CellArrays
from .spectra import (_F64_BLOCK_ELEMENTS, PREFACTOR, MomentumGridDevice,
                      SpeciesArrays, df12_state, df12_weighted_value)
from .spectra_feqmod import feqmod_state, feqmod_weighted_value

f64 = torch.float64


@dataclasses.dataclass
class SpacetimeDistributions:
    """Binned dN/dX per chosen species (before binwidth normalization)."""

    tau_mid: np.ndarray
    r_mid: np.ndarray
    phi_mid: np.ndarray
    dN_taudtaudy: np.ndarray   # (S, tau_bins) raw bin sums
    dN_twopirdrdy: np.ndarray  # (S, r_bins)
    dN_dphidy: np.ndarray      # (S, phi_bins)

    def normalized(self, cfg: Config):
        """Apply the reference's binwidth/jacobian normalization
        (SpacetimeDistribution.cpp:449-490)."""
        tau_w, r_w, phi_w = bin_widths(cfg)
        return (
            self.dN_taudtaudy / (self.tau_mid[None, :] * tau_w),
            self.dN_twopirdrdy / (2.0 * np.pi * self.r_mid[None, :] * r_w),
            self.dN_dphidy / phi_w,
        )


def bin_widths(cfg: Config) -> tuple[float, float, float]:
    return ((cfg.tau_max - cfg.tau_min) / cfg.tau_bins,
            (cfg.r_max - cfg.r_min) / cfg.r_bins,
            2.0 * np.pi / cfg.phip_bins)


def bin_indices(cells: CellArrays, cfg: Config) -> list[tuple[np.ndarray, int]]:
    """(bin index per cell, bin count) of the axes tau, r and phi_s
    (SpacetimeDistribution.cpp:413-421), on the host in f64."""
    tau_w, r_w, phi_w = bin_widths(cfg)
    tau, x, y = (t.cpu().numpy() for t in (cells.tau, cells.x, cells.y_pos))
    r = np.sqrt(x**2 + y**2)
    phi = np.arctan2(y, x)
    phi = np.where(phi < 0.0, phi + 2.0 * np.pi, phi)
    return [(np.floor((tau - cfg.tau_min) / tau_w).astype(np.int64),
             cfg.tau_bins),
            (np.floor((r - cfg.r_min) / r_w).astype(np.int64), cfg.r_bins),
            (np.floor(phi / phi_w).astype(np.int64), cfg.phip_bins)]


def binned_cells(idx: np.ndarray, n_bins: int, mask: np.ndarray):
    """The cells of one axis that land in a bin, in bin order (stable), and
    [(bin, begin, end)] of each non-empty bin's run of them."""
    ok = np.nonzero((idx >= 0) & (idx < n_bins) & (mask > 0.0))[0]
    rows = ok[np.argsort(idx[ok], kind="stable")]
    counts = np.bincount(idx[rows], minlength=n_bins)
    ends = np.cumsum(counts)
    runs = [(b, int(ends[b] - counts[b]), int(ends[b]))
            for b in np.nonzero(counts)[0]]
    return rows, runs


def _scatter(dN_cell: torch.Tensor, idx: np.ndarray, n_bins: int,
             mask: np.ndarray) -> torch.Tensor:
    """Sum per-cell dN/dy (C, S) into (S, n_bins) in f64; out-of-range and
    masked cells are dropped (the reference's if-in-range adds)."""
    ok = np.nonzero((idx >= 0) & (idx < n_bins) & (mask > 0.0))[0]
    dev = dN_cell.device
    out = torch.zeros((dN_cell.shape[1], n_bins), dtype=f64, device=dev)
    rows = torch.as_tensor(ok, device=dev)
    return out.index_add_(1, torch.as_tensor(idx[ok], device=dev),
                          dN_cell[rows].T)


def dN_dy_cells(cells: CellArrays, aux, species: SpeciesArrays,
                grid: MomentumGridDevice, cfg: Config) -> torch.Tensor:
    """The f64 route's dN/dy per cell, (C, S): the df 1/2 integrand (``aux``
    the coefficient columns) or the dan-weighted feqmod one (``aux`` the
    feqmod prep), contracted with the (pT, phi) weights, cell block by
    cell block."""
    S = species.mass.shape[0]
    per_cell = (S * grid.pT.shape[0] * grid.cos_phi.shape[0]
                * grid.y.shape[0] * grid.eta.shape[0])
    C = cells.n_padded
    blk = max(1, min(C, _F64_BLOCK_ELEMENTS // per_cell))
    w_pf = (grid.pT_weight[:, None]
            * grid.phi_weight[None, :])[None, None, :, :, None, None]
    out = []
    for i in range(0, C, blk):
        cb = CellArrays(**{f.name: getattr(cells, f.name)[i:i + blk]
                           for f in dataclasses.fields(cells)})
        if isinstance(aux, dict):
            value = df12_weighted_value(
                cb, {k: v[i:i + blk] for k, v in aux.items()}, species,
                grid, cfg)
        else:
            fb = type(aux)(**{f.name: getattr(aux, f.name)[i:i + blk]
                              for f in dataclasses.fields(aux)})
            value = feqmod_weighted_value(cb, fb, species, grid, cfg,
                                          dan_weighted=True)
        out.append(PREFACTOR * species.degeneracy[None, :]
                   * torch.sum(w_pf * value, dim=(2, 3, 4, 5)))
    return torch.cat(out)


def f64_bins(cells: CellArrays, aux, species: SpeciesArrays,
             grid: MomentumGridDevice, cfg: Config) -> list[torch.Tensor]:
    """The f64 route's (S, n_bins) bin sums of the three axes."""
    dN = dN_dy_cells(cells, aux, species, grid, cfg)
    mask = cells.mask.cpu().numpy()
    return [_scatter(dN, idx, n, mask) for idx, n in bin_indices(cells, cfg)]


def kernel_operands(cells: CellArrays, aux, species: SpeciesArrays,
                    grid: MomentumGridDevice, cfg: Config):
    """The packed operands of every cell for the kernel route: B1's
    (df 1/2) or B3's in the dan-weighted convention (df 3/4), eta folded
    where exact."""
    if cfg.df_mode in (1, 2):
        from ..ops.spectra_fast_common import comp_operands
        return comp_operands(cells, aux, species, grid, cfg)
    from ..ops.cooper_frye_feqmod import feqmod_operands
    return feqmod_operands(cells, aux, species, grid, cfg, dan_weighted=True)


def cell_rows(ops, rows):
    """``ops`` with its per-cell operands at ``rows``: an index tensor
    gathers them, a slice cuts a contiguous view."""
    if hasattr(ops, "qm"):
        return dataclasses.replace(ops, cell=ops.cell[rows], qm=ops.qm[rows])
    return dataclasses.replace(ops, cols=ops.cols[rows],
                               renorm=ops.renorm[rows], red=ops.red[rows])


def run_kernel(ops, cfg: Config, plain: bool = False) -> torch.Tensor:
    """The kernel (or, with ``plain``, its plain version) on ``ops``: the
    (M,) f64 sums over its cells."""
    if hasattr(ops, "qm"):
        from ..ops import cooper_frye_comp as ck
        if plain:
            return ck.cooper_frye_comp_plain(*ops.args(), cfg)
        return ck.cooper_frye_comp(*ops.args(), cfg, row_len=ops.row_len)
    from ..ops import cooper_frye_feqmod as fk
    if plain:
        return fk.cooper_frye_feqmod_plain(*ops.args(), cfg, ops.kind,
                                           ops.dan_weighted)
    return fk.cooper_frye_feqmod(*ops.args(), cfg, ops.kind,
                                 row_len=ops.row_len,
                                 dan_weighted=ops.dan_weighted)


def kernel_bins(cells: CellArrays, ops, species: SpeciesArrays,
                grid: MomentumGridDevice, cfg: Config,
                call=run_kernel) -> list[torch.Tensor]:
    """The kernel route's (S, n_bins) f64 bin sums of the three axes:
    ``call(ops of one bin's cells, cfg)`` -> (M,) f64 on each non-empty
    bin, contracted with the (pT, phi) weights."""
    S = species.mass.shape[0]
    w = (grid.pT_weight[:, None] * grid.phi_weight[None, :]).reshape(-1)
    scale = PREFACTOR * species.degeneracy[:, None]
    mask = cells.mask.cpu().numpy()
    out = []
    for idx, n_bins in bin_indices(cells, cfg):
        rows, runs = binned_cells(idx, n_bins, mask)
        sorted_ops = cell_rows(ops, torch.as_tensor(rows, device=w.device))
        acc = torch.zeros((S, n_bins), dtype=f64, device=w.device)
        for b, begin, end in runs:
            flat = call(cell_rows(sorted_ops, slice(begin, end)), cfg)
            acc[:, b] = flat.reshape(S, -1) @ w
        out.append(scale * acc)
    return out


def compute_dN_dX(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                  grids: MomentumGrids, df_data: DeltafData, cfg: Config,
                  device, laguerre: GaussLaguerre | None = None,
                  report=None) -> SpacetimeDistributions:
    """Operation 0 on ``device``: the f64 engines for compute_dtype f64,
    kernel B1 (df 1/2) or B3 (df 3/4) for f32/f32c.  df 5 raises the
    reference's ValueError (Config.validate_slice).  ``report`` collects
    the skipped-cell and (df 3/4) breakdown counts."""
    cfg.validate_slice()
    if cfg.df_mode in (1, 2):
        cells, aux, species, grid = df12_state(
            surf, species_table, chosen_idx, grids, df_data, cfg, device,
            report)
    else:
        cells, aux, species, grid = feqmod_state(
            surf, species_table, chosen_idx, grids, df_data, cfg, device,
            laguerre, report)
    if cfg.compute_dtype == "f64":
        acc = f64_bins(cells, aux, species, grid, cfg)
    else:
        acc = kernel_bins(cells, kernel_operands(cells, aux, species, grid,
                                                 cfg), species, grid, cfg)
    return distributions(acc, cfg)


def distributions(acc: list[torch.Tensor],
                  cfg: Config) -> SpacetimeDistributions:
    """The three axes' (S, n_bins) bin sums with their bin middles."""
    tau_w, r_w, phi_w = bin_widths(cfg)
    return SpacetimeDistributions(
        tau_mid=cfg.tau_min + tau_w * (np.arange(cfg.tau_bins) + 0.5),
        r_mid=cfg.r_min + r_w * (np.arange(cfg.r_bins) + 0.5),
        phi_mid=phi_w * (np.arange(cfg.phip_bins) + 0.5),
        dN_taudtaudy=acc[0].cpu().numpy(),
        dN_twopirdrdy=acc[1].cpu().numpy(),
        dN_dphidy=acc[2].cpu().numpy(),
    )

