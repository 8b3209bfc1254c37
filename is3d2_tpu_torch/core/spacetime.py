"""Spacetime distributions dN/dX (operation 0): df 1-4 in 2+1d and 3+1d.

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
  * f32/f32c in 2+1d, df 1/2: kernel B1's per-cell mode
    (``comp_cell_bins``).  The live cells that some axis bins are gathered
    from the packed operands once, one launch gives each one's dN/dy per
    species (the (pT, phi) weights applied in the kernel), and the three
    axes bin it in f64 on the device by contractions with blocks of the
    cells' one-hot bins (``bin_cells``: a fixed order, the same bits every
    run);
  * f32/f32c in 2+1d, df 3/4: kernel B3 in its dan-weighted convention.
    B3 sums over the cells it is handed for every momentum point, so the
    cells of each axis are sorted by bin once (one gather of the packed
    operands) and the kernel runs on each non-empty bin's run of cells;
    its (S, pT, phi) result contracted with the (pT, phi) weights is the
    bin (``kernel_bins``, which also takes B1 per bin: the meshed route's
    and the tools').
The JAX package runs its XLA fast paths there (ROADMAP C7).

In 3+1d every dtype runs the f64 engines (df 3/4: the dan-weighted feqmod
integrand, with the narrow window), as the JAX package does
(is3d2_tpu/core/spacetime.py:159: its fast route needs dimension 2): a
cell's dN/dy is its integrand summed over the y table with the (pT, phi)
weights only, no y weight (the JAX package's sum, is3d2_tpu/core/
spacetime.py:97,109-111).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..io.pdg import SpeciesTable
from ..io.tables import GaussLaguerre, MomentumGrids
from ..physics.deltaf import DeltafData
from ..tracing import span
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
             grid: MomentumGridDevice, cfg: Config, bins=None,
             mask=None) -> list[torch.Tensor]:
    """The f64 route's (S, n_bins) bin sums of the three axes.  ``bins``
    and ``mask`` (bin_indices and the host mask of these cells) where the
    caller has them (parallel/sharding.py reads them once for every
    shard), else read here."""
    dN = dN_dy_cells(cells, aux, species, grid, cfg)
    if bins is None:
        bins, mask = bin_indices(cells, cfg), cells.mask.cpu().numpy()
    return [_scatter(dN, idx, n, mask) for idx, n in bins]


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
                call=run_kernel, bins=None, mask=None) -> list[torch.Tensor]:
    """The kernel route's (S, n_bins) f64 bin sums of the three axes:
    ``call(ops of one bin's cells, cfg)`` -> (M,) f64 on each non-empty
    bin, contracted with the (pT, phi) weights.  ``bins`` and ``mask`` as
    in f64_bins (given, ``cells`` is not read)."""
    S = species.mass.shape[0]
    w = (grid.pT_weight[:, None] * grid.phi_weight[None, :]).reshape(-1)
    scale = PREFACTOR * species.degeneracy[:, None]
    if bins is None:
        bins, mask = bin_indices(cells, cfg), cells.mask.cpu().numpy()
    out = []
    for idx, n_bins in bins:
        rows, runs = binned_cells(idx, n_bins, mask)
        sorted_ops = cell_rows(ops, torch.as_tensor(rows, device=w.device))
        acc = torch.zeros((S, n_bins), dtype=f64, device=w.device)
        for b, begin, end in runs:
            flat = call(cell_rows(sorted_ops, slice(begin, end)), cfg)
            acc[:, b] = flat.reshape(S, -1) @ w
        out.append(scale * acc)
    return out


def cell_bin_columns(bins, mask: np.ndarray):
    """The cells that some axis bins (ascending), and for the three axes
    together (the axes' bins side by side) the (cell position among them,
    bin) of every cell an axis bins: the drops of ``_scatter``, out of range
    or mask <= 0."""
    ok = [(idx >= 0) & (idx < n) & (mask > 0.0) for idx, n in bins]
    keep = np.nonzero(np.logical_or.reduce(ok))[0]
    rows, cols, offset = [], [], 0
    for (idx, n), axis_ok in zip(bins, ok):
        at = np.nonzero(axis_ok[keep])[0]
        rows.append(at)
        cols.append(idx[keep[at]] + offset)
        offset += n
    return keep, np.concatenate(rows), np.concatenate(cols)


def bin_cells(dN: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
              n_bins: list[int]) -> list[torch.Tensor]:
    """The per-cell sums ``dN`` (C, S) f64 binned on the axes of
    ``cell_bin_columns``, on dN's device: block by block of cells, an f64
    contraction with the block's one-hot bins (cells, sum(n_bins)), the
    blocks added in order, so that no one-hot matrix outgrows
    _F64_BLOCK_ELEMENTS.  No atomics (cuBLAS allows none by default):
    every run adds in the same order and gives the same bits."""
    dev = dN.device
    C, total = dN.shape[0], sum(n_bins)
    step = max(1, _F64_BLOCK_ELEMENTS // total)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    at = np.searchsorted(rows, np.arange(0, C + step, step))
    rows_d = torch.as_tensor(rows, device=dev)
    cols_d = torch.as_tensor(cols, device=dev)
    acc = torch.zeros((dN.shape[1], total), dtype=f64, device=dev)
    for k, c0 in enumerate(range(0, C, step)):
        hot = torch.zeros((min(step, C - c0), total), dtype=f64, device=dev)
        hot[rows_d[at[k]:at[k + 1]] - c0, cols_d[at[k]:at[k + 1]]] = 1.0
        acc += dN[c0:c0 + step].T @ hot
    return list(torch.split(acc, n_bins, dim=1))


def comp_cell_bins(cells: CellArrays, aux: dict, species: SpeciesArrays,
                   grid: MomentumGridDevice, cfg: Config) -> list[torch.Tensor]:
    """Kernel B1's per-cell route (2+1d df 1/2): the (S, n_bins) f64 bin
    sums of the three axes from one launch on the cells some axis bins."""
    from ..ops import cooper_frye_comp as ck
    with span("bin"):
        bins, mask = bin_indices(cells, cfg), cells.mask.cpu().numpy()
        keep, rows, cols = cell_bin_columns(bins, mask)
    with span("pack"):
        ops = cell_rows(kernel_operands(cells, aux, species, grid, cfg),
                        torch.as_tensor(keep, device=cells.tau.device))
    w = (grid.pT_weight[:, None] * grid.phi_weight[None, :]).reshape(-1)
    with span("launch"):
        dN = ck.cooper_frye_comp_cells(*ops.args(), w.contiguous(), cfg,
                                       row_len=ops.row_len)
    with span("bin"):
        scale = PREFACTOR * species.degeneracy[:, None]
        return [scale * a
                for a in bin_cells(dN, rows, cols, [n for _, n in bins])]


def compute_dN_dX(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                  grids: MomentumGrids, df_data: DeltafData, cfg: Config,
                  device, laguerre: GaussLaguerre | None = None,
                  report=None, mesh=None) -> SpacetimeDistributions:
    """Operation 0 on ``device``: the f64 engines for compute_dtype f64
    and in 3+1d, kernel B1's per-cell mode (df 1/2) or B3 per bin (df 3/4)
    for f32/f32c in 2+1d;
    under ``mesh`` (the driver's, parallel/sharding.py::auto_mesh of
    cfg.use_mesh) the same routes with the cells cut over every device of
    the mesh.
    df 5 raises the reference's ValueError (Config.validate_slice).
    ``report`` collects the skipped-cell and (df 3/4) breakdown counts."""
    cfg.validate_slice()
    if cfg.df_mode in (1, 2):
        cells, aux, species, grid = df12_state(
            surf, species_table, chosen_idx, grids, df_data, cfg, device,
            report)
    else:
        cells, aux, species, grid = feqmod_state(
            surf, species_table, chosen_idx, grids, df_data, cfg, device,
            laguerre, report)
    f64_route = cfg.compute_dtype == "f64" or cfg.dimension == 3
    if mesh is not None:
        # cells over the whole mesh (is3d2_tpu/core/spacetime.py:156-195):
        # 3+1d runs the meshed f64 engine on every dtype, as in JAX
        from ..parallel import sharding
        meshed = sharding.sharded_dN_dX if f64_route \
            else sharding.sharded_dN_dX_fast
        acc = meshed(cells, aux, species, grid, cfg, mesh)
    elif f64_route:
        acc = f64_bins(cells, aux, species, grid, cfg)
    elif cfg.df_mode in (1, 2):
        acc = comp_cell_bins(cells, aux, species, grid, cfg)
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

