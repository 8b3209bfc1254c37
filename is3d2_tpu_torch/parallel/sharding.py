"""Multi-device sharding of the Cooper-Frye engines over the local cards.

Counterpart of is3d2_tpu/parallel/sharding.py.  The JAX package lays a
single-controller ``jax.sharding.Mesh`` over the devices of its one process
and runs each engine under ``shard_map`` with a ``psum`` over the cell
axis.  The port keeps that meaning with one process too: a ``Mesh`` here is
a (cells x species) grid of explicit ``torch.device``s, and a sharded
engine

  * prepares the whole surface's state once on the run's device (the eta
    fold, the kernel's packed operands, the famod prep, the surface
    temperature of the polarization: everything the JAX package decides
    before its cut);
  * cuts the cells into contiguous ranges of whole ``cfg.cell_block``s,
    one range per cell shard (the JAX pad_cells_for_mesh unit: a shard
    holds ceil(blocks / shards) blocks, the last ones fewer or none), and
    the species into contiguous ranges (pad_species; nothing is padded,
    the kernels mask ragged tiles themselves);
  * copies each shard's slices to its device (transfer.to_device) and
    queues its kernel or f64 engine there, on that device's current
    stream, for every shard before it reads anything back;
  * brings each shard's f64 partial back to the run's device and adds the
    partials in shard order, so a run repeats its bits; species shards are
    concatenated.

Whole cell blocks keep each cell's f32 work as the single-device route
does it, so only the order of the f64 additions moves.  A shard without a
cell that the route reads contributes zeros and launches nothing.  No
process group, NCCL or torch.distributed is involved; runs across hosts
are not covered (the JAX package runs on one host too).

The engines that run sharded, by dtype (the JAX package's table,
is3d2_tpu/parallel/sharding.py::sharded_polarization):

  engine          f32 / f32c                    f64
  spectra 2+1d    sharded_spectra_fast (B1)     sharded_spectra
  spectra 3+1d    sharded_spectra_fast_3d       sharded_spectra
                  (B1's 3+1d mode)
  feqmod/famod    sharded_spectra_feqmod_fast   sharded_spectra_mod_f64
                  (B3, 2+1d; 3+1d stays on one
                  device)
  dN/dX           sharded_dN_dX_fast (2+1d)     sharded_dN_dX
  polarization    sharded_polarization_fast     sharded_polarization
                  (P1, P1's 3+1d mode)
  sampler         parallel/sampler_shard.py: the event axis
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.cells import CellArrays, HostFacts
from ..core.spectra import PREFACTOR, MomentumGridDevice, SpeciesArrays
from ..tracing import span
from ..transfer import to_device

AXES = ("cells", "species")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (cell shards x species shards) grid of devices, its axes named
    AXES; a device may appear more than once."""

    devices: tuple            # tuple of rows of torch.device

    @property
    def shape(self) -> dict:
        return {AXES[0]: len(self.devices), AXES[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def flat(self) -> list:
        """The devices in row-major order: the whole mesh as cell shards."""
        return [d for row in self.devices for d in row]

    def __str__(self) -> str:
        n_c, n_s = len(self.devices), len(self.devices[0])
        return (f"{n_c} cell x {n_s} species shards over "
                + ", ".join(str(d) for d in self.flat()))


def local_devices(device=None) -> list:
    """The devices a run on ``device`` can shard over: every CUDA device
    of this process for a CUDA run (``device`` None: CUDA where torch sees
    it), else ``device`` alone."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_cell_shards: int | None = None, n_species_shards: int = 1,
              devices=None) -> Mesh:
    """A ("cells", "species") mesh over ``devices`` (default:
    local_devices())."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    n = len(devices)
    if n_cell_shards is None:
        n_cell_shards = n // n_species_shards
    if n_cell_shards < 1 or n_cell_shards * n_species_shards != n:
        raise ValueError(f"{n_cell_shards} x {n_species_shards} != {n} "
                         "devices")
    s = n_species_shards
    return Mesh(tuple(tuple(devices[i * s:(i + 1) * s])
                      for i in range(n_cell_shards)))


def auto_mesh(cfg: Config, device=None) -> Mesh | None:
    """The mesh the dispatchers use, from cfg.use_mesh, over the devices
    of a run on ``device`` (the JAX auto_mesh's rules): -1 shards when the
    run has several accelerator devices, 0 never, 1 always (also several
    CPU devices, as the tests give).  None when a mesh is off or has one
    device.  mesh_species_shards that does not divide the device count
    falls back to 1."""
    if cfg.use_mesh == 0:
        return None
    devices = local_devices(device)
    if len(devices) < 2:
        return None
    if cfg.use_mesh < 0 and devices[0].type == "cpu":
        return None
    n_sp = max(1, int(cfg.mesh_species_shards))
    if len(devices) % n_sp:
        n_sp = 1
    return make_mesh(len(devices) // n_sp, n_sp, devices)


# ----------------------------------------------------------------------
# cuts and copies
# ----------------------------------------------------------------------

def cell_ranges(n_cells: int, block: int, n_shards: int) -> list:
    """[begin, end) of each shard: contiguous runs of whole ``block``s,
    ceil(blocks / n_shards) of them a shard, the last shards shorter or
    empty."""
    per = -(-(-(-n_cells // block)) // n_shards) * block
    return [(min(k * per, n_cells), min((k + 1) * per, n_cells))
            for k in range(n_shards)]


def species_ranges(n_species: int, n_shards: int) -> list:
    """[begin, end) of each species shard (ceil(S / n_shards) a shard)."""
    return cell_ranges(n_species, 1, n_shards)


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return to_device(t, device, t.dtype)


def move(obj, device):
    """``obj`` -- a tensor, a dict or dataclass of them (nested), anything
    else left as it is -- with every tensor on ``device``; a dataclass
    keeps its attributes that are not fields (CellArrays.host,
    MomentumGridDevice.host_eta)."""
    if isinstance(obj, torch.Tensor):
        return _to(obj, device)
    if isinstance(obj, dict):
        return {k: move(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type) \
            and not isinstance(obj, Config):
        names = {f.name for f in dataclasses.fields(obj)}
        out = dataclasses.replace(obj, **{n: move(getattr(obj, n), device)
                                          for n in names})
        for k, v in vars(obj).items():
            if k not in names:
                setattr(out, k, v)
        return out
    return obj


def cut_cells(cells: CellArrays, begin: int, end: int,
              device) -> CellArrays:
    """Rows [begin, end) of ``cells`` on ``device``, with the HostFacts
    cut alike (the fold gate's maxima stay the whole surface's)."""
    out = CellArrays(**{f.name: _to(getattr(cells, f.name)[begin:end],
                                    device)
                        for f in dataclasses.fields(cells)})
    h = cells.host
    if h is not None:
        live = h.live[(h.live >= begin) & (h.live < end)] - begin
        out.host = HostFacts(odd_max=h.odd_max, live=live,
                             real=int(np.clip(h.real - begin, 0,
                                              end - begin)))
    return out


def cut_aux(aux, begin: int, end: int, device):
    """Rows [begin, end) of per-cell columns (a dict, or a dataclass such
    as FeqmodCellData whose fields lead with the cell axis) on
    ``device``."""
    if isinstance(aux, dict):
        return {k: _to(v[begin:end], device) for k, v in aux.items()}
    return type(aux)(**{f.name: _to(getattr(aux, f.name)[begin:end], device)
                        for f in dataclasses.fields(aux)})


def cut_species(species: SpeciesArrays, s0: int, s1: int,
                device) -> SpeciesArrays:
    return SpeciesArrays(**{f.name: _to(getattr(species, f.name)[s0:s1],
                                        device)
                            for f in dataclasses.fields(species)})


# the per-cell operands of the kernels' packs (ops/*): rows are cells
_CELL_OPERANDS = ("cell", "qm", "cols", "renorm", "red", "ytab")
# the per-(cell, species) ones: columns are species
_SPECIES_OPERANDS = ("renorm", "red")


def cut_operands(ops, rows: tuple, device, species: tuple | None = None):
    """A kernel's packed operands (a dataclass of ops/*) cut to the cell
    rows [rows[0], rows[1]) and, with ``species`` = (s0, s1, momenta a
    species), to those species' momenta (``mom``'s columns are species
    major) and renorm columns; every tensor contiguous on ``device``."""
    changes = {}
    for f in dataclasses.fields(ops):
        v = getattr(ops, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        if f.name in _CELL_OPERANDS:
            v = v[rows[0]:rows[1]]
        if species is not None:
            s0, s1, per = species
            if f.name in _SPECIES_OPERANDS:
                v = v[:, s0:s1]
            elif f.name == "mom":
                v = v[:, s0 * per:s1 * per]
        changes[f.name] = _to(v.contiguous(), device)
    return dataclasses.replace(ops, **changes)


def live_rows(cells: CellArrays) -> np.ndarray:
    """Indices of the cells with mask > 0, from the host columns where
    ``cells`` carries them (else one read of the mask)."""
    if cells.host is not None:
        return cells.host.live
    return np.flatnonzero(cells.mask.cpu().numpy() > 0.0)


def real_rows(cells: CellArrays) -> np.ndarray:
    """Indices of the real cells (pad_mask > 0): the first ``real`` rows
    where ``cells`` carries its HostFacts."""
    if cells.host is not None:
        return np.arange(cells.host.real)
    return np.flatnonzero(cells.pad_mask.cpu().numpy() > 0.0)


def packed_ranges(rows: np.ndarray, ranges: list) -> list:
    """The [begin, end) of a pack that keeps only the cells ``rows``
    (sorted) for each cell range of the whole surface."""
    return [(int(np.searchsorted(rows, b)), int(np.searchsorted(rows, e)))
            for b, e in ranges]


def sum_in_order(parts: list, device, zeros):
    """The partials added in shard order on ``device`` (None: an empty
    shard); each is dropped once added.  A partial is a tensor or a list of
    tensors, added element by element.  ``zeros()`` when all are empty."""
    acc = None
    for i, p in enumerate(parts):
        if p is None:
            continue
        parts[i] = None
        if isinstance(p, torch.Tensor):
            p = p.to(device)
            acc = p if acc is None else acc + p
        else:
            p = [t.to(device) for t in p]
            acc = p if acc is None else [a + t for a, t in zip(acc, p)]
    return zeros() if acc is None else acc


# the shards of the latest sharded call: device, cell range, species
# range, and the kernel's launch geometry where a kernel ran
last_shards: list = []


def _record(device, cells: tuple, species: tuple | None, kernel=None):
    last_shards.append({
        "device": str(device), "cells": list(cells),
        "species": list(species) if species is not None else None,
        "geometry": (dataclasses.asdict(kernel.last_geometry)
                     if kernel is not None and device.type == "cuda"
                     and dataclasses.is_dataclass(kernel.last_geometry)
                     else None)})


def _over_shards(devices: list, ranges: list, species: list, run, zeros,
                 device, kernel=None, rows: np.ndarray | None = None):
    """``run(cell range, species range, shard device)`` -> a partial on
    every shard: cell range i with species range j runs on devices[i][j],
    every shard queued before any is read back.  A cell range that is
    empty (or, with ``rows``, holds none of those cells) launches nothing
    and counts as zeros.  The partials of each species range are added in
    cell order on ``device`` (``zeros(species range)`` where all are
    empty) and the species ranges concatenated; ``species`` = [None]
    (cells only) returns its one sum."""
    last_shards.clear()
    parts = [[None] * len(ranges) for _ in species]
    for i, (b, e) in enumerate(ranges):
        if e <= b or (rows is not None
                      and not ((rows >= b) & (rows < e)).any()):
            continue
        for j, sp in enumerate(species):
            d = devices[i][j]
            parts[j][i] = run((b, e), sp, d)
            _record(d, (b, e), sp, kernel)
    sums = [sum_in_order(p, device, lambda sp=sp: zeros(sp))
            for p, sp in zip(parts, species)]
    return sums[0] if species == [None] else torch.cat(sums)


def _species_shards(n_species: int, mesh: Mesh) -> list:
    """The non-empty species ranges of ``mesh``'s "species" axis (the
    empty ones come last, so the j-th is the mesh's column j)."""
    return [(s0, s1) for s0, s1 in species_ranges(n_species,
                                                   mesh.shape[AXES[1]])
            if s1 > s0]


def _cell_shards(cells: CellArrays, cfg: Config, n_shards: int) -> list:
    return cell_ranges(cells.n_padded, cfg.cell_block, n_shards)


def _whole_mesh(mesh: Mesh) -> list:
    """Every device of ``mesh`` a cell shard, for _over_shards."""
    return [[d] for d in mesh.flat()]


def _cells_axis(mesh: Mesh) -> list:
    """The first device of each "cells" row (species replicated)."""
    return [[row[0]] for row in mesh.devices]


# ----------------------------------------------------------------------
# spectra, df 1/2
# ----------------------------------------------------------------------

def _kernel_over_mesh(ops, mesh: Mesh, ranges: list, n_species: int,
                      per_species: int, call, kernel, device) -> torch.Tensor:
    """``call(shard operands)`` -> (M_shard,) f64 on every (cell range,
    species range) shard of ``mesh``: (S * per_species,) on ``device``."""
    return _over_shards(
        mesh.devices, ranges, _species_shards(n_species, mesh),
        lambda rows, sp, d: call(cut_operands(ops, rows, d,
                                              (*sp, per_species))),
        lambda sp: torch.zeros((sp[1] - sp[0]) * per_species,
                               dtype=torch.float64, device=device),
        device, kernel)


def sharded_spectra_fast(cells: CellArrays, coeffs: dict,
                         species: SpeciesArrays, grid: MomentumGridDevice,
                         cfg: Config, mesh: Mesh) -> torch.Tensor:
    """2+1d df 1/2 spectra through kernel B1 (f32 and f32c), sharded over
    ("cells", "species"): the eta fold decided and the operands packed once
    for the whole surface (ops/spectra_fast_common.py::comp_operands), then
    cut.  Returns (S, NpT, Nphi, 1) f64 on the cells' device."""
    from ..ops.cooper_frye_comp import cooper_frye_comp
    from ..ops.spectra_fast_common import _spectra, comp_operands
    with span("pack"):
        ops = comp_operands(cells, coeffs, species, grid, cfg)
    per = grid.pT.shape[0] * grid.cos_phi.shape[0]
    with span("launch"):
        flat = _kernel_over_mesh(
            ops, mesh, _cell_shards(cells, cfg, mesh.shape[AXES[0]]),
            species.mass.shape[0], per,
            lambda s: cooper_frye_comp(*s.args(), cfg, row_len=s.row_len),
            cooper_frye_comp, cells.tau.device)
    return _spectra(flat, species, grid)


def sharded_spectra_fast_3d(cells: CellArrays, coeffs: dict,
                            species: SpeciesArrays, grid: MomentumGridDevice,
                            cfg: Config, mesh: Mesh) -> torch.Tensor:
    """3+1d df 1/2 spectra through B1's 3+1d mode, sharded over ("cells",
    "species"): the live cells packed once, each shard taking the live
    cells of its cell range.  Returns (S, NpT, Nphi, Ny) f64."""
    from ..ops.cooper_frye_comp import cooper_frye_comp_3d
    from ..ops.spectra_fast_common import comp_operands_3d, spectra_3d
    with span("pack"):
        ops = comp_operands_3d(cells, coeffs, species, grid, cfg)
    ranges = packed_ranges(live_rows(cells),
                           _cell_shards(cells, cfg, mesh.shape[AXES[0]]))
    per = grid.pT.shape[0] * grid.y.shape[0] * grid.cos_phi.shape[0]
    with span("launch"):
        flat = _kernel_over_mesh(
            ops, mesh, ranges, species.mass.shape[0], per,
            lambda s: cooper_frye_comp_3d(*s.args(), cfg, **s.layout()),
            cooper_frye_comp_3d, cells.tau.device)
    return spectra_3d(flat, species, grid)


def sharded_spectra(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                    grid: MomentumGridDevice, cfg: Config,
                    mesh: Mesh) -> torch.Tensor:
    """df 1/2 spectra on the torch f64 engine (core/spectra.py::
    spectra_df12), cells over "cells" and species over "species".  Returns
    (S, NpT, Nphi, Ny) f64 on the cells' device."""
    from ..core.spectra import spectra_df12
    dev = cells.tau.device
    shape = (grid.pT.shape[0], grid.cos_phi.shape[0], grid.y.shape[0])
    return _over_shards(
        mesh.devices, _cell_shards(cells, cfg, mesh.shape[AXES[0]]),
        _species_shards(species.mass.shape[0], mesh),
        lambda rows, sp, d: spectra_df12(
            cut_cells(cells, *rows, d), cut_aux(coeffs, *rows, d),
            cut_species(species, *sp, d), move(grid, d), cfg),
        lambda sp: torch.zeros((sp[1] - sp[0], *shape), dtype=torch.float64,
                               device=dev),
        dev)


# ----------------------------------------------------------------------
# spectra, df 3-5
# ----------------------------------------------------------------------

def sharded_spectra_feqmod_fast(cells: CellArrays, fq_or_fm,
                                species: SpeciesArrays,
                                grid: MomentumGridDevice, cfg: Config,
                                mesh: Mesh) -> torch.Tensor:
    """2+1d df 3/4 (feqmod) or df 5 (famod) spectra through kernel B3,
    sharded over ("cells", "species"): the strict eta fold decided and the
    operands packed once, the per-(cell, species) renormalization columns
    cut with the cells and the species.  ``fq_or_fm`` is the feqmod prep
    (df 3/4) or the famod prep (df 5), made once before the cut.  Returns
    (S, NpT, Nphi, 1) f64 on the cells' device."""
    from ..ops import cooper_frye_feqmod as fk
    if cfg.dimension != 2:
        raise ValueError("the sharded feqmod kernel route implements 2+1d")
    with span("pack"):
        if cfg.df_mode == 5:
            ops = fk.famod_operands(cells, fq_or_fm, species, grid, cfg)
        else:
            ops = fk.feqmod_operands(cells, fq_or_fm, species, grid, cfg)
    with span("launch"):
        flat = _kernel_over_mesh(
            ops, mesh, _cell_shards(cells, cfg, mesh.shape[AXES[0]]),
            species.mass.shape[0], ops.n_per_species,
            lambda s: fk.cooper_frye_feqmod(*s.args(), cfg, s.kind,
                                            row_len=s.row_len),
            fk.cooper_frye_feqmod, cells.tau.device)
    out = flat.reshape(species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)
    return PREFACTOR * species.degeneracy[:, None, None, None] * out


def sharded_spectra_mod_f64(cells: CellArrays, aux, species: SpeciesArrays,
                            grid: MomentumGridDevice, cfg: Config,
                            mesh: Mesh) -> torch.Tensor:
    """df 3/4/5 spectra on the torch f64 feqmod or famod engine, cells cut
    over the WHOLE mesh (the species stay whole: the per-(cell, species)
    renormalization follows the cells).  ``aux`` is the feqmod or famod
    prep.  Returns (S, NpT, Nphi, Ny) f64 on the cells' device."""
    if cfg.df_mode == 5:
        from ..core.spectra_famod import spectra_famod as engine
    else:
        from ..core.spectra_feqmod import spectra_feqmod as engine
    dev = cells.tau.device
    shape = (species.mass.shape[0], grid.pT.shape[0], grid.cos_phi.shape[0],
             grid.y.shape[0])
    return _over_shards(
        _whole_mesh(mesh), _cell_shards(cells, cfg, mesh.size), [None],
        lambda rows, _, d: engine(
            cut_cells(cells, *rows, d), cut_aux(aux, *rows, d),
            move(species, d), move(grid, d), cfg),
        lambda _: torch.zeros(shape, dtype=torch.float64, device=dev), dev)


# ----------------------------------------------------------------------
# spacetime distributions (operation 0)
# ----------------------------------------------------------------------

def _bins_over_mesh(cells: CellArrays, species: SpeciesArrays, cfg: Config,
                    mesh: Mesh, run) -> list:
    """The three (S, n_bins) bin sums of operation 0 with cells over the
    whole mesh: the bin indices of every cell read once (host), then
    ``run(begin, end, device, bins, mask)`` -> three partials per shard,
    added in order."""
    from ..core.spacetime import bin_indices
    dev = cells.tau.device
    bins = bin_indices(cells, cfg)
    mask = cells.mask.cpu().numpy()
    S = species.mass.shape[0]
    return _over_shards(
        _whole_mesh(mesh), _cell_shards(cells, cfg, mesh.size), [None],
        lambda rows, _, d: run(*rows, d, [(idx[rows[0]:rows[1]], n)
                                          for idx, n in bins],
                               mask[rows[0]:rows[1]]),
        lambda _: [torch.zeros((S, n), dtype=torch.float64, device=dev)
                   for _, n in bins],
        dev, rows=np.flatnonzero(mask > 0.0))


def sharded_dN_dX(cells: CellArrays, aux, species: SpeciesArrays,
                  grid: MomentumGridDevice, cfg: Config, mesh: Mesh) -> list:
    """Operation 0 on the torch f64 engines (df 1/2 with ``aux`` the
    coefficient columns, df 3/4 with the feqmod prep), cells over the WHOLE
    mesh: each shard's dN/dy per cell binned on its device, the three
    accumulators added (the bin edges come from the config, so the shards'
    bins line up).  Returns the three (S, n_bins) f64 sums."""
    from ..core.spacetime import f64_bins
    return _bins_over_mesh(cells, species, cfg, mesh,
                           lambda b, e, d, bins, mask: f64_bins(
                               cut_cells(cells, b, e, d),
                               cut_aux(aux, b, e, d), move(species, d),
                               move(grid, d), cfg, bins=bins, mask=mask))


def sharded_dN_dX_fast(cells: CellArrays, aux, species: SpeciesArrays,
                       grid: MomentumGridDevice, cfg: Config,
                       mesh: Mesh) -> list:
    """Operation 0 through the per-bin kernel route (2+1d: B1 for df 1/2,
    B3 dan-weighted for df 3/4), cells over the WHOLE mesh: the operands
    packed once (eta fold decided once), each shard running the kernel on
    its cells of each bin.  Returns the three (S, n_bins) f64 sums."""
    from ..core.spacetime import kernel_bins, kernel_operands
    ops = kernel_operands(cells, aux, species, grid, cfg)
    return _bins_over_mesh(cells, species, cfg, mesh,
                           lambda b, e, d, bins, mask: kernel_bins(
                               None, cut_operands(ops, (b, e), d),
                               move(species, d), move(grid, d), cfg,
                               bins=bins, mask=mask))


# ----------------------------------------------------------------------
# spin polarization
# ----------------------------------------------------------------------

def sharded_polarization_fast(cells: CellArrays, species: SpeciesArrays,
                              grid: MomentumGridDevice, T: float,
                              cfg: Config, mesh: Mesh,
                              delta_eta: float = 1.0) -> torch.Tensor:
    """Mode-5 polarization sums through kernel P1 (2+1d, folded where the
    whole surface allows it) or P1's 3+1d mode, cells cut over "cells"
    (species replicated, as in the JAX package).  ``T`` is the surface's
    temperature and ``delta_eta`` the unfolded table's spacing, both taken
    before the cut.  Returns the (5, S, NpT, Nphi, Ny) f64 raw sums."""
    from ..core.polarization import fold_polarization_eta
    from ..ops import polarization_f32 as p1
    dev = cells.tau.device
    ranges = packed_ranges(real_rows(cells),
                           _cell_shards(cells, cfg, mesh.shape[AXES[0]]))
    S, NpT, Nphi = (species.mass.shape[0], grid.pT.shape[0],
                    grid.cos_phi.shape[0])
    if cfg.dimension == 3:
        ops = p1.pack_inputs_3d(cells, species, grid, T)
        kernel = p1.polarization_f32_3d

        def call(s):
            return p1.polarization_f32_3d(*s.args(), **s.layout())
    else:
        grid, folded = fold_polarization_eta(cells, grid, cfg)
        ops = p1.pack_inputs(cells, species, grid, T, delta_eta, folded)
        kernel = p1.polarization_f32

        def call(s):
            return p1.polarization_f32(*s.args(), row_len=s.row_len)
    M = ops.mom.shape[1]
    acc = _over_shards(
        _cells_axis(mesh), ranges, [None],
        lambda rows, _, d: call(cut_operands(ops, rows, d)),
        lambda _: torch.zeros((p1.N_SUMS, M), dtype=torch.float64,
                              device=dev),
        dev, kernel)
    if cfg.dimension == 3:
        return acc.reshape(p1.N_SUMS, S, NpT, ops.n_y, Nphi).permute(
            0, 1, 2, 4, 3)
    return acc.reshape(p1.N_SUMS, S, NpT, Nphi, 1)


def sharded_polarization(cells: CellArrays, species: SpeciesArrays,
                         grid: MomentumGridDevice, T: float, cfg: Config,
                         mesh: Mesh, delta_eta: float = 1.0) -> torch.Tensor:
    """Mode-5 polarization sums on the torch f64 engine (never folded),
    cells cut over the WHOLE mesh.  Returns (5, S, NpT, Nphi, Ny) f64."""
    from ..core.polarization import polarization_f64
    dev = cells.tau.device
    n_y = grid.y.shape[0] if cfg.dimension == 3 else 1
    shape = (5, species.mass.shape[0], grid.pT.shape[0],
             grid.cos_phi.shape[0], n_y)
    return _over_shards(
        _whole_mesh(mesh), _cell_shards(cells, cfg, mesh.size), [None],
        lambda rows, _, d: polarization_f64(
            cut_cells(cells, *rows, d), move(species, d), move(grid, d), T,
            delta_eta, cfg.dimension),
        lambda _: torch.zeros(shape, dtype=torch.float64, device=dev),
        dev, rows=real_rows(cells))
