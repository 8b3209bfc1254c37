"""Multi-surface (event-ensemble) runs: spectra, sampled test histograms
and particle lists over many freezeout surfaces.

Counterpart of is3d2_tpu/core/ensemble.py, the library path of a
campaign (the reference loops whole binaries, scripts/oversample.sh:1-15;
the BASELINE stretch configuration is 1,000 surfaces).  The JAX package
pads the surfaces to one cell count, stacks them and vmaps its engines over
them.  The port runs each surface through its own single-surface route
instead -- core/spectra.py::spectra_on_device (kernels B1, B2, B3 or an f64
engine, as for one surface) and core/sampler.py::sample_particles -- so
surface i of an ensemble equals a single run on surface i bit for bit.

The spectra run as a pipeline on one device: surface k+1's host work
(padding, shear completion, the fold gate from the host columns) and its
asynchronous uploads are queued while surface k's kernel runs, surface k's
result is copied back into pinned host memory behind its kernel, and the
host waits for surface k only after surface k+1 is queued.  At most two
surfaces are on the device at a time.  df 5's reconstruction reads its
Newton's convergence back, so there only the host part overlaps.  The
sampler reads back once per event chunk anyway, and runs surface by
surface.

With ``mesh`` (parallel/sharding.py::Mesh) the surfaces are cut by the
mesh's axis 0 into contiguous groups, one group per device (the first of
each row), as the JAX package shards its surface axis.  The spectra
pipeline then queues the groups' surfaces in turn, device by device, and
keeps at most two surfaces a device in flight; the sampler runs each
group in a worker thread of its own.  Each surface still runs its single-
surface route on one device, with its own seed, so it equals its single
run bit for bit on devices of one kind.  Without ``mesh`` an ensemble runs
on ``device`` alone, whatever cfg.use_mesh says (only the driver turns
cfg.use_mesh into a mesh), as the JAX ensemble runs without one.

What the JAX package's semantics keep:
  * the species are never grouped: the ensemble runs with
    group_particles = 0, as the JAX ensemble builds its species arrays from
    ``chosen_idx`` directly;
  * in fast mode each surface's sampler takes the particle densities at
    that surface's own averages (compute_particle_densities), on a copy of
    the species table: the caller's table is left as it was (the JAX
    package writes them into the caller's table, ROADMAP C7);
  * surface i's random stream is keyed by its index in the whole ensemble,
    sampler.surface_seed(seed, i), so nothing depends on chunking; the
    streams are torch generators, not JAX keys, so the sampler agrees with
    the JAX ensemble statistically;
  * every surface samples ``events_per_surface`` events.

What the signatures drop or ignore:
  * the JAX padding arguments (``n_cells_pad``, ``_n_cells_pad``,
    ``_surf_offset``): nothing is padded to a common cell count;
  * ``surface_chunk`` is accepted and changes nothing: nothing is stacked,
    so device memory is bounded by the two surfaces in flight whatever it
    says, and the results do not depend on it;
  * ``capacity`` is accepted and not used: the port's sampler splits a
    campaign into event chunks of at most ``sampler_chunk_hadrons`` drawn
    hadrons (core/sampler.py::chunk_plan) and never overflows, so
    ``overflow`` is all False and the JAX heal of overflowed surfaces (a
    static capacity of a vmapped program) has no counterpart.

``device`` None means "cuda", which raises where torch sees no GPU, as
``IS3D`` does; the CPU runs only when it is asked for.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..io.pdg import SpeciesTable
from ..io.tables import GaussLaguerre, MomentumGrids
from ..physics.deltaf import DeltafData, compute_particle_densities
from ..transfer import run_device
from .sampler import prepare_setup, sample_particles, surface_seed
from .sampler_hist import ChunkBinner, stack_histograms
from .spectra import spectra_on_device


def _config(cfg: Config, cell_block: int | None,
            surface_chunk: int | None) -> Config:
    """``cfg`` with ``cell_block`` applied and grouping off, validated as
    for one surface."""
    if surface_chunk is not None and surface_chunk < 1:
        raise ValueError(f"surface_chunk must be >= 1, got {surface_chunk}")
    cfg = dataclasses.replace(cfg, group_particles=0)
    if cell_block:
        cfg = dataclasses.replace(cfg, cell_block=cell_block)
    cfg.validate_slice()
    return cfg


def _start_copy(t: torch.Tensor):
    """Queue the copy of ``t`` into pinned host memory behind the work
    that makes it; returns (host tensor, CUDA event after the copy, or
    None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    with torch.cuda.device(t.device):   # the copy's stream is t's device's
        done = torch.cuda.Event()
        done.record()
    return host, done


def surface_groups(n_surfaces: int, mesh, device) -> list:
    """[(device, surface indices)]: all on ``device`` without a mesh, else
    the contiguous groups of the mesh's axis 0, one per row's first
    device (empty groups left out)."""
    if mesh is None:
        return [(device, list(range(n_surfaces)))]
    from ..parallel.sharding import species_ranges
    rows = [row[0] for row in mesh.devices]
    return [(d, list(range(b, e)))
            for d, (b, e) in zip(rows, species_ranges(n_surfaces, len(rows)))
            if e > b]


def _round_robin(groups: list) -> list:
    """(device, surface) of every group in turn: the groups' first
    surfaces, then their second ones, ..."""
    longest = max(len(g) for _, g in groups)
    return [(d, g[k]) for k in range(longest) for d, g in groups
            if k < len(g)]


def _over_groups(groups: list, run) -> dict:
    """``run(device, i)`` for every surface, group by group on one device
    each: inline for one group, else one worker thread a group.  Returns
    {i: result}."""
    def group(d, idx):
        return {i: run(d, i) for i in idx}
    if len(groups) == 1:
        return group(*groups[0])
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        futures = [pool.submit(group, d, idx) for d, idx in groups]
        out = {}
        for f in futures:
            out.update(f.result())
    return out


def compute_spectra_ensemble(surfs, species_table: SpeciesTable, chosen_idx,
                             grids: MomentumGrids, df_data: DeltafData,
                             cfg: Config,
                             laguerre: GaussLaguerre | None = None,
                             cell_block: int | None = None, mesh=None,
                             surface_chunk: int | None = None,
                             device=None) -> np.ndarray:
    """Continuous spectra of every surface, df 1-5: (n_surfaces, S, NpT,
    Nphi, Ny) f64 on the host.  Surface i is spectra_on_device's result for
    surfs[i] with ``cfg`` (``cell_block`` overriding cfg.cell_block,
    grouping off); ``laguerre`` is needed for df 3/4.  ``mesh`` spreads the
    surfaces over its devices (surface_groups)."""
    if not surfs:
        raise ValueError("the ensemble has no surface")
    dev = run_device(device)
    cfg = _config(cfg, cell_block, surface_chunk)
    chosen_idx = np.asarray(chosen_idx)
    groups = surface_groups(len(surfs), mesh, dev)
    out = None
    pending = collections.deque()

    def land(i, host, done):
        nonlocal out
        if done is not None:
            done.synchronize()
        a = host.numpy()
        if out is None:
            out = np.empty((len(surfs), *a.shape), dtype=a.dtype)
        out[i] = a

    for d, i in _round_robin(groups):
        spectra = spectra_on_device(surfs[i], species_table, chosen_idx,
                                    grids, df_data, cfg, d, laguerre)
        pending.append((i, *_start_copy(spectra)))
        del spectra
        if len(pending) > len(groups):
            # surface i is queued behind the previous one of its device
            land(*pending.popleft())
    while pending:
        land(*pending.popleft())
    return out


def _surface_table(species_table: SpeciesTable, surf, df_data: DeltafData,
                   laguerre: GaussLaguerre, cfg: Config) -> SpeciesTable:
    """The species table a surface's sampler reads: in fast mode (df 1-4)
    a copy carrying the particle densities at the surface's own averages,
    else the table itself."""
    if not cfg.fast or cfg.df_mode == 5:
        return species_table
    table = dataclasses.replace(species_table)
    compute_particle_densities(table, df_data, laguerre,
                               surf.thermo_averages())
    return table


def prepare_sampler_ensemble(surfs, species_table: SpeciesTable, chosen_idx,
                             df_data: DeltafData, cfg: Config,
                             laguerre: GaussLaguerre,
                             cell_block: int | None = None, device=None):
    """Each surface's sampler state, as sample_ensemble_* prepare it one
    surface at a time: a list of (SamplerSetup, SpeciesArrays) on
    ``device``, with each surface's own densities in fast mode.  All of
    them stay on the device, so this is for a few surfaces."""
    dev = run_device(device)
    cfg = _config(cfg, cell_block, None)
    return [prepare_setup(s, _surface_table(species_table, s, df_data,
                                            laguerre, cfg),
                          chosen_idx, df_data, cfg, laguerre, dev)[:2]
            for s in surfs]


def sample_ensemble_histograms(surfs, species_table: SpeciesTable, chosen_idx,
                               df_data: DeltafData, cfg: Config,
                               laguerre: GaussLaguerre,
                               events_per_surface: int, capacity: int,
                               seed: int = 1, cell_block: int | None = None,
                               mesh=None, surface_chunk: int | None = None,
                               device=None):
    """Sample ``events_per_surface`` events from every surface into its
    test histograms.  Returns (histograms, overflow): the JAX ensemble's
    dict (sampler_hist.stack_histograms: the raw counts and v_n sums with a
    leading surface axis) and an all-False (n_surfaces,) array.  Surface
    i's histograms are sample_particles' on surfs[i] with seed
    surface_seed(seed, i), binned by a ChunkBinner; ``mesh`` spreads the
    surfaces over its devices (surface_groups)."""
    dev = run_device(device)
    cfg = _config(cfg, cell_block, surface_chunk)

    def one(d, i):
        binner = ChunkBinner(len(chosen_idx), cfg)
        surf = surfs[i]
        sample_particles(surf, _surface_table(species_table, surf, df_data,
                                              laguerre, cfg),
                         chosen_idx, df_data, cfg, laguerre,
                         events_per_surface, d, seed=surface_seed(seed, i),
                         chunk_consumer=binner)
        return binner.result(events_per_surface)

    hists = _over_groups(surface_groups(len(surfs), mesh, dev), one)
    return (stack_histograms([hists[i] for i in range(len(surfs))]),
            np.zeros(len(surfs), dtype=bool))


def sample_ensemble_particle_lists(surfs, species_table: SpeciesTable,
                                   chosen_idx, df_data: DeltafData,
                                   cfg: Config, laguerre: GaussLaguerre,
                                   events_per_surface: int, capacity: int,
                                   results_root, seed: int = 1,
                                   cell_block: int | None = None, mesh=None,
                                   surface_chunk: int | None = None,
                                   oscar: bool = True, csv: bool = False,
                                   device=None) -> list[dict]:
    """Sample every surface and write its particle lists: surface i writes
    ``results_root/surface_<i>/particle_list_osc_<ev>.dat`` (and, with
    ``csv``, ``particle_list_<ev>.dat``) for events 0 ..
    events_per_surface - 1 through a StreamingEventWriter, from
    sample_particles on surfs[i] with seed surface_seed(seed, i); ``mesh``
    spreads the surfaces over its devices (surface_groups).  Returns one
    {"dir", "rows_written", "events_written", "kept"} per surface."""
    from ..io.output import StreamingEventWriter

    dev = run_device(device)
    cfg = _config(cfg, cell_block, surface_chunk)

    def one(d, i):
        surf = surfs[i]
        writer = StreamingEventWriter(Path(results_root) / f"surface_{i}",
                                      oscar=oscar, csv=csv)
        try:
            diags = sample_particles(
                surf, _surface_table(species_table, surf, df_data, laguerre,
                                     cfg),
                chosen_idx, df_data, cfg, laguerre, events_per_surface, d,
                seed=surface_seed(seed, i), chunk_consumer=writer, lean=True)
        finally:
            writer.close()
        return {"dir": str(writer.results_dir),
                "rows_written": writer.rows_written,
                "events_written": writer.events_written,
                "kept": diags["kept"]}

    stats = _over_groups(surface_groups(len(surfs), mesh, dev), one)
    return [stats[i] for i in range(len(surfs))]
