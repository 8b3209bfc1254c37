"""The sampler's event axis over the local devices.

Counterpart of is3d2_tpu/parallel/sampler_shard.py, the multi-device form
of the reference's process farm (scripts/run_multithread_sampling_iS3D.py:
18-31).  A campaign is prepared once on the run's device and split into the
event chunks of the single-device campaign (core/sampler.py::chunk_plan);
chunk c runs on device c mod n of the mesh's n devices, on a copy of the
campaign state there, with the single-device campaign's own stream
chunk_generator(seed, c).  Each mesh slot runs its chunks in a worker
thread of its own, so the devices overlap: the next chunk of every slot is
queued before the first is read back, and a chunk's reads of its own
counts hold up only its slot.  The chunks reach the consumer (the
histogram binner, StreamingEventWriter, the collector) in event order, in
the caller's thread.

So a meshed campaign draws the single-device campaign's hadrons bit for
bit on devices of one kind.  The JAX package folds each device's index
into its key, so its meshed campaign agrees with its single-device one
only statistically; so does the port with either of them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib

import numpy as np
import torch

from ..config import Config
from ..core import sampler as smp
from ..core.sampler_hist import ChunkBinner, bin_histograms
from ..io.pdg import SpeciesTable
from ..io.tables import GaussLaguerre
from ..physics.deltaf import DeltafData
from .sharding import Mesh, move


def _scope(device):
    """The CUDA device scope of a worker thread (none off the card)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def campaign_copies(camp: smp.Campaign, devices: list) -> dict:
    """The campaign on each distinct device of ``devices``: ``camp`` itself
    on its own device, a copy elsewhere."""
    home = camp.setup.rates.device
    return {d: camp if d == home else move(camp, d) for d in set(devices)}


def _run_chunk(camp: smp.Campaign, c: int, n_ev: int, ev0: int, seed: int,
               lean: bool, pack, device):
    stats = smp.ChunkStats()
    with _scope(device):
        ch = smp.sample_chunk(camp, n_ev, ev0,
                              smp.chunk_generator(seed, c, device), stats,
                              lean, pack, seed)
    return ch, stats


def meshed_chunks(camp: smp.Campaign, n_events: int, per_chunk: int,
                  seed: int, mesh: Mesh, lean: bool = False, pack=None):
    """Yield (chunk, its ChunkStats) in event order: chunk c of ``n_events``
    in chunks of ``per_chunk`` events on device c mod n of ``mesh``, at
    most one chunk a device slot running and one waiting."""
    devices = mesh.flat()
    n = len(devices)
    copies = campaign_copies(camp, devices)
    n_chunks = -(-n_events // per_chunk)
    pools = [concurrent.futures.ThreadPoolExecutor(1) for _ in devices]
    futures = {}

    def submit(c):
        if c < n_chunks:
            d = devices[c % n]
            ev0 = c * per_chunk
            futures[c] = pools[c % n].submit(
                _run_chunk, copies[d], c, min(per_chunk, n_events - ev0),
                ev0, seed, lean, pack, d)

    try:
        for c in range(min(2 * n, n_chunks)):
            submit(c)
        for c in range(n_chunks):
            result = futures.pop(c).result()
            submit(c + 2 * n)
            yield result
    finally:
        for f in futures.values():
            f.cancel()
        for p in pools:
            p.shutdown(wait=True)


def sample_particles_meshed(surf, species_table: SpeciesTable, chosen_idx,
                            df_data: DeltafData, cfg: Config,
                            laguerre: GaussLaguerre, n_events: int,
                            mesh: Mesh, device=None, seed: int | None = None,
                            report=None, chunk_consumer=None,
                            lean: bool = False):
    """core/sampler.py::sample_particles with the chunks spread over
    ``mesh`` (meshed_chunks): the same arguments, chunks and results.  The
    campaign is prepared on ``device`` (default: the mesh's first device).
    Without ``chunk_consumer`` the full-form chunks are concatenated on
    ``device``."""
    device = torch.device(device if device is not None
                          else mesh.flat()[0])
    plan = smp.plan_campaign(surf, species_table, chosen_idx, df_data, cfg,
                             laguerre, n_events, device, seed, lean)
    stats, chunks = [], []
    for ch, s in meshed_chunks(plan.camp, n_events, plan.per_chunk,
                               plan.seed, mesh, lean, plan.pack):
        stats.append(s)
        if chunk_consumer is not None:
            chunk_consumer(ch)
        else:
            chunks.append({k: v.to(device) if isinstance(v, torch.Tensor)
                           else v for k, v in ch.items()})
    return smp.finish_campaign(plan, stats, surf, report,
                               None if chunk_consumer is not None
                               else chunks)


def sample_histograms_meshed(surf, species_table: SpeciesTable, chosen_idx,
                             df_data: DeltafData, cfg: Config,
                             laguerre: GaussLaguerre, n_events: int,
                             mesh: Mesh, device=None,
                             seed: int | None = None, report=None):
    """The test-sampler campaign (test_sampler = 1) over ``mesh``: each
    chunk binned on its device, the histograms added on the first chunk's
    device in event order.  Returns (SampledHistograms, diagnostics)."""
    binner = ChunkBinner(len(chosen_idx), cfg)
    diags = sample_particles_meshed(surf, species_table, chosen_idx, df_data,
                                    cfg, laguerre, n_events, mesh, device,
                                    seed, report, chunk_consumer=binner)
    return binner.result(n_events), diags


def _per_device(setup: smp.SamplerSetup, species, mcid, seed: int,
                cfg: Config, events_per_device: int, mesh: Mesh):
    """Device k of ``mesh`` samples ``events_per_device`` events with the
    stream chunk_generator(seed, k); yields each device's full-form chunk
    in device order."""
    camp = smp.prepare_campaign(setup, species, np.asarray(mcid), cfg)
    n = mesh.size
    return (ch for ch, _ in meshed_chunks(
        camp, events_per_device * n, events_per_device, seed, mesh))


def sharded_sampler_counts(setup: smp.SamplerSetup, species, mcid, seed: int,
                           cfg: Config, events_per_device: int, mesh: Mesh,
                           pt_bins: int = 32):
    """Every device of ``mesh`` samples ``events_per_device`` events (its
    own stream); returns the summed per-species kept counts (S,) and the
    kept hadrons' pT histogram (pt_bins bins over [0, 3) GeV), f64 on the
    setup's device.  The JAX function's capacity_per_device has no
    counterpart: the port's chunks are sized exactly (core/sampler.py::
    draw_counts)."""
    dev = setup.rates.device
    S = species.mass.shape[0]
    counts = torch.zeros(S, dtype=torch.float64, device=dev)
    hist = torch.zeros(pt_bins, dtype=torch.float64, device=dev)
    for ch in _per_device(setup, species, mcid, seed, cfg, events_per_device,
                          mesh):
        sp = ch["sp_idx"].to(dev)
        pT = torch.sqrt(ch["px"] ** 2 + ch["py"] ** 2).to(dev)
        ib = torch.clamp((pT / 3.0 * pt_bins).to(torch.int64), 0,
                         pt_bins - 1)
        counts += torch.bincount(sp, minlength=S).to(torch.float64)
        hist += torch.bincount(ib, minlength=pt_bins).to(torch.float64)
    return counts, hist


def sharded_sampler_histograms(setup: smp.SamplerSetup, species, mcid,
                               seed: int, cfg: Config,
                               events_per_device: int, mesh: Mesh) -> dict:
    """Every device of ``mesh`` samples ``events_per_device`` events; the
    full test-histogram set (core/sampler_hist.py::bin_histograms: int64
    counts and f64 v_n sums) summed over the devices, on the setup's
    device.  No capacity_per_device, as in sharded_sampler_counts."""
    dev = setup.rates.device
    acc = None
    for ch in _per_device(setup, species, mcid, seed, cfg, events_per_device,
                          mesh):
        h = {k: v.to(dev) for k, v in
             bin_histograms(ch, species.mass.shape[0], cfg).items()}
        h["pT_count"] = h["dN_2pipTdpTdy"]
        if acc is None:
            acc = h
        else:
            for k, v in h.items():
                if k != "pT_count":
                    acc[k] += v
    return acc
