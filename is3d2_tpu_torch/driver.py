"""Top-level particlization driver, operations 0, 1 and 2.

Counterpart of is3d2_tpu/driver.py (the reference's IS3D class,
iS3D.cpp:81-282): load parameters, surface, PDG list, delta-f coefficient
tables and quadrature grids, then on ``device`` compute the spacetime
distributions dN/dX (operation 0) or the continuous spectra (operation 1),
or sample hadrons (operation 2) into the test histograms or the OSCAR event
files, then for a mode-5 surface the spin polarization, and write the
result files.

Library use (the JETSCAPE-style in-memory path, iS3D.cpp:33-78) is
``IS3D.load_surface_from_memory(...)`` followed by
``run_particlization(fo_from_file=False)``; after operation 2 without files
(``write=False``) the sampled particles are ``.final_particles``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from .config import Config
from .core.sampler import (ChunkCollector, compute_total_yield,
                           number_of_events, sample_particles)
from .core.polarization import compute_polarization
from .core.sampler_hist import ChunkBinner
from .core.spacetime import compute_dN_dX
from .core.spectra import compute_spectra
from .io import output
from .io.deltaf_tables import DeltafTables
from .io.pdg import read_pdg
from .io.surface import SurfaceData, read_surface, surface_from_memory
from .io.tables import GaussLaguerre, GaussLegendre, MomentumGrids, load_table
from .physics.deltaf import DeltafData, compute_particle_densities
from .report import RunReport, check_invariants


class IS3D:
    """One particlization run rooted at a working directory laid out like the
    reference repo (PDG/, tables/, deltaf_coefficients/, input/, results/).

    ``device`` is where the engines run ("cuda" by default, or "cpu").
    The CPU is taken only when asked for: without it, a machine where torch
    sees no GPU raises rather than running the plain version for hours."""

    def __init__(self, workdir: str | Path = ".",
                 cfg: Config | None = None,
                 data_dir: str | Path | None = None,
                 device: str | torch.device | None = None):
        self.workdir = Path(workdir)
        self.data_dir = Path(data_dir) if data_dir else self.workdir
        if cfg is None:
            cfg = Config.from_file(self.workdir / "iS3D_parameters.dat")
        cfg.validate_slice()
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("torch sees no CUDA device; pass "
                               "device='cpu' (--device cpu) to run on the CPU")
        self.surface: SurfaceData | None = None
        self.spectra = None
        self.dN_dX = None
        self.histograms = None
        self.final_particles = None
        self.n_events = None
        self.sampler_diags = None
        self.polarization = None
        self.report = RunReport()

    def load_surface_from_file(self, path: str | Path | None = None) -> None:
        path = Path(path) if path else self.workdir / "input/surface.dat"
        self.surface = read_surface(path, self.cfg.mode, self.cfg.dimension,
                                    bool(self.cfg.include_baryon))

    def load_surface_from_memory(self, **fields) -> None:
        self.surface = surface_from_memory(**fields)

    def _setup(self):
        cfg = self.cfg
        data = self.data_dir
        self.species = read_pdg(cfg.hrg_eos, data / "PDG")
        chosen_mcids = load_table(data / "PDG/chosen_particles.dat")[:, 0].astype(int)
        self.chosen_mcids = chosen_mcids
        self.chosen_idx = self.species.chosen_indices(
            chosen_mcids, group_by_mass=bool(cfg.group_particles))

        self.laguerre = GaussLaguerre.from_file(data / "tables/gauss/gla_roots_weights.txt")
        self.legendre = GaussLegendre.from_file(data / "tables/gauss/gauss_legendre.dat")
        self.grids = MomentumGrids.from_dir(data / "tables")

        # surface-averaged thermodynamics (cross-phase handoff file,
        # readindata.cpp:363-366)
        self.plasma = self.surface.thermo_averages()
        self.plasma.write(self.workdir
                          / "tables/thermodynamic/average_thermodynamic_quantities.dat")

        tables = DeltafTables.load(cfg.hrg_eos, bool(cfg.include_baryon),
                                   data / "deltaf_coefficients/vh")
        self.df_data = DeltafData(tables, cfg.df_mode, bool(cfg.include_baryon))
        if not cfg.include_baryon:
            self.df_data.compute_jonah_coefficients(self.species, self.laguerre,
                                                    self.plasma)
        compute_particle_densities(self.species, self.df_data, self.laguerre,
                                   self.plasma)

    def run_particlization(self, fo_from_file: bool = True,
                           write: bool = True) -> None:
        """Run the configured operation.  With ``fo_from_file`` False a
        surface already loaded (load_surface_from_memory) is used as it
        is; the file is read only when none is loaded."""
        cfg = self.cfg
        print(f"is3d2_tpu_torch particlization: operation={cfg.operation} "
              f"df_mode={cfg.df_mode} hrg_eos={cfg.hrg_eos} "
              f"dimension={cfg.dimension} device={self.device}", flush=True)
        t_read = time.time()
        if fo_from_file or self.surface is None:
            self.load_surface_from_file()
        t_read = time.time() - t_read
        print(f"surface: {self.surface.n_cells} cells ({t_read:.1f}s)",
              flush=True)
        t0 = time.time()
        self._setup()
        t_setup = time.time() - t0
        print(f"setup done ({t_setup:.1f}s): "
              f"{len(self.species)} species, {len(self.chosen_idx)} chosen, "
              f"T_avg = {self.plasma.temperature:.4f} GeV", flush=True)
        self.stage_seconds = {"read": t_read, "setup": t_setup}

        results = self.workdir / "results"
        mcids = [int(self.species.mc_id[i]) for i in self.chosen_idx]
        report = self.report
        report.n_cells = self.surface.n_cells
        report.invariants = check_invariants(
            self.surface, include_baryondiff=bool(cfg.include_baryon
                                                  and cfg.include_baryondiff_deltaf))

        t_compute = time.time()
        if cfg.operation == 0:
            print("computing spacetime distributions dN/dX ...", flush=True)
            self.dN_dX = compute_dN_dX(self.surface, self.species,
                                       self.chosen_idx, self.grids,
                                       self.df_data, cfg, self.device,
                                       laguerre=self.laguerre, report=report)
            self._mark_compute(t_compute, "dN/dX")
            if write:
                tw = time.time()
                output.write_dN_dX(results, mcids, self.dN_dX, cfg)
                self.stage_seconds["write"] = time.time() - tw
        elif cfg.operation == 1:
            print("computing continuous momentum spectra ...", flush=True)
            spectra = compute_spectra(self.surface, self.species,
                                      self.chosen_idx, self.grids,
                                      self.df_data, cfg, self.device,
                                      laguerre=self.laguerre, report=report)
            self.spectra = spectra
            self._mark_compute(t_compute, "spectra")
            if write:
                tw = time.time()
                for writer in (output.write_spectra, output.write_vn,
                               output.write_dN_2pipTdpTdy,
                               output.write_dN_dphidy, output.write_dN_dy):
                    writer(results, mcids, spectra, self.grids, cfg.dimension)
                self.stage_seconds["write"] = time.time() - tw
        else:
            self._sample(results, mcids, t_compute, write)
        if cfg.mode == 5:
            self._polarization(results, write)
        if report.reconstruction is not None:
            # part of compute: the famod prep (df 5)
            self.stage_seconds["famod_prep"] = report.reconstruction.seconds

        report.print()
        print(f"Particlization took {time.time() - t0:.3f} seconds")
        print("stage seconds: " + json.dumps(self.stage_seconds), flush=True)

    def _sample(self, results: Path, mcids, t_compute: float,
                write: bool) -> None:
        """Operation 2: the yield estimate, the event count, then the
        sampler's chunks streamed into the histogram binner
        (test_sampler = 1), the event-file writer (test_sampler = 0) or,
        without files, the collector of ``final_particles``."""
        cfg = self.cfg
        args = (self.surface, self.species, self.chosen_idx, self.df_data,
                cfg, self.laguerre)
        Ntot = compute_total_yield(*args, self.device)
        n_events = number_of_events(Ntot, cfg)
        self.n_events = n_events
        print(f"Estimated total particle yield = {int(Ntot)} particles; "
              f"sampling {n_events} events", flush=True)

        if cfg.test_sampler:
            consumer = ChunkBinner(len(mcids), cfg)
        elif write:
            consumer = output.StreamingEventWriter(results,
                                                   csv=bool(cfg.write_csv))
        else:
            consumer = ChunkCollector()
        lean = not cfg.test_sampler
        self.sampler_diags = sample_particles(
            *args, n_events, self.device, report=self.report,
            chunk_consumer=consumer, lean=lean)
        t_end = time.perf_counter()
        self._mark_compute(t_compute, "sampling")
        ta = time.time()
        if cfg.test_sampler:
            self.histograms = consumer.result(n_events)
            self.stage_seconds["assemble"] = time.time() - ta
            if write:
                tw = time.time()
                output.write_sampled_histograms(results, mcids,
                                                self.histograms, cfg)
                self.stage_seconds["write"] = time.time() - tw
                print(f"histogram output stage took "
                      f"{self.stage_seconds['write']:.3f} seconds", flush=True)
            return
        if write:
            consumer.close()
            self.stage_seconds["write_exposed"] = time.time() - ta
        self.final_particles = consumer.particle_list()
        self.stage_seconds["assemble"] = time.time() - ta
        if write:
            overlap = consumer.overlapped_seconds(t_end)
            self.stage_seconds["write"] = consumer.write_seconds
            self.stage_seconds["write_transfer"] = consumer.transfer_seconds
            self.stage_seconds["write_overlapped"] = overlap
            self.stage_seconds["write_boost"] = consumer.boost_seconds
            print(f"particle-list export: {consumer.rows_written} rows / "
                  f"{consumer.events_written} events, "
                  f"{consumer.write_seconds:.3f} s host boost+format+write "
                  f"({consumer.boost_seconds:.3f} s of it the host boost, "
                  f"{overlap:.3f} s overlapped with sampling), "
                  f"{consumer.transfer_seconds:.3f} s waiting for "
                  "device->host copies", flush=True)

    def _polarization(self, results: Path, write: bool) -> None:
        """The spin polarization of a mode-5 surface, after any operation
        (is3d2_tpu/driver.py:243-250): every chosen species, never grouped;
        stage_seconds["polarization"] includes the write."""
        print("computing spin polarization ...", flush=True)
        t0 = time.time()
        self.polarization = compute_polarization(
            self.surface, self.species, self.chosen_idx, self.grids,
            self.plasma, self.cfg, self.device)
        if write:
            output.write_polarization(results, *self.polarization,
                                      self.grids, self.cfg.dimension)
        self.stage_seconds["polarization"] = time.time() - t0

    def _mark_compute(self, t_start: float, what: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t_start
        self.stage_seconds["compute"] = dt
        # the reference prints "Spectra calculation took X seconds"
        # (EmissionFunction.cpp:1375-1385); keep the same shape
        print(f"{what} calculation took {dt:.3f} seconds", flush=True)
