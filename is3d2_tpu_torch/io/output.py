"""Result writers with reference-compatible file formats and naming.

Counterpart of is3d2_tpu/io/output.py, which mirrors the writers of
EmissionFunction.cpp:406-975:

  results/continuous/dN_pTdpTdphidy_<mcid>.dat      (y phip pT value)
  results/continuous/vn_<mcid>.dat                  (y pT v1..v7)
  results/continuous/dN_2pipTdpTdy_<mcid>.dat
  results/continuous/dN_dphidy_<mcid>.dat
  results/continuous/dN_dy_<mcid>.dat
  results/continuous/{dN_taudtaudy,dN_2pirdrdy,dN_dphidy}_<mcid>.dat
                                                    (operation 0)
  results/{St,Sx,Sy,Sn}.dat                         (polarization, mode 5)
  results/sampled/<obs>/..._test.dat                (sampler tests)
  results/particle_list_osc_<n>.dat                 (OSCAR)
  results/particle_list_<n>.dat                     (CSV, write_csv = 1)

The op-0 and op-1 block tables, the polarization files and the particle
lists are formatted by the threaded native writer (io/fastio.py), which
prints %.Ne as printf does.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path

import numpy as np

from ..config import Config
from ..constants import two_pi
from .fastio import write_blocks_fast, write_events_fast
from .tables import MomentumGrids


def _ensure(path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def _continuous_dir(results_dir: Path) -> Path:
    return _ensure(Path(results_dir) / "continuous" / "x").parent


def write_spectra(results_dir: Path, mcids, spectra: np.ndarray,
                  grids: MomentumGrids, dimension: int) -> None:
    """dN_pTdpTdphidy_<mcid>.dat (EmissionFunction.cpp:406-440)."""
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    d = _continuous_dir(results_dir)
    rows = Ny * Nphi * NpT
    y_c = np.repeat(y_vals, Nphi * NpT)
    phi_c = np.tile(np.repeat(grids.phi, NpT), Ny)
    pT_c = np.tile(grids.pT, Ny * Nphi)
    vals = np.asarray(spectra).transpose(0, 3, 2, 1).reshape(S, rows)
    offsets = np.arange(S + 1, dtype=np.int64) * rows
    cols = [np.tile(y_c, S), np.tile(phi_c, S), np.tile(pT_c, S),
            vals.ravel()]
    write_blocks_fast(str(d / "dN_pTdpTdphidy_%lld.dat"), list(mcids),
                      "y\tphip\tpT\tdN_pTdpTdphidy", "\t", 8, offsets, cols,
                      blank_every=NpT, blank_tail=1)


def write_vn(results_dir: Path, mcids, spectra: np.ndarray,
             grids: MomentumGrids, dimension: int, k_max: int = 7) -> None:
    """vn_<mcid>.dat (EmissionFunction.cpp:804-878)."""
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    w = grids.phi_weight
    cos_k = np.stack([np.cos((k + 1) * grids.phi) for k in range(k_max)])
    sin_k = np.stack([np.sin((k + 1) * grids.phi) for k in range(k_max)])

    sp_all = np.asarray(spectra)
    wsp = w[None, None, :, None] * sp_all                      # (S,NpT,Nphi,Ny)
    den = wsp.sum(axis=2)                                      # (S,NpT,Ny)
    re = np.einsum("kf,spfy->kspy", cos_k, wsp)
    im = np.einsum("kf,spfy->kspy", sin_k, wsp)
    vns = np.where(den[None] < 1e-15, 0.0,
                   np.hypot(re, im) / np.maximum(den[None], 1e-300))

    d = _continuous_dir(results_dir)
    rows = Ny * NpT
    y_c = np.tile(np.repeat(y_vals, NpT), S)
    pT_c = np.tile(grids.pT, Ny * S)
    cols = [y_c, pT_c] + [vns[k].transpose(0, 2, 1).reshape(-1)
                          for k in range(k_max)]
    offsets = np.arange(S + 1, dtype=np.int64) * rows
    write_blocks_fast(str(d / "vn_%lld.dat"), list(mcids), "", "\t", 8,
                      offsets, cols, blank_every=NpT, blank_tail=1)


def write_dN_2pipTdpTdy(results_dir: Path, mcids, spectra, grids, dimension):
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    vals = np.einsum("f,spfy->spy", grids.phi_weight,
                     np.asarray(spectra)) / two_pi          # (S,NpT,Ny)
    d = _continuous_dir(results_dir)
    rows = Ny * NpT
    cols = [np.tile(np.repeat(y_vals, NpT), S), np.tile(grids.pT, Ny * S),
            vals.transpose(0, 2, 1).reshape(-1)]
    offsets = np.arange(S + 1, dtype=np.int64) * rows
    write_blocks_fast(str(d / "dN_2pipTdpTdy_%lld.dat"), list(mcids), "",
                      "\t", 8, offsets, cols, blank_every=NpT, blank_tail=0)


def write_dN_dphidy(results_dir: Path, mcids, spectra, grids, dimension):
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    vals = np.einsum("p,spfy->sfy", grids.pT_weight,
                     np.asarray(spectra))                    # (S,Nphi,Ny)
    d = _continuous_dir(results_dir)
    rows = Ny * Nphi
    cols = [np.tile(np.repeat(y_vals, Nphi), S), np.tile(grids.phi, Ny * S),
            vals.transpose(0, 2, 1).reshape(-1)]
    offsets = np.arange(S + 1, dtype=np.int64) * rows
    write_blocks_fast(str(d / "dN_dphidy_%lld.dat"), list(mcids), "", "\t",
                      8, offsets, cols, blank_every=Nphi, blank_tail=0)


def write_dN_dy(results_dir: Path, mcids, spectra, grids, dimension):
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    d = _continuous_dir(results_dir)
    for i, mcid in enumerate(mcids):
        with open(d / f"dN_dy_{mcid}.dat", "w") as fh:
            for iy in range(Ny):
                val = float((grids.phi_weight[None, :]
                             * grids.pT_weight[:, None]
                             * spectra[i, :, :, iy]).sum())
                fh.write(f"{y_vals[iy]:.8f}\t{val:.8f}\n")


def write_dN_dX(results_dir: Path, mcids, dX, cfg: Config) -> None:
    """Spacetime distributions (SpacetimeDistribution.cpp:448-496):
    dN_taudtaudy, dN_2pirdrdy and dN_dphidy per species, (bin middle,
    normalized value) rows in %.6e."""
    d = _continuous_dir(results_dir)
    S = len(mcids)
    for name, mid, vals in zip(("dN_taudtaudy", "dN_2pirdrdy", "dN_dphidy"),
                               (dX.tau_mid, dX.r_mid, dX.phi_mid),
                               dX.normalized(cfg)):
        n = mid.shape[0]
        write_blocks_fast(str(d / f"{name}_%lld.dat"), list(mcids), "", "\t",
                          6, np.arange(S + 1, dtype=np.int64) * n,
                          [np.tile(mid, S), np.asarray(vals).reshape(-1)])


POLARIZATION_FILES = ("St", "Sx", "Sy", "Sn")


def write_polarization(results_dir: Path, St, Sx, Sy, Sn, Snorm,
                       grids: MomentumGrids, dimension: int) -> None:
    """St/Sx/Sy/Sn.dat with S^mu / Snorm (EmissionFunction.cpp:561-609):
    rows (y, phi, pT, value) in %.8e, species, y, phi and pT nested in that
    order, a blank line after every NpT rows; no header.  One call of the
    threaded native writer for the four files."""
    S, NpT, Nphi, Ny = St.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    d = _ensure(Path(results_dir) / "x").parent
    rows = S * Ny * Nphi * NpT
    n = len(POLARIZATION_FILES)
    key = [np.tile(np.repeat(y_vals, Nphi * NpT), S * n),
           np.tile(np.repeat(grids.phi, NpT), Ny * S * n),
           np.tile(grids.pT, Nphi * Ny * S * n)]
    vals = np.concatenate([
        (np.asarray(a) / np.asarray(Snorm)).transpose(0, 3, 2, 1).ravel()
        for a in (St, Sx, Sy, Sn)])
    write_blocks_fast(str(d / "polarization_%lld.tmp"), list(range(n)), "",
                      "\t", 8, np.arange(n + 1, dtype=np.int64) * rows,
                      [*key, vals], blank_every=NpT, blank_tail=1)
    for i, name in enumerate(POLARIZATION_FILES):
        (d / f"polarization_{i}.tmp").replace(d / f"{name}.dat")


# ----------------------------------------------------------------------
# sampled outputs
# ----------------------------------------------------------------------

def _write_rows(path: Path, fmt: str, cols) -> None:
    """Rows of the float columns, each formatted by the %-template ``fmt``
    (one row, newline included), in one string: the bytes of a per-row
    f-string loop with the same format specs."""
    data = np.column_stack([np.asarray(c, dtype=np.float64) for c in cols])
    _ensure(path).write_text((fmt * data.shape[0]) % tuple(data.ravel()))


def write_sampled_histograms(results_dir: Path, mcids, hist, cfg: Config):
    """Event-averaged sampler-test distributions
    (EmissionFunction.cpp:685-975), each file formatted in one %-operation."""
    nev = hist.n_events
    y_w = 2.0 * cfg.y_cut / cfg.y_bins
    eta_w = 2.0 * cfg.eta_cut / cfg.eta_bins
    pT_w = (cfg.pT_max - cfg.pT_min) / cfg.pT_bins
    phip_w = two_pi / cfg.phip_bins
    tau_w = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    r_w = (cfg.r_max - cfg.r_min) / cfg.r_bins

    y_mid = -cfg.y_cut + y_w * (np.arange(cfg.y_bins) + 0.5)
    eta_mid = -cfg.eta_cut + eta_w * (np.arange(cfg.eta_bins) + 0.5)
    pT_mid = cfg.pT_min + pT_w * (np.arange(cfg.pT_bins) + 0.5)
    phip_mid = phip_w * (np.arange(cfg.phip_bins) + 0.5)
    tau_mid = cfg.tau_min + tau_w * (np.arange(cfg.tau_bins) + 0.5)
    r_mid = cfg.r_min + r_w * (np.arange(cfg.r_bins) + 0.5)
    out = Path(results_dir) / "sampled"
    f6, e6 = "%.6f\t%.6f\n", "%.6e\t%.6e\n"
    n_k = hist.vn_real.shape[0]

    for i, mcid in enumerate(mcids):
        _write_rows(out / "dN_dy" / f"dN_dy_{mcid}_test.dat", f6,
                    [y_mid, hist.dN_dy[i] / (y_w * nev)])
        _write_rows(out / "dN_dy" / f"dN_dy_{mcid}_average_test.dat", "%.6f\n",
                    [[hist.dN_dy[i].sum() / (2.0 * cfg.y_cut * nev)]])
        _write_rows(out / "dN_deta" / f"dN_deta_{mcid}_test.dat", f6,
                    [eta_mid, hist.dN_deta[i] / (eta_w * nev)])
        _write_rows(out / "dN_2pipTdpTdy" / f"dN_2pipTdpTdy_{mcid}_test.dat", e6,
                    [pT_mid, hist.dN_2pipTdpTdy[i]
                     / (two_pi * 2.0 * cfg.y_cut * pT_w * pT_mid * nev)])
        _write_rows(out / "dN_dphipdy" / f"dN_dphipdy_{mcid}_test.dat", e6,
                    [phip_mid, hist.dN_dphipdy[i] / (2.0 * cfg.y_cut * phip_w * nev)])
        cnt = hist.pT_count[i]
        vn = [np.where(cnt > 0, np.hypot(hist.vn_real[k, i], hist.vn_imag[k, i])
                       / np.maximum(cnt, 1), 0.0) for k in range(n_k)]
        _write_rows(out / "vn" / f"vn_{mcid}_test.dat",
                    "\t".join(["%.6e"] * (n_k + 1)) + "\n", [pT_mid, *vn])
        _write_rows(out / "dN_taudtaudy" / f"dN_taudtaudy_{mcid}_test.dat", e6,
                    [tau_mid, hist.dN_taudtaudy[i]
                     / (tau_mid * tau_w * nev * 2.0 * cfg.y_cut)])
        _write_rows(out / "dN_2pirdrdy" / f"dN_2pirdrdy_{mcid}_test.dat", e6,
                    [r_mid, hist.dN_2pirdrdy[i]
                     / (two_pi * r_mid * r_w * nev * 2.0 * cfg.y_cut)])
        _write_rows(out / "dN_dphisdy" / f"dN_dphisdy_{mcid}_test.dat", e6,
                    [phip_mid, hist.dN_dphisdy[i] / (phip_w * nev * 2.0 * cfg.y_cut)])


def _sort_by_event(particles, n_events: int):
    """One stable argsort of the valid rows by event id -> (order,
    offsets): event e owns rows order[offsets[e]:offsets[e+1]]."""
    idx = np.nonzero(particles.valid)[0]
    order = idx[np.argsort(particles.event[idx], kind="stable")]
    offsets = np.searchsorted(particles.event[order], np.arange(n_events + 1))
    return order, offsets


def _auto_precision(cols) -> int:
    """%.Ne digits: 16 (the reference's setprecision(16)) unless every
    column is float32-valued, where %.9e (10 significant digits) already
    round-trips the f32 payload exactly."""
    if all(np.asarray(c).dtype == np.float32 for c in cols):
        return 9
    return 16


_OSCAR_HEADER = "n pid px py pz E m x y z t"
_OSCAR_COLS = ("px", "py", "pz", "E", "mass", "x", "y", "z", "t")
_CSV_HEADER = "mcid,tau,x,y,eta,E,px,py,pz"
_CSV_COLS = ("tau", "x", "y", "eta", "E", "px", "py", "pz")


def write_particle_list_oscar(results_dir: Path, particles, n_events: int):
    """OSCAR particle lists for UrQMD/SMASH afterburners
    (write_particle_list_OSC, EmissionFunction.cpp:645-678): the reference's
    setprecision(16) for f64 data, %.9e (an exact round trip) for f32."""
    order, offsets = _sort_by_event(particles, n_events)
    _ensure(Path(results_dir) / "x")
    raw = [getattr(particles, c) for c in _OSCAR_COLS]
    precision = _auto_precision(raw)
    write_events_fast(str(Path(results_dir) / "particle_list_osc_%lld.dat"),
                       _OSCAR_HEADER, " ", precision, True, offsets,
                       particles.mcid[order],
                       [np.asarray(c)[order] for c in raw])


def write_particle_list_csv(results_dir: Path, particles, n_events: int):
    """Plain CSV particle lists (write_particle_list_toFile,
    EmissionFunction.cpp:611-642)."""
    order, offsets = _sort_by_event(particles, n_events)
    _ensure(Path(results_dir) / "x")
    write_events_fast(str(Path(results_dir) / "particle_list_%lld.dat"),
                       _CSV_HEADER, ",", 8, False, offsets,
                       particles.mcid[order],
                       [np.asarray(getattr(particles, c))[order]
                        for c in _CSV_COLS])


class StreamingEventWriter:
    """``chunk_consumer`` that exports each sampler chunk's event files on
    a writer thread while the device computes the next chunks.

    Chunks own disjoint event ranges [ev0, ev0 + n_ev), so every file is
    completed by exactly one chunk.  The caller's thread only starts the
    chunk's device -> host copies into pinned memory (ChunkCollector.stage)
    and queues it; the writer thread waits for the copy, boosts, sorts and
    formats (the native writer releases the GIL).  At most two chunks wait
    in the queue.  ``close()`` drains the queue and re-raises
    a writer error.  The kept host rows stay in a ChunkCollector, so
    ``particle_list()`` also returns the campaign's ParticleList (the
    library path).  ``oscar`` and ``csv`` choose the files: OSCAR
    (particle_list_osc_<event>.dat), CSV (particle_list_<event>.dat), both
    or neither; ``rows_written`` counts the rows of every file written."""

    def __init__(self, results_dir: Path, oscar: bool = True,
                 csv: bool = False):
        from ..core.sampler import ChunkCollector
        self._collector = ChunkCollector()
        self.results_dir = Path(results_dir)
        self.oscar = oscar
        self.csv = csv
        self.transfer_seconds = 0.0   # writer thread waiting for the copies
        self.write_seconds = 0.0      # host boost + sort + format + writes
        self.boost_seconds = 0.0      # of it: unpack, rebuild, lab boost
        self.busy = []                # (start, end) perf_counter of each write
        self.rows_written = 0
        self.events_written = 0
        _ensure(self.results_dir / "x")
        self._queue = queue.Queue(maxsize=2)
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def __call__(self, ch: dict) -> None:
        if self._error is not None:
            self.close()
        self._queue.put(self._collector.stage(ch))

    def _run(self) -> None:
        while True:
            staged = self._queue.get()
            if staged is None:
                return
            if self._error is not None:
                continue
            try:
                self._write(staged)
            except BaseException as e:   # handed to the caller by close()
                self._error = e

    def _write(self, staged: dict) -> None:
        t0 = time.perf_counter()
        if staged["done"] is not None:
            staged["done"].synchronize()
        t1 = time.perf_counter()
        part = self._collector.collect(staged)
        self.boost_seconds += time.perf_counter() - t1
        ev0, n_ev = int(staged["meta"]["ev0"]), int(staged["meta"]["n_ev"])
        order = np.argsort(part["event"], kind="stable")
        offsets = np.searchsorted(part["event"][order],
                                  np.arange(ev0, ev0 + n_ev + 1))
        mcid = self._collector._mcid_table[part["sp_idx"][order]]
        if self.oscar:
            raw = [part[c] for c in _OSCAR_COLS]
            self.rows_written += write_events_fast(
                str(self.results_dir / "particle_list_osc_%lld.dat"),
                _OSCAR_HEADER, " ", _auto_precision(raw), True, offsets,
                mcid, [r[order] for r in raw], event_base=ev0)
        if self.csv:
            self.rows_written += write_events_fast(
                str(self.results_dir / "particle_list_%lld.dat"),
                _CSV_HEADER, ",", 8, False, offsets, mcid,
                [part[c][order] for c in _CSV_COLS], event_base=ev0)
        self.events_written += n_ev
        t2 = time.perf_counter()
        self.transfer_seconds += t1 - t0
        self.write_seconds += t2 - t1
        self.busy.append((t1, t2))

    def close(self) -> None:
        """Wait for every queued chunk to be written; re-raise a writer
        error."""
        if self._thread.is_alive():
            self._queue.put(None)
            self._thread.join()
        if self._error is not None:
            raise self._error

    def overlapped_seconds(self, until: float) -> float:
        """Seconds of writing done before ``until`` (a perf_counter time:
        the end of the sampling compute)."""
        return sum(max(0.0, min(e, until) - s) for s, e in self.busy)

    def particle_list(self):
        return self._collector.particle_list()
