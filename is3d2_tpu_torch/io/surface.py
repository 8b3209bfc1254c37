"""Freezeout-surface reader (mode 1).

Counterpart of is3d2_tpu/io/surface.py, which replaces the reference's
FO_data_reader (src/cpp/readindata.cpp:122-729).  The reader produces a
:class:`SurfaceData` struct-of-arrays (numpy f64, one entry per freezeout
cell) in iS3D's internal units:

  tau,x,y [fm]; eta [1]; dsigma_mu: dat,dax [fm^-2] ... ; u^mu [1, fm^-1];
  E,P [GeV/fm^3]; T [GeV]; pi^munu [GeV/fm^3(4)]; bulkPi [GeV/fm^3];
  muB [GeV]; nB [fm^-3]; V^mu [fm^-3(4)].

Only mode 1 (CPU VH, raw hbar=1 units, readindata.cpp:167-367) is ported,
read with the threaded native parser (io/fastio.py); the other formats come
later (ROADMAP A2b).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..constants import hbarC
from .fastio import load_table_fast

_FIELDS = (
    "tau", "x", "y", "eta",
    "dat", "dax", "day", "dan",
    "ux", "uy", "un",
    "E", "T", "P",
    "pixx", "pixy", "pixn", "piyy", "piyn",
    "bulkPi",
    "muB", "nB", "Vx", "Vy", "Vn",
    "wtx", "wty", "wtn", "wxy", "wxn", "wyn",
)


@dataclasses.dataclass
class ThermoAverages:
    """ds_max-weighted surface averages (the reference's Plasma struct,
    readindata.h:37-50; computed in readindata.cpp:330-366)."""

    temperature: float                # GeV
    energy_density: float             # GeV/fm^3
    pressure: float                   # GeV/fm^3
    baryon_chemical_potential: float  # GeV
    net_baryon_density: float         # fm^-3

    def write(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(
            f"{self.temperature:.15g}\n{self.energy_density:.15g}\n"
            f"{self.pressure:.15g}\n{self.baryon_chemical_potential:.15g}\n"
            f"{self.net_baryon_density:.15g}"
        )


@dataclasses.dataclass
class SurfaceData:
    """Struct-of-arrays freezeout surface (iS3D units)."""

    tau: np.ndarray
    x: np.ndarray
    y: np.ndarray
    eta: np.ndarray
    dat: np.ndarray
    dax: np.ndarray
    day: np.ndarray
    dan: np.ndarray
    ux: np.ndarray
    uy: np.ndarray
    un: np.ndarray
    E: np.ndarray
    T: np.ndarray
    P: np.ndarray
    pixx: np.ndarray
    pixy: np.ndarray
    pixn: np.ndarray
    piyy: np.ndarray
    piyn: np.ndarray
    bulkPi: np.ndarray
    muB: np.ndarray
    nB: np.ndarray
    Vx: np.ndarray
    Vy: np.ndarray
    Vn: np.ndarray
    wtx: np.ndarray
    wty: np.ndarray
    wtn: np.ndarray
    wxy: np.ndarray
    wxn: np.ndarray
    wyn: np.ndarray

    @property
    def n_cells(self) -> int:
        return self.tau.shape[0]

    @classmethod
    def zeros(cls, n: int) -> "SurfaceData":
        return cls(**{f: np.zeros(n, dtype=np.float64) for f in _FIELDS})

    def ds_max(self) -> np.ndarray:
        """Max volume element |ds| = |u.ds| + sqrt(|(u.ds)^2 - ds.ds|)
        (readindata.cpp:342-344)."""
        tau2 = self.tau**2
        ut = np.sqrt(1.0 + self.ux**2 + self.uy**2 + tau2 * self.un**2)
        uds = ut * self.dat + self.ux * self.dax + self.uy * self.day + self.un * self.dan
        ds_ds = self.dat**2 - self.dax**2 - self.day**2 - self.dan**2 / tau2
        return np.abs(uds) + np.sqrt(np.abs(uds**2 - ds_ds))

    def thermo_averages(self) -> ThermoAverages:
        w = self.ds_max()
        tot = w.sum()
        return ThermoAverages(
            temperature=float((self.T * w).sum() / tot),
            energy_density=float((self.E * w).sum() / tot),
            pressure=float((self.P * w).sum() / tot),
            baryon_chemical_potential=float((self.muB * w).sum() / tot),
            net_baryon_density=float((self.nB * w).sum() / tot),
        )


def _enforce_boost_invariance(s: SurfaceData) -> None:
    """2+1d surfaces: zero the spacetime rapidity (readindata.cpp:310-327)."""
    s.eta[:] = 0.0


def _read_cpu_vh(cols: np.ndarray, mode: int, include_baryon: bool) -> SurfaceData:
    n = cols.shape[0]
    s = SurfaceData.zeros(n)
    s.tau, s.x, s.y, s.eta = cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3]
    s.dat, s.dax, s.day, s.dan = cols[:, 4], cols[:, 5], cols[:, 6], cols[:, 7]
    s.ux, s.uy, s.un = cols[:, 8], cols[:, 9], cols[:, 10]
    s.E = cols[:, 11] * hbarC   # fm^-4 -> GeV/fm^3
    s.T = cols[:, 12] * hbarC   # fm^-1 -> GeV
    s.P = cols[:, 13] * hbarC
    s.pixx = cols[:, 14] * hbarC
    s.pixy = cols[:, 15] * hbarC
    s.pixn = cols[:, 16] * hbarC
    s.piyy = cols[:, 17] * hbarC
    s.piyn = cols[:, 18] * hbarC
    s.bulkPi = cols[:, 19] * hbarC
    c = 20
    if include_baryon:
        s.muB = cols[:, c] * hbarC
        s.nB = cols[:, c + 1]
        s.Vx = cols[:, c + 2]
        s.Vy = cols[:, c + 3]
        s.Vn = cols[:, c + 4]
        c += 5
    if mode == 5:
        s.wtx, s.wty, s.wtn = cols[:, c], cols[:, c + 1], cols[:, c + 2]
        s.wxy, s.wxn, s.wyn = cols[:, c + 3], cols[:, c + 4], cols[:, c + 5]
    return s


def read_surface(path: str | Path, mode: int, dimension: int,
                 include_baryon: bool) -> SurfaceData:
    """Read input/surface.dat; only the mode-1 format is ported."""
    if mode != 1:
        raise NotImplementedError(
            f"surface mode {mode} is not ported yet (ROADMAP A2b)")
    cols = load_table_fast(path)
    s = _read_cpu_vh(cols, mode, include_baryon)
    if dimension == 2:
        _enforce_boost_invariance(s)
    return s
