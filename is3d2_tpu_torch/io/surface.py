"""Freezeout-surface readers (modes 1, 2 and 3).

Counterpart of is3d2_tpu/io/surface.py, which replaces the reference's
FO_data_reader (src/cpp/readindata.cpp:122-729).  The reader produces a
:class:`SurfaceData` struct-of-arrays (numpy f64, one entry per freezeout
cell) in iS3D's internal units:

  tau,x,y [fm]; eta [1]; dsigma_mu: dat,dax [fm^-2] ... ; u^mu [1, fm^-1];
  E,P [GeV/fm^3]; T [GeV]; pi^munu [GeV/fm^3(4)]; bulkPi [GeV/fm^3];
  muB [GeV]; nB [fm^-3]; V^mu [fm^-3(4)].

Ported formats (``mode``), read with the threaded native parser
(io/fastio.py):
  1 : CPU VH, raw hbar=1 units (readindata.cpp:167-367)
  2 : legacy VAH P_L-matching, with (Lambda, a_L) inferred from the
      conformal factorization fit (readindata.cu:812-930)
  3 : legacy VAH (P_L, P_T)-matching with explicit (Lambda, a_T, a_L)
      columns (readindata.cu:932-1055)
Modes 2/3 fill the optional VAH fields (PL, PT, W^mu, Lambda, aT, aL,
upsilonB), which the df-5 famod prep uses instead of reconstructing the
anisotropic variables.  The other formats come later (ROADMAP A2b).
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

    # legacy VAH extras (surface modes 2/3 only; None for VH surfaces)
    PL: np.ndarray | None = None        # longitudinal pressure [GeV/fm^3]
    PT: np.ndarray | None = None        # transverse pressure [GeV/fm^3]
    Wt: np.ndarray | None = None        # W_perpz^mu diffusion current
    Wx: np.ndarray | None = None
    Wy: np.ndarray | None = None
    Wn: np.ndarray | None = None
    Lambda: np.ndarray | None = None    # anisotropic effective T [GeV]
    aT: np.ndarray | None = None
    aL: np.ndarray | None = None
    upsilonB: np.ndarray | None = None  # effective baryon chemical pot [GeV]
    nBL: np.ndarray | None = None

    @property
    def n_cells(self) -> int:
        return self.tau.shape[0]

    @property
    def has_aniso_variables(self) -> bool:
        return self.Lambda is not None

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


# [14/14] rational-approximant coefficients of the conformal factorization
# fit a_L(P_L/P_eq) (arsenal.cu:1018-1045), highest power first
AL_FIT_NUM = (
    0.048528166213735346, -0.6320131889637761, 1.462901772148128,
    8.04299287188939, -33.75866652773691, 12.673594148032494,
    44.45243622597357, 11.582755440134724, 0.7235583305942909,
    0.011776118846199547, 0.00004757224421671691, 4.2846163672079405e-8,
    7.2725449826862375e-12, 1.7179667824677117e-16, 2.307660683188896e-22,
)
AL_FIT_DEN = (
    -0.014599143701745957, 0.4703844693488544, -4.005934533735304,
    11.636087951096759, 1.5449108423263358, -55.213789667214364,
    44.38310108782752, 40.1581708710626, 5.466199358534425,
    0.18185453852532632, 0.0015212379997299082, 2.9819348588423508e-6,
    1.2033043382301483e-9, 8.059757191879689e-14, 5.595674409987461e-19,
)


def aL_fit(pl_peq_ratio: np.ndarray) -> np.ndarray:
    """Conformal factorization fit a_L(P_L/P_eq) (arsenal.cu:1018-1045):
    the [14/14] rational approximant of the legacy VAH P_L-matching
    pipeline."""
    x = np.asarray(pl_peq_ratio, dtype=np.float64)
    return np.polyval(AL_FIT_NUM, x) / np.polyval(AL_FIT_DEN, x)


def R200(aL: np.ndarray) -> np.ndarray:
    """aL * t_200(1/aL^2 - 1), the conformal I_200 factor
    (arsenal.cu:1047-1079)."""
    aL = np.asarray(aL, dtype=np.float64)
    x = 1.0 / (aL * aL) - 1.0
    if np.any(x <= -1.0):
        raise ValueError("R200: 1/aL^2 - 1 <= -1 is out of bounds")
    delta = 0.01
    with np.errstate(invalid="ignore"):
        xp = np.where(x > delta, x, 1.0)
        t_pos = 1.0 + (1.0 + x) * np.arctan(np.sqrt(xp)) / np.sqrt(xp)
        xn = np.where(x < -delta, x, -0.5)
        t_neg = 1.0 + (1.0 + x) * np.arctanh(np.sqrt(-xn)) / np.sqrt(-xn)
    t_tay = 2.0 + x * (0.6666666666666667 + x * (-0.1333333333333333
            + x * (0.05714285714285716 + x * (-0.031746031746031744
            + x * (0.020202020202020193 + x * (-0.013986013986013984
            + (0.010256410256410262 - 0.00784313725490196 * x) * x))))))
    t200 = np.where(np.abs(x) <= delta, t_tay,
                    np.where(x > delta, t_pos, t_neg))
    return aL * t200


def _read_vah_common(cols: np.ndarray) -> SurfaceData:
    """Columns both legacy VAH formats share: x^mu, dsigma_mu, u^mu (col 8
    is u^t, recomputed), E, T, the five independent pi^munu (16..25: tt tx
    ty tn xx xy xn yy yn nn) and W^mu (26..29)."""
    s = SurfaceData.zeros(cols.shape[0])
    s.tau, s.x, s.y, s.eta = cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3]
    s.dat, s.dax, s.day, s.dan = cols[:, 4], cols[:, 5], cols[:, 6], cols[:, 7]
    s.ux, s.uy, s.un = cols[:, 9], cols[:, 10], cols[:, 11]
    s.E = cols[:, 12] * hbarC
    s.T = cols[:, 13] * hbarC
    s.pixx = cols[:, 20] * hbarC
    s.pixy = cols[:, 21] * hbarC
    s.pixn = cols[:, 22] * hbarC
    s.piyy = cols[:, 23] * hbarC
    s.piyn = cols[:, 24] * hbarC
    s.Wt = cols[:, 26] * hbarC
    s.Wx = cols[:, 27] * hbarC
    s.Wy = cols[:, 28] * hbarC
    s.Wn = cols[:, 29] * hbarC
    return s


def _read_vah_pl_match(cols: np.ndarray) -> SurfaceData:
    """Legacy VAH P_L-matching format (readindata.cu:812-930):
    (x^mu, da_mu, u^mu, E, T, P, pl, pi^munu[10], W^mu[4], bulkPi), raw
    hbar=1 units; (a_L, Lambda) inferred by the conformal fit."""
    n = cols.shape[0]
    s = _read_vah_common(cols)
    s.P = cols[:, 14] * hbarC
    s.PL = cols[:, 15] * hbarC
    s.bulkPi = cols[:, 30] * hbarC
    pl_over_p = cols[:, 15] / cols[:, 14]
    if np.any(pl_over_p >= 3.0):
        raise ValueError("VAH PL-match: pl/p >= 3 is outside the conformal "
                         "factorization fit (readindata.cu:920)")
    aL = aL_fit(pl_over_p)
    s.aL = aL
    s.aT = np.ones(n)
    s.Lambda = (cols[:, 13] / (0.5 * aL * R200(aL)) ** 0.25) * hbarC
    s.PT = 0.5 * (3.0 * (s.P + s.bulkPi) - s.PL)   # trace matching
    s.upsilonB = np.zeros(n)
    return s


def _read_vah_plpt_match(cols: np.ndarray, include_baryon: bool,
                         include_baryondiff: bool) -> SurfaceData:
    """Legacy VAH (P_L, P_T)-matching format (readindata.cu:932-1055):
    (x^mu, da_mu, u^mu, e, T, pl, pt, pi^munu[10], W^mu[4], Lambda, aT, aL,
    [muB upsilonB], [nB nBL V^mu[3]]), raw hbar=1 units."""
    n = cols.shape[0]
    s = _read_vah_common(cols)
    s.PL = cols[:, 14] * hbarC
    s.PT = cols[:, 15] * hbarC
    # the format stores no equilibrium P (the reference leaves it unset);
    # its isotropic part stands in for the thermodynamic averages
    s.P = (s.PL + 2.0 * s.PT) / 3.0
    s.Lambda = cols[:, 30] * hbarC
    s.aT = cols[:, 31]
    s.aL = cols[:, 32]
    s.upsilonB = np.zeros(n)
    c = 33
    if include_baryon:
        s.muB = cols[:, c] * hbarC
        s.upsilonB = cols[:, c + 1] * hbarC
        c += 2
    if include_baryondiff:
        s.nB = cols[:, c] * hbarC
        s.nBL = cols[:, c + 1] * hbarC
        # V^mu == V_perp^mu: (Vt, Vx, Vy), no Vn column
        s.Vx = cols[:, c + 3] * hbarC
        s.Vy = cols[:, c + 4] * hbarC
    return s


def read_surface(path: str | Path, mode: int, dimension: int,
                 include_baryon: bool) -> SurfaceData:
    """Read input/surface.dat in the format of ``mode`` (1, 2 or 3)."""
    if mode not in (1, 2, 3):
        raise NotImplementedError(
            f"surface mode {mode} is not ported yet (ROADMAP A2b)")
    cols = load_table_fast(path)
    if mode == 1:
        s = _read_cpu_vh(cols, mode, include_baryon)
    elif mode == 2:
        s = _read_vah_pl_match(cols)
    else:
        s = _read_vah_plpt_match(cols, include_baryon, include_baryon)
    if dimension == 2:
        _enforce_boost_invariance(s)
    return s
