"""Freezeout-surface readers (modes 0-7) and the in-memory surface.

Counterpart of is3d2_tpu/io/surface.py, which replaces the reference's
FO_data_reader (src/cpp/readindata.cpp:122-729).  The reader produces a
:class:`SurfaceData` struct-of-arrays (numpy f64, one entry per freezeout
cell) in iS3D's internal units:

  tau,x,y [fm]; eta [1]; dsigma_mu: dat,dax [fm^-2] ... ; u^mu [1, fm^-1];
  E,P [GeV/fm^3]; T [GeV]; pi^munu [GeV/fm^3(4)]; bulkPi [GeV/fm^3];
  muB [GeV]; nB [fm^-3]; V^mu [fm^-3(4)].

Ported formats (``mode``), read with the threaded native parser
(io/fastio.py):
  0 : legacy GPU-VH with a u^t column and the full pi tensor
      (readindata.cu:147-318)
  1 : CPU VH, raw hbar=1 units (readindata.cpp:167-367)
  5 : mode 1 plus the six thermal-vorticity columns wtx wty wtn wxy wxn
      wyn, for the spin polarization (readindata.cpp:167-367)
  2 : legacy VAH P_L-matching, with (Lambda, a_L) inferred from the
      conformal factorization fit (readindata.cu:812-930)
  3 : legacy VAH (P_L, P_T)-matching with explicit (Lambda, a_T, a_L)
      columns (readindata.cu:932-1055)
  4 : MUSIC old (private), boost-invariant: tau-scaled dsigma/u/pi
      columns, P from the entropy column, P = s T - E; dsigma_eta is
      zeroed in 2+1d (readindata.cu:551-686)
  6 : MUSIC public, tau-scaled columns, P from the (E + P)/T column
      (readindata.cpp:372-567); dsigma_eta is kept in 2+1d
  7 : HIC-EventGen, 2+1d velocity columns in GeV units
      (readindata.cpp:570-729)
Modes 2/3 fill the optional VAH fields (PL, PT, W^mu, Lambda, aT, aL,
upsilonB), which the df-5 famod prep uses instead of reconstructing the
anisotropic variables.  ``surface_from_memory`` is the JETSCAPE-style surface
handed over in memory (iS3D.cpp:33-78).
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


def _read_vh_old(cols: np.ndarray, include_baryon: bool,
                 include_baryondiff: bool) -> SurfaceData:
    """Legacy GPU-VH format (readindata.cu:147-318): explicit u^t column and
    the full 10-component shear tensor, of which the 5 independent
    components are kept (the engines complete the rest from orthogonality
    and tracelessness)."""
    n = cols.shape[0]
    s = SurfaceData.zeros(n)
    s.tau, s.x, s.y, s.eta = cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3]
    s.dat, s.dax, s.day, s.dan = cols[:, 4], cols[:, 5], cols[:, 6], cols[:, 7]
    # col 8 is u^t (recomputed from the normalization)
    s.ux, s.uy, s.un = cols[:, 9], cols[:, 10], cols[:, 11]
    s.E = cols[:, 12] * hbarC
    s.T = cols[:, 13] * hbarC
    s.P = cols[:, 14] * hbarC
    # full pi tensor: pitt pitx pity pitn pixx pixy pixn piyy piyn pinn
    s.pixx = cols[:, 19] * hbarC
    s.pixy = cols[:, 20] * hbarC
    s.pixn = cols[:, 21] * hbarC
    s.piyy = cols[:, 22] * hbarC
    s.piyn = cols[:, 23] * hbarC
    s.bulkPi = cols[:, 25] * hbarC
    c = 26
    if include_baryon:
        s.muB = cols[:, c] * hbarC
        c += 1
    if include_baryondiff:
        s.nB = cols[:, c]
        s.Vx = cols[:, c + 2]
        s.Vy = cols[:, c + 3]
        s.Vn = cols[:, c + 4]
    return s


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


def _read_music_old(cols: np.ndarray, dimension: int) -> SurfaceData:
    """Old (private) MUSIC boost-invariant format (readindata.cu:551-686):
    [tau x y eta | dsigma_mu/tau (4) | u^t ux uy tau.u^eta | E T muB s |
    pi^munu (10, tau-scaled *n components) | bulkPi], raw hbar=1 units.
    P is rebuilt from the entropy column as P = s T - E."""
    n = cols.shape[0]
    s = SurfaceData.zeros(n)
    tau = cols[:, 0]
    s.tau, s.x, s.y, s.eta = tau, cols[:, 1], cols[:, 2], cols[:, 3]
    # covariant normal vector: cornelius writes dsigma_mu / tau
    s.dat = cols[:, 4] * tau
    s.dax = cols[:, 5] * tau
    s.day = cols[:, 6] * tau
    s.dan = cols[:, 7] * tau
    if dimension == 2:
        # the reference zeroes dsigma_eta on boost-invariant surfaces
        # (readindata.cu:588-593)
        s.dan = np.zeros(n)
    # col 8 is u^t (recomputed from the normalization)
    s.ux, s.uy = cols[:, 9], cols[:, 10]
    s.un = cols[:, 11] / tau
    s.E = cols[:, 12] * hbarC
    T = cols[:, 13] * hbarC
    s.T = T
    s.muB = cols[:, 14] * hbarC
    s.P = cols[:, 15] * T - s.E        # P = s T - E (readindata.cu:615-616)
    # pi^tt tx ty tau.tn  xx xy tau.xn  yy tau.yn  tau2.nn (16..25)
    s.pixx = cols[:, 20] * hbarC
    s.pixy = cols[:, 21] * hbarC
    s.pixn = cols[:, 22] * hbarC / tau
    s.piyy = cols[:, 23] * hbarC
    s.piyn = cols[:, 24] * hbarC / tau
    s.bulkPi = cols[:, 26] * hbarC
    return s


def _read_music(cols: np.ndarray, include_baryon: bool) -> SurfaceData:
    """Public MUSIC format (readindata.cpp:372-567): [tau x y eta |
    dsigma_mu/tau (4) | u^t ux uy tau.u^eta | E T muB muS muC (E+P)/T |
    pi^munu (10, tau-scaled *n components) | bulkPi | nB, V^mu (4)],
    raw hbar=1 units.  P is rebuilt from the enthalpy column."""
    n = cols.shape[0]
    s = SurfaceData.zeros(n)
    tau = cols[:, 0]
    s.tau, s.x, s.y, s.eta = tau, cols[:, 1], cols[:, 2], cols[:, 3]
    # dsigma_mu / tau columns -> multiply by tau
    s.dat = cols[:, 4] * tau
    s.dax = cols[:, 5] * tau
    s.day = cols[:, 6] * tau
    s.dan = cols[:, 7] * tau
    # u^t ux uy tau.u^eta
    s.ux, s.uy = cols[:, 9], cols[:, 10]
    s.un = cols[:, 11] / tau
    s.E = cols[:, 12] * hbarC
    T = cols[:, 13] * hbarC
    s.T = T
    s.muB = cols[:, 14] * hbarC
    # cols 15, 16 = muS, muC (unused); col 17 = (E+P)/T [fm^-3]
    s.P = cols[:, 17] * T - s.E
    # pi^tt tx ty tau.tn  xx xy tau.xn  yy tau.yn  tau2.nn
    s.pixx = cols[:, 22] * hbarC
    s.pixy = cols[:, 23] * hbarC
    s.pixn = cols[:, 24] * hbarC / tau
    s.piyy = cols[:, 25] * hbarC
    s.piyn = cols[:, 26] * hbarC / tau
    s.bulkPi = cols[:, 28] * hbarC
    if include_baryon:
        s.nB = cols[:, 29]
        s.Vx = cols[:, 31]
        s.Vy = cols[:, 32]
        s.Vn = cols[:, 33] / tau
    return s


def _read_hic_eventgen(cols: np.ndarray) -> SurfaceData:
    """HIC-EventGen format (readindata.cpp:570-729): [tau x y eta |
    dsigma_mu/tau (4) | vx vy (col 10 unused) | pi^munu (10) | bulkPi T E P
    muB], boost-invariant, already in GeV units; u^mu from the velocity."""
    n = cols.shape[0]
    s = SurfaceData.zeros(n)
    tau = cols[:, 0]
    s.tau, s.x, s.y = tau, cols[:, 1], cols[:, 2]
    s.eta = np.zeros(n)
    s.dat = cols[:, 4] * tau
    s.dax = cols[:, 5] * tau
    s.day = cols[:, 6] * tau
    s.dan = np.zeros(n)
    vx, vy = cols[:, 8], cols[:, 9]
    ut = 1.0 / np.sqrt(np.abs(1.0 - vx**2 - vy**2))
    s.ux = ut * vx
    s.uy = ut * vy
    s.un = np.zeros(n)
    # shear columns 11..20 = pi^tt tx ty tau.tn xx xy tau.xn yy tau.yn
    # tau2.nn [GeV/fm^3]
    s.pixx = cols[:, 15]
    s.pixy = cols[:, 16]
    s.pixn = np.zeros(n)
    s.piyy = cols[:, 18]
    s.piyn = np.zeros(n)
    s.bulkPi = cols[:, 21]
    s.T = cols[:, 22]
    s.E = cols[:, 23]
    s.P = cols[:, 24]
    s.muB = cols[:, 25]
    return s


def read_surface(path: str | Path, mode: int, dimension: int,
                 include_baryon: bool) -> SurfaceData:
    """Read input/surface.dat in the format of ``mode`` (0-7)."""
    if mode not in (0, 1, 2, 3, 4, 5, 6, 7):
        raise ValueError(f"unknown surface mode {mode} (supported: 0-7)")
    if mode == 7:
        if dimension != 2:
            raise ValueError("HIC-EventGen surfaces are boost-invariant "
                             "(dimension must be 2)")
        if include_baryon:
            raise ValueError("HIC-EventGen has no baryon chemical potential "
                             "(set include_baryon = 0)")
    cols = load_table_fast(path)
    if mode == 0:
        s = _read_vh_old(cols, include_baryon, include_baryon)
    elif mode in (1, 5):
        s = _read_cpu_vh(cols, mode, include_baryon)
    elif mode == 2:
        s = _read_vah_pl_match(cols)
    elif mode == 3:
        s = _read_vah_plpt_match(cols, include_baryon, include_baryon)
    elif mode == 4:
        s = _read_music_old(cols, dimension)
    elif mode == 6:
        s = _read_music(cols, include_baryon)
    else:
        s = _read_hic_eventgen(cols)
    if dimension == 2:
        _enforce_boost_invariance(s)
    return s


def surface_from_memory(tau, x, y, eta, dsigma_tau, dsigma_x, dsigma_y,
                        dsigma_eta, E, T, P, ux, uy, un, pixx, pixy, pixn,
                        piyy, piyn, pinn, Pi) -> SurfaceData:
    """JETSCAPE-style in-memory surface (iS3D.cpp:33-78).

    The inputs are already in iS3D units (GeV, fm); pinn is accepted but
    completed from orthogonality and tracelessness like the other
    dependent components, as the reference does ("pinn is extraneous",
    iS3D.cpp:76)."""
    s = SurfaceData.zeros(len(tau))

    def f64(a):
        return np.asarray(a, dtype=np.float64)

    s.tau, s.x, s.y, s.eta = f64(tau), f64(x), f64(y), f64(eta)
    s.dat, s.dax = f64(dsigma_tau), f64(dsigma_x)
    s.day, s.dan = f64(dsigma_y), f64(dsigma_eta)
    s.E, s.T, s.P = f64(E), f64(T), f64(P)
    s.ux, s.uy, s.un = f64(ux), f64(uy), f64(un)
    s.pixx, s.pixy, s.pixn = f64(pixx), f64(pixy), f64(pixn)
    s.piyy, s.piyn = f64(piyy), f64(piyn)
    s.bulkPi = f64(Pi)
    return s
