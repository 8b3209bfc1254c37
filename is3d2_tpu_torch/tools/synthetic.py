"""Synthetic working directories for op-1 and op-2 runs, built from a seed.

Writes everything ``python -m is3d2_tpu_torch <workdir>`` (and the JAX
package's CLI) reads, with no data files from outside the repository:

  PDG/pdg_box.dat, PDG/chosen_particles.dat   smash-box hadron list
  tables/gauss/gla_roots_weights.txt          generalized Gauss-Laguerre
  tables/gauss/gauss_legendre.dat
  tables/momentum/{pT,phi,y}_table.dat
  tables/spacetime_rapidity/eta_table.dat
  deltaf_coefficients/vh/smash_box/*.dat      from generate_deltaf_tables
  input/surface.dat                           mode-1 surface (or mode
                                              0, 2-7)
  iS3D_parameters.dat

``make_surface`` and ``write_mode1`` are copies of tests/surfgen.py, so the
same seed gives the same surface bit for bit; ``make_eos_consistent`` is
the torch counterpart of its helper of that name (the HRG (E, P) at each
cell's T, so that a df-5 run can reconstruct (E, p_L, p_T)).
``write_mode2`` / ``write_mode3`` write the legacy VAH formats the port
reads for df 5; ``write_mode0`` (legacy GPU VH), ``write_mode4`` (old
MUSIC), ``write_mode6`` (public MUSIC, a copy of tests/surfgen.py's) and
``write_mode7`` (HIC-EventGen) the other formats, each in the column map
of its reader (io/surface.py).  ``dan_scale`` gives a 2+1d surface a
dsigma_eta, which mode 6 keeps (mode 4 zeroes it, modes 1 and 0 keep it,
mode 7 has none).

Run as ``python -m is3d2_tpu_torch.tools.synthetic <workdir> [--cells N]
[--operation 0|1|2] [--df-mode 1-5] [--compute-dtype f32c|f32|f64]
[--use-pallas -1|0|1] [--shear-scale X] [--bulk-scale X]
[--test-sampler 1|0] [--surface-mode 0-7] [--dan-scale X]
[--group-particles 0|1]``.  ``--compute-dtype f64 --use-pallas 1``
selects kernel B2 for df 1/2.  The feqmod breakdown branch (df 3/4) needs
viscous corrections well above the defaults: ``--shear-scale 0.2
--bulk-scale 0.1`` sends a few percent of the cells there.  ``--df-mode 5``
writes an EOS-consistent surface.  ``--surface-mode 5`` writes mode 1 with
the thermal vorticity (``write_mode1(vorticity=True)``), and the run adds
the spin polarization (results/{St,Sx,Sy,Sn}.dat).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
from scipy.special import roots_genlaguerre

from ..constants import hbarC, two_pi2_hbarC3
from ..io.pdg import decode_mcid
from ..io.surface import SurfaceData
from ..physics import thermal
from .generate_deltaf_tables import compute_tables
from .generate_deltaf_tables import write_tables as write_df_tables


def make_surface(n_cells: int, seed: int = 0, dimension: int = 2,
                 include_baryon: bool = False, vorticity: bool = False,
                 shear_scale: float = 0.02, bulk_scale: float = 0.01,
                 flow_scale: float = 1.0) -> SurfaceData:
    rng = np.random.default_rng(seed)
    s = SurfaceData.zeros(n_cells)
    s.tau = rng.uniform(1.0, 10.0, n_cells)
    s.x = rng.uniform(-10.0, 10.0, n_cells)
    s.y = rng.uniform(-10.0, 10.0, n_cells)
    s.eta = np.zeros(n_cells) if dimension == 2 else rng.uniform(-2.0, 2.0, n_cells)

    # surface normal: mostly timelike with some spatial tilt
    s.dat = rng.uniform(0.05, 0.4, n_cells)
    s.dax = rng.uniform(-0.1, 0.1, n_cells)
    s.day = rng.uniform(-0.1, 0.1, n_cells)
    s.dan = np.zeros(n_cells) if dimension == 2 else rng.uniform(-0.02, 0.02, n_cells)

    s.ux = rng.uniform(-1.0, 1.0, n_cells) * flow_scale
    s.uy = rng.uniform(-1.0, 1.0, n_cells) * flow_scale
    s.un = np.zeros(n_cells) if dimension == 2 else rng.uniform(-0.05, 0.05, n_cells)

    s.T = rng.uniform(0.145, 0.165, n_cells)     # GeV, inside table range
    s.E = rng.uniform(0.22, 0.36, n_cells)       # GeV/fm^3
    s.P = rng.uniform(0.07, 0.11, n_cells)

    scale = shear_scale * (s.E + s.P)
    s.pixx = rng.uniform(-1.0, 1.0, n_cells) * scale
    s.pixy = rng.uniform(-1.0, 1.0, n_cells) * scale
    s.piyy = rng.uniform(-1.0, 1.0, n_cells) * scale
    if dimension == 3:
        s.pixn = rng.uniform(-1.0, 1.0, n_cells) * scale * 0.1
        s.piyn = rng.uniform(-1.0, 1.0, n_cells) * scale * 0.1

    s.bulkPi = rng.uniform(-1.0, 1.0, n_cells) * bulk_scale * (s.E + s.P)

    if include_baryon:
        s.muB = rng.uniform(0.0, 0.2, n_cells)
        s.nB = rng.uniform(0.0, 0.1, n_cells)
        s.Vx = rng.uniform(-0.01, 0.01, n_cells)
        s.Vy = rng.uniform(-0.01, 0.01, n_cells)
        s.Vn = np.zeros(n_cells) if dimension == 2 else rng.uniform(-0.002, 0.002, n_cells)

    if vorticity:
        for f in ("wtx", "wty", "wtn", "wxy", "wxn", "wyn"):
            setattr(s, f, rng.uniform(-0.05, 0.05, n_cells))
    return s


def add_dsigma_eta(s: SurfaceData, seed: int, scale: float) -> SurfaceData:
    """Give a 2+1d surface a dsigma_eta: dsigma_eta / tau uniform in
    [-scale, scale], drawn from its own stream of ``seed`` (the other
    fields keep make_surface's bits)."""
    rng = np.random.default_rng([seed, 1])
    s.dan = s.tau * rng.uniform(-scale, scale, s.n_cells)
    return s


def write_mode1(s: SurfaceData, path: str | Path, include_baryon: bool = False,
                vorticity: bool = False) -> None:
    """Write in mode-1/5 CPU-VH format (raw hbar=1 units, one row per cell)."""
    cols = [s.tau, s.x, s.y, s.eta, s.dat, s.dax, s.day, s.dan,
            s.ux, s.uy, s.un,
            s.E / hbarC, s.T / hbarC, s.P / hbarC,
            s.pixx / hbarC, s.pixy / hbarC, s.pixn / hbarC,
            s.piyy / hbarC, s.piyn / hbarC, s.bulkPi / hbarC]
    if include_baryon:
        cols += [s.muB / hbarC, s.nB, s.Vx, s.Vy, s.Vn]
    if vorticity:
        cols += [s.wtx, s.wty, s.wtn, s.wxy, s.wxn, s.wyn]
    arr = np.column_stack(cols)
    np.savetxt(path, arr, fmt="%.16e")


def make_eos_consistent(s: SurfaceData, species_table, laguerre,
                        device="cpu", block: int = 4096) -> SurfaceData:
    """Overwrite (E, P) with the HRG equilibrium values at each cell's T
    (every massive species of the table), so that the VAH solver can
    reconstruct (E, p_L, p_T).  f64 on ``device``, ``block`` cells at a
    time (one (cells x species x 32) block is ~50 MB)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    mask = species_table.mass > 0
    m_sp = t(species_table.mass[mask])
    g = t(species_table.gspin[mask])[None, :]
    sgn = t(species_table.sign[mask])[None, :]
    r2, w2 = laguerre.roots[2], laguerre.weights[2]
    E_out, P_out = [], []
    for i in range(0, s.T.shape[0], block):
        T = t(s.T[i:i + block])
        mbar = m_sp[None, :] / T[:, None]
        zero = torch.zeros_like(mbar)
        E_int = thermal.E_mod_integral(r2, w2, mbar, zero, sgn)
        P_int = thermal.P_mod_integral(r2, w2, mbar, zero, sgn)
        fact = T ** 4 / two_pi2_hbarC3
        E_out.append((fact * (g * E_int).sum(dim=1)).cpu().numpy())
        P_out.append((fact * (g * P_int).sum(dim=1)).cpu().numpy())
    s.E = np.concatenate(E_out)
    s.P = np.concatenate(P_out) / 3.0
    return s


def _u_t(s: SurfaceData) -> np.ndarray:
    return np.sqrt(1.0 + s.ux**2 + s.uy**2 + (s.tau * s.un) ** 2)


def write_mode0(s: SurfaceData, path: str | Path,
                include_baryon: bool = False) -> None:
    """Write in the legacy GPU-VH format (mode 0, readindata.cu:147-318):
    x^mu, dsigma_mu, u^mu with u^t, E, T, P, the ten pi^munu (the
    dependent ones zero: the reader recomputes them), bulkPi in raw hbar=1
    units, then muB and nB, V^mu with baryons."""
    z = np.zeros(s.n_cells)
    cols = [s.tau, s.x, s.y, s.eta, s.dat, s.dax, s.day, s.dan,
            _u_t(s), s.ux, s.uy, s.un, s.E / hbarC, s.T / hbarC, s.P / hbarC,
            z, z, z, z, s.pixx / hbarC, s.pixy / hbarC, s.pixn / hbarC,
            s.piyy / hbarC, s.piyn / hbarC, z, s.bulkPi / hbarC]
    if include_baryon:
        cols += [s.muB / hbarC, s.nB, z, s.Vx, s.Vy, s.Vn]
    np.savetxt(path, np.column_stack(cols), fmt="%.17g")


def write_mode4(s: SurfaceData, path: str | Path) -> None:
    """Write in the old (private) MUSIC format (mode 4,
    readindata.cu:551-686): dsigma_mu / tau, u^t ux uy tau.u^eta, E T muB
    and the entropy density s = (E + P) / T, the ten pi^munu with the eta
    components tau-scaled, bulkPi, in raw hbar=1 units."""
    tau = s.tau
    z = np.zeros(s.n_cells)
    cols = [tau, s.x, s.y, s.eta,
            s.dat / tau, s.dax / tau, s.day / tau, s.dan / tau,
            _u_t(s), s.ux, s.uy, s.un * tau,
            s.E / hbarC, s.T / hbarC, s.muB / hbarC, (s.E + s.P) / s.T,
            z, z, z, z, s.pixx / hbarC, s.pixy / hbarC, s.pixn * tau / hbarC,
            s.piyy / hbarC, s.piyn * tau / hbarC, z, s.bulkPi / hbarC]
    np.savetxt(path, np.column_stack(cols), fmt="%.17g")


def write_mode6(s: SurfaceData, path: str | Path,
                include_baryon: bool = False) -> None:
    """Write in mode-6 public-MUSIC format (the production surface format:
    dsigma/tau columns, tau-scaled u^eta/pi^{x eta}/pi^{y eta}, E/T/muB in
    fm^-4/fm^-1; see io/surface.py:_read_music and readindata.cpp:372-567)."""
    n = s.tau.shape[0]
    tau = s.tau
    z = np.zeros(n)
    ut = np.sqrt(1.0 + s.ux**2 + s.uy**2 + (tau * s.un) ** 2)
    cols = [tau, s.x, s.y, s.eta,
            s.dat / tau, s.dax / tau, s.day / tau, s.dan / tau,
            ut, s.ux, s.uy, s.un * tau,
            s.E / hbarC, s.T / hbarC, s.muB / hbarC, z, z,
            (s.E + s.P) / np.where(s.T != 0, s.T, 1.0),
            z, z, z, z,                      # pi^{tt,tx,ty,tn}: recomputed
            s.pixx / hbarC, s.pixy / hbarC, s.pixn * tau / hbarC,
            s.piyy / hbarC, s.piyn * tau / hbarC, z,
            s.bulkPi / hbarC]
    if include_baryon:
        cols += [s.nB, z, s.Vx, s.Vy, s.Vn * tau]
    np.savetxt(path, np.column_stack(cols), fmt="%.10e")


def write_mode7(s: SurfaceData, path: str | Path) -> None:
    """Write in the HIC-EventGen format (mode 7, readindata.cpp:570-729):
    dsigma_mu / tau, the velocity (vx, vy, 0), the ten pi^munu, bulkPi, T,
    E, P and muB, all in GeV units; boost-invariant (u^eta = 0)."""
    tau = s.tau
    z = np.zeros(s.n_cells)
    ut = _u_t(s)
    cols = [tau, s.x, s.y, s.eta,
            s.dat / tau, s.dax / tau, s.day / tau, s.dan / tau,
            s.ux / ut, s.uy / ut, z,
            z, z, z, z, s.pixx, s.pixy, z, s.piyy, z, z,
            s.bulkPi, s.T, s.E, s.P, s.muB]
    np.savetxt(path, np.column_stack(cols), fmt="%.17g")


_WRITERS = {0: write_mode0, 1: write_mode1, 4: write_mode4, 6: write_mode6,
            7: write_mode7}


def _vah_head(s: SurfaceData) -> list:
    """The columns both legacy VAH formats start with, up to T."""
    return [s.tau, s.x, s.y, s.eta, s.dat, s.dax, s.day, s.dan,
            _u_t(s), s.ux, s.uy, s.un, s.E / hbarC, s.T / hbarC]


def _vah_shear_w(s: SurfaceData) -> list:
    """pi^munu (tt tx ty tn recomputed by the reader, nn too) and W^mu = 0."""
    z = np.zeros(s.n_cells)
    return [z, z, z, z, s.pixx / hbarC, s.pixy / hbarC, s.pixn / hbarC,
            s.piyy / hbarC, s.piyn / hbarC, z, z, z, z, z]


def write_mode2(s: SurfaceData, path: str | Path, pl=None) -> None:
    """Write in the legacy VAH P_L-matching format (mode 2,
    readindata.cu:812-930): ..., E, T, P, pl, pi^munu[10], W^mu[4], bulkPi
    in raw hbar=1 units; ``pl`` defaults to P."""
    pl = s.P if pl is None else pl
    cols = (_vah_head(s) + [s.P / hbarC, pl / hbarC] + _vah_shear_w(s)
            + [s.bulkPi / hbarC])
    np.savetxt(path, np.column_stack(cols), fmt="%.17g")


def write_mode3(s: SurfaceData, path: str | Path, lam, aT, aL, pl=None,
                pt=None) -> None:
    """Write in the legacy VAH (P_L, P_T)-matching format (mode 3,
    readindata.cu:932-1055): ..., e, T, pl, pt, pi^munu[10], W^mu[4],
    Lambda, aT, aL in raw hbar=1 units, no baryon columns; ``pl`` and ``pt``
    default to P.  The format has no bulkPi column."""
    pl = s.P if pl is None else pl
    pt = s.P if pt is None else pt
    cols = (_vah_head(s) + [pl / hbarC, pt / hbarC] + _vah_shear_w(s)
            + [np.asarray(lam) / hbarC, aT, aL])
    np.savetxt(path, np.column_stack(cols), fmt="%.17g")


def write_vah_surface(s: SurfaceData, path: str | Path, mode: int,
                      species_table, device="cpu") -> None:
    """Write ``s`` in VAH mode 2 or 3 with its LRF (pl, pt); mode 3 also
    carries (Lambda, aT, aL) from the port's reconstruction (f64 on
    ``device``)."""
    from ..config import Config
    from ..core.spectra_famod import famod_cells, lrf_pressures, prepare_famod
    cfg = Config(df_mode=5, cell_block=s.n_cells)   # no padding cells
    cells = famod_cells(s, cfg, device)
    n = s.n_cells

    def h(t):
        return t.cpu().numpy()[:n]

    _, _, pl, pt = lrf_pressures(cells)
    if mode == 2:
        write_mode2(s, path, h(pl))
        return
    fm = prepare_famod(cells, species_table, cfg)
    write_mode3(s, path, h(fm.lam), h(fm.aT), h(fm.aL), h(pl), h(pt))


# ground states and low resonances: (name, mass [GeV], parity, MC IDs);
# masses from the PDG tables
_HADRONS = (
    ("pi0", 0.1349768, "-", (111,)), ("pi", 0.13957039, "-", (211,)),
    ("K", 0.493677, "-", (321,)), ("K0", 0.497611, "-", (311,)),
    ("eta", 0.547862, "-", (221,)), ("rho", 0.77526, "-", (113, 213)),
    ("omega", 0.78266, "-", (223,)), ("K*", 0.89166, "-", (323,)),
    ("K*0", 0.89555, "-", (313,)), ("N", 0.938272, "+", (2212,)),
    ("N0", 0.939565, "+", (2112,)), ("eta'", 0.95778, "-", (331,)),
    ("phi", 1.019461, "-", (333,)), ("Lambda", 1.115683, "+", (3122,)),
    ("h1", 1.166, "+", (10223,)), ("Sigma", 1.18937, "+", (3222,)),
    ("Sigma0", 1.192642, "+", (3212,)), ("Sigma-", 1.197449, "+", (3112,)),
    ("b1", 1.2295, "+", (10113, 10213)), ("a1", 1.230, "+", (20113, 20213)),
    ("Delta", 1.232, "+", (2224, 2214, 2114, 1114)),
    ("K1", 1.253, "+", (10323, 10313)), ("f2", 1.2755, "+", (225,)),
    ("f1", 1.2819, "+", (20223,)), ("pi(1300)", 1.300, "-", (100111, 100211)),
    ("Xi0", 1.31486, "+", (3322,)), ("a2", 1.3182, "+", (115, 215)),
    ("Xi", 1.32171, "+", (3312,)), ("Sigma*", 1.3828, "+", (3224, 3214, 3114)),
    ("Lambda(1405)", 1.4051, "-", (13122,)), ("N(1440)", 1.440, "+", (12212, 12112)),
    ("rho(1450)", 1.465, "-", (100113, 100213)), ("f2'", 1.5174, "+", (335,)),
    ("Lambda(1520)", 1.5195, "-", (3124,)), ("Xi*", 1.5318, "+", (3324, 3314)),
    ("Omega", 1.67245, "+", (3334,)), ("rho3", 1.6888, "-", (117, 217)),
    ("phi3", 1.854, "-", (337,)), ("a4", 1.995, "+", (119, 219)),
    ("f4", 2.018, "+", (229,)),
)


def pdg_box_lines(n_species: int = 370, mass_max: float = 2.5) -> list[str]:
    """Smash-box lines ``name mass width parity id...`` for a hadron list of
    at least ``n_species`` species counting antiparticles: the table above,
    then radial excitations of it (MC ID + k*10^6, mass + 0.2 k GeV, up to
    ``mass_max``) until the count is reached."""
    def count(ids):
        return sum(2 if decode_mcid(i)["has_antiparticle"] else 1 for i in ids)

    lines, total = [], 0
    for name, mass, parity, ids in _HADRONS:
        lines.append(f"{name} {mass:.6f} 0.0 {parity} " + " ".join(map(str, ids)))
        total += count(ids)
    for k in range(1, 10):
        for name, mass, parity, ids in _HADRONS:
            if total >= n_species:
                return lines
            m = mass + 0.2 * k
            if m > mass_max:
                continue
            ids_k = [i + k * 10**6 for i in ids]
            lines.append(f"{name}_x{k} {m:.6f} 0.1 {parity} "
                         + " ".join(map(str, ids_k)))
            total += count(ids_k)
    return lines


def _gauss_legendre(n: int, lo: float, hi: float):
    # leggauss returns exactly antisymmetric nodes; mid + half * x keeps
    # them so when mid == 0, which the eta fold gate needs
    x, w = np.polynomial.legendre.leggauss(n)
    half = 0.5 * (hi - lo)
    return 0.5 * (lo + hi) + half * x, half * w


def write_quadrature_tables(root: Path, n_pT: int, n_phi: int, n_eta: int,
                            pT_max: float = 3.0, eta_max: float = 4.0) -> None:
    """Quadrature and momentum tables.  The pT weights carry the pT of
    pT dpT, so sum(w_pT w_phi spectra) is dN/dy."""
    t = root / "tables"
    for sub in ("gauss", "momentum", "spacetime_rapidity", "thermodynamic"):
        (t / sub).mkdir(parents=True, exist_ok=True)

    n_alpha, n_lag = 21, 32
    with open(t / "gauss/gla_roots_weights.txt", "w") as fh:
        fh.write(f"{n_alpha} {n_lag}\n")
        for a in range(n_alpha):
            r, w = roots_genlaguerre(n_lag, a)
            for ri, wi in zip(r, w):
                fh.write(f"{a} {ri:.16e} {wi:.16e}\n")
    x, w = np.polynomial.legendre.leggauss(48)
    with open(t / "gauss/gauss_legendre.dat", "w") as fh:
        fh.write("48\n")
        np.savetxt(fh, np.column_stack([x, w]), fmt="%.16e")

    pT, wp = _gauss_legendre(n_pT, 0.0, pT_max)
    np.savetxt(t / "momentum/pT_table.dat", np.column_stack([pT, wp * pT]),
               fmt="%.16e")
    phi, wphi = _gauss_legendre(n_phi, 0.0, 2.0 * np.pi)
    np.savetxt(t / "momentum/phi_table.dat", np.column_stack([phi, wphi]),
               fmt="%.16e")
    np.savetxt(t / "momentum/y_table.dat", np.array([[0.0, 1.0]]), fmt="%.16e")
    eta, weta = _gauss_legendre(n_eta, -eta_max, eta_max)
    np.savetxt(t / "spacetime_rapidity/eta_table.dat",
               np.column_stack([eta, weta]), fmt="%.16e")


def write_workdir(root: str | Path, n_cells: int = 512, seed: int = 3,
                  chosen_mcids=None, n_species: int = 370,
                  n_pT: int = 51, n_phi: int = 48, n_eta: int = 24,
                  params: dict | None = None, include_baryon: bool = False,
                  shear_scale: float = 0.02, bulk_scale: float = 0.01,
                  n_T: int = 101, n_muB: int | None = None,
                  eos_consistent: bool = False, surface_mode: int = 1,
                  dan_scale: float = 0.0, device="cpu") -> Path:
    """Write a complete working directory; returns its path.

    ``chosen_mcids`` defaults to every species of the list.  ``params``
    overrides entries of iS3D_parameters.dat (op 1, df 1, f32c by default;
    ``{"operation": 2}`` makes it a sampler run, which reads the same
    files).
    The delta-f tables span T = 0.1..0.2 GeV in ``n_T`` points and, with
    baryons, muB = 0..0.8 GeV in ``n_muB`` points (one point without).
    ``eos_consistent`` replaces (E, P) by the HRG values (make_eos_consistent
    on ``device``), as a df-5 run needs.  ``surface_mode`` picks the
    surface file's format and sets ``mode`` in the parameters: 1 (default),
    5 (mode 1 with the thermal vorticity, drawn after every other field of
    make_surface, so those keep mode 1's bits; the run adds the spin
    polarization), 0, 4, 6 or 7 (modes 4 and 7 carry no baryon columns but
    muB), or 2 or 3,
    a legacy VAH surface (write_vah_surface; mode 3 reconstructs on
    ``device``).  ``dan_scale`` draws dsigma_eta / tau uniform in
    [-dan_scale, dan_scale] (from the seed, after every other field) for a
    2+1d surface whose p.dsigma has a dan term."""
    from ..io.pdg import SpeciesTable, read_pdg_smash_box
    from ..io.tables import GaussLaguerre

    root = Path(root)
    (root / "PDG").mkdir(parents=True, exist_ok=True)
    (root / "input").mkdir(exist_ok=True)
    (root / "PDG/pdg_box.dat").write_text("\n".join(pdg_box_lines(n_species)) + "\n")
    species = SpeciesTable.from_species(read_pdg_smash_box(root / "PDG/pdg_box.dat"))
    if chosen_mcids is None:
        chosen_mcids = species.mc_id.tolist()
    (root / "PDG/chosen_particles.dat").write_text(
        "\n".join(str(int(m)) for m in chosen_mcids) + "\n")

    write_quadrature_tables(root, n_pT, n_phi, n_eta)
    if n_muB is None:
        n_muB = 81 if include_baryon else 1
    write_df_tables(compute_tables(species, n_T=n_T, n_muB=n_muB),
                    root / "deltaf_coefficients/vh/smash_box")

    vorticity = surface_mode == 5
    surf = make_surface(n_cells, seed=seed, include_baryon=include_baryon,
                        shear_scale=shear_scale, bulk_scale=bulk_scale,
                        vorticity=vorticity)
    if dan_scale:
        add_dsigma_eta(surf, seed, dan_scale)
    if eos_consistent:
        make_eos_consistent(surf, species, GaussLaguerre.from_file(
            root / "tables/gauss/gla_roots_weights.txt"), device)
    if surface_mode == 5:
        write_mode1(surf, root / "input/surface.dat",
                    include_baryon=include_baryon, vorticity=True)
    elif surface_mode in (0, 1, 6):
        _WRITERS[surface_mode](surf, root / "input/surface.dat",
                               include_baryon=include_baryon)
    elif include_baryon:
        raise ValueError(f"the mode-{surface_mode} writer takes no baryon "
                         "columns")
    elif surface_mode in (4, 7):
        _WRITERS[surface_mode](surf, root / "input/surface.dat")
    else:
        write_vah_surface(surf, root / "input/surface.dat", surface_mode,
                          species, device)

    p = {"operation": 1, "mode": surface_mode, "hrg_eos": 3, "dimension": 2,
         "df_mode": 1, "include_baryon": int(include_baryon),
         "include_bulk_deltaf": 1, "include_shear_deltaf": 1,
         "include_baryondiff_deltaf": int(include_baryon),
         "regulate_deltaf": 0, "outflow": 0, "compute_dtype": "f32c"}
    p.update(params or {})
    (root / "iS3D_parameters.dat").write_text(
        "".join(f"{k} = {v}\n" for k, v in p.items()))
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="write a synthetic workdir")
    ap.add_argument("workdir")
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--operation", type=int, default=1, choices=(0, 1, 2))
    ap.add_argument("--df-mode", type=int, default=1,
                    choices=(1, 2, 3, 4, 5))
    ap.add_argument("--compute-dtype", default="f32c",
                    choices=("f32c", "f32", "f64"))
    ap.add_argument("--use-pallas", type=int, default=-1, choices=(-1, 0, 1),
                    help="the kernels: -1 auto, 1 on, 0 off (default -1)")
    ap.add_argument("--shear-scale", type=float, default=0.02,
                    help="shear stress in units of E + P (default 0.02)")
    ap.add_argument("--bulk-scale", type=float, default=0.01,
                    help="bulk pressure in units of E + P (default 0.01)")
    ap.add_argument("--test-sampler", type=int, default=1, choices=(0, 1),
                    help="operation 2: 1 = test histograms, 0 = OSCAR "
                         "event files (default 1)")
    ap.add_argument("--surface-mode", type=int, default=1,
                    choices=(0, 1, 2, 3, 4, 5, 6, 7),
                    help="format of input/surface.dat (default 1; 5 adds "
                         "the thermal vorticity and the polarization)")
    ap.add_argument("--dan-scale", type=float, default=0.0,
                    help="dsigma_eta / tau drawn in [-X, X] (default 0)")
    ap.add_argument("--group-particles", type=int, default=0, choices=(0, 1),
                    help="1 = species of near-equal mass share one spectra "
                         "evaluation (default 0)")
    args = ap.parse_args(argv)
    write_workdir(args.workdir, n_cells=args.cells, seed=args.seed,
                  params={"operation": args.operation,
                          "test_sampler": args.test_sampler,
                          "df_mode": args.df_mode,
                          "compute_dtype": args.compute_dtype,
                          "use_pallas": args.use_pallas,
                          "group_particles": args.group_particles},
                  shear_scale=args.shear_scale, bulk_scale=args.bulk_scale,
                  eos_consistent=args.df_mode == 5,
                  surface_mode=args.surface_mode, dan_scale=args.dan_scale)
    print(f"wrote {args.workdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
