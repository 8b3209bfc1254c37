"""The benchmark's inputs, made from the seed: surfaces, the hadron list,
the quadrature tables and the delta-f coefficient tables.

Frozen copies of the port's synthetic-workdir builder
(``is3d2_tpu_torch/tools/synthetic.py``: ``make_surface``,
``make_eos_consistent``, ``pdg_box_lines``, the quadrature tables) and
of its delta-f table generator
(``is3d2_tpu_torch/tools/generate_deltaf_tables.py``: ``compute_tables``,
``write_tables``), so that a later change to those tools cannot move the
yardstick.  The same seed gives the same bits as
the originals (``tests/test_portbench_inputs.py``).  Nothing here imports
the port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from scipy.special import roots_genlaguerre

HBARC = 0.197327053  # GeV fm
TWO_PI2_HBARC3 = 2.0 * np.pi ** 2 * HBARC ** 3

# the surface fields make_surface fills (the rest of a surface is zero)
SURFACE_FIELDS = ("tau", "x", "y", "eta", "dat", "dax", "day", "dan",
                  "ux", "uy", "un", "T", "E", "P", "pixx", "pixy", "pixn",
                  "piyy", "piyn", "bulkPi")


def make_surface(n_cells: int, seed, dimension: int = 2,
                 shear_scale: float = 0.02, bulk_scale: float = 0.01,
                 flow_scale: float = 1.0) -> dict:
    """A freezeout surface of ``n_cells`` independent cells, as a dict of
    f64 arrays keyed by SURFACE_FIELDS; the draws of make_surface (no
    baryons, no vorticity) in its order."""
    rng = np.random.default_rng(seed)
    s = {f: np.zeros(n_cells) for f in SURFACE_FIELDS}
    s["tau"] = rng.uniform(1.0, 10.0, n_cells)
    s["x"] = rng.uniform(-10.0, 10.0, n_cells)
    s["y"] = rng.uniform(-10.0, 10.0, n_cells)
    s["eta"] = (np.zeros(n_cells) if dimension == 2
                else rng.uniform(-2.0, 2.0, n_cells))
    s["dat"] = rng.uniform(0.05, 0.4, n_cells)
    s["dax"] = rng.uniform(-0.1, 0.1, n_cells)
    s["day"] = rng.uniform(-0.1, 0.1, n_cells)
    s["dan"] = (np.zeros(n_cells) if dimension == 2
                else rng.uniform(-0.02, 0.02, n_cells))
    s["ux"] = rng.uniform(-1.0, 1.0, n_cells) * flow_scale
    s["uy"] = rng.uniform(-1.0, 1.0, n_cells) * flow_scale
    s["un"] = (np.zeros(n_cells) if dimension == 2
               else rng.uniform(-0.05, 0.05, n_cells))
    s["T"] = rng.uniform(0.145, 0.165, n_cells)
    s["E"] = rng.uniform(0.22, 0.36, n_cells)
    s["P"] = rng.uniform(0.07, 0.11, n_cells)
    scale = shear_scale * (s["E"] + s["P"])
    s["pixx"] = rng.uniform(-1.0, 1.0, n_cells) * scale
    s["pixy"] = rng.uniform(-1.0, 1.0, n_cells) * scale
    s["piyy"] = rng.uniform(-1.0, 1.0, n_cells) * scale
    if dimension == 3:
        s["pixn"] = rng.uniform(-1.0, 1.0, n_cells) * scale * 0.1
        s["piyn"] = rng.uniform(-1.0, 1.0, n_cells) * scale * 0.1
    s["bulkPi"] = rng.uniform(-1.0, 1.0, n_cells) * bulk_scale * (s["E"] + s["P"])
    return s


def _w1(p, t, sign):
    """exp(p) / (exp(t) + sign), overflow-safe (the port's thermal._w1)."""
    return torch.exp(p - t) / (1.0 + sign * torch.exp(-t))


def make_eos_consistent(s: dict, species: dict, device="cpu") -> dict:
    """Overwrite E and P of surface ``s`` with the equilibrium energy
    density and pressure of the hadron gas ``species`` (every species of
    mass > 0; species_of_lines) at each cell's T, in place: the a = 2
    Gauss-Laguerre integrals of the port's ``thermal.E_mod_integral`` and
    ``P_mod_integral`` at lambda = 0, summed over the species with their
    degeneracies.  Torch f64 on ``device``, 4,096 cells at a time; on the
    CPU the bits of the port's ``synthetic.make_eos_consistent``."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    mask = species["mass"] > 0
    m_sp = t(species["mass"][mask])
    g = t(species["gspin"][mask])[None, :]
    sign = t(species["sign"][mask])[None, :, None]
    # family a = 2 of the table write_quadrature_tables writes: its %.16e
    # (17 digits) reads back as these doubles
    p, w = (t(a) for a in roots_genlaguerre(32, 2))
    E_out, P_out = [], []
    for i in range(0, s["T"].shape[0], 4096):
        T = t(s["T"][i:i + 4096])
        mbar = (m_sp[None, :] / T[:, None])[..., None]
        Ebar = torch.sqrt(p * p + mbar * mbar)
        w1 = _w1(p, Ebar, sign)
        E_int = torch.sum(w * (Ebar * w1), dim=-1)
        P_int = torch.sum(w * (p * p / Ebar * w1), dim=-1)
        fact = T ** 4 / TWO_PI2_HBARC3
        E_out.append((fact * (g * E_int).sum(dim=1)).cpu().numpy())
        P_out.append((fact * (g * P_int).sum(dim=1)).cpu().numpy())
    s["E"] = np.concatenate(E_out)
    s["P"] = np.concatenate(P_out) / 3.0
    return s


def memory_fields(s: dict) -> dict:
    """The keyword arguments of the driver's in-memory surface
    (``IS3D.load_surface_from_memory``), in GeV and fm."""
    return dict(tau=s["tau"], x=s["x"], y=s["y"], eta=s["eta"],
                dsigma_tau=s["dat"], dsigma_x=s["dax"], dsigma_y=s["day"],
                dsigma_eta=s["dan"], E=s["E"], T=s["T"], P=s["P"],
                ux=s["ux"], uy=s["uy"], un=s["un"], pixx=s["pixx"],
                pixy=s["pixy"], pixn=s["pixn"], piyy=s["piyy"],
                piyn=s["piyn"], pinn=np.zeros_like(s["tau"]), Pi=s["bulkPi"])


def decode_mcid(mcid: int) -> dict:
    """Spin degeneracy, baryon number, statistics sign and whether an
    antiparticle exists, from a PDG Monte-Carlo ID (the reference's
    read_mcid, readindata.cpp:734-957)."""
    if mcid < 0:
        raise ValueError("decode_mcid expects particle IDs")
    digits = [(mcid // 10 ** i) % 10 for i in range(10)]
    nJ = digits[0] + digits[7]
    nq3, nq2, nq1 = digits[1], digits[2], digits[3]
    if mcid == 1000010020:
        return {"gspin": 3, "baryon": 2, "sign": -1, "has_antiparticle": True}
    if nq3 == 0 or nq2 == 0:
        raise ValueError(f"MC ID {mcid} is not a hadron or deuteron")
    baryon = 1 if nq1 != 0 else 0
    return {"gspin": nJ if nJ > 0 else 1, "baryon": baryon,
            "sign": 1 if baryon else -1,
            "has_antiparticle": baryon != 0 or nq2 != nq3}


# ground states and low resonances: (name, mass [GeV], parity, MC IDs)
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
    """Smash-box lines ``name mass width parity id...`` for a list of at
    least ``n_species`` species counting antiparticles: the table above,
    then radial excitations of it (MC ID + k 10^6, mass + 0.2 k GeV, up to
    ``mass_max``)."""
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
            ids_k = [i + k * 10 ** 6 for i in ids]
            lines.append(f"{name}_x{k} {m:.6f} 0.1 {parity} "
                         + " ".join(map(str, ids_k)))
            total += count(ids_k)
    return lines


def species_of_lines(lines: list[str]) -> dict:
    """The species of smash-box lines in file order (each particle, then
    its antiparticle): MC ID, mass, degeneracy, statistics sign and baryon
    number as arrays."""
    rows = []
    for line in lines:
        parts = line.split("#", 1)[0].split()
        if len(parts) < 5:
            continue
        mass = float(parts[1])
        for tok in parts[4:8]:
            mcid = int(tok)
            if mcid == 0:
                continue
            d = decode_mcid(mcid)
            rows.append((mcid, mass, d["gspin"], d["sign"], d["baryon"]))
            if d["has_antiparticle"]:
                rows.append((-mcid, mass, d["gspin"], d["sign"], -d["baryon"]))
    cols = list(zip(*rows))
    return {"mc_id": np.array(cols[0], dtype=np.int64),
            "mass": np.array(cols[1], dtype=np.float64),
            "gspin": np.array(cols[2], dtype=np.float64),
            "sign": np.array(cols[3], dtype=np.float64),
            "baryon": np.array(cols[4], dtype=np.float64)}


def _gauss_legendre(n: int, lo: float, hi: float):
    x, w = np.polynomial.legendre.leggauss(n)
    half = 0.5 * (hi - lo)
    return 0.5 * (lo + hi) + half * x, half * w


def y_table(n_y: int, y_max: float = 5.0) -> np.ndarray:
    """(y, weight) rows: y = 0 of weight 1 for one point, else the
    trapezoid rule on ``n_y`` equidistant points over |y| <= y_max."""
    if n_y == 1:
        return np.array([[0.0, 1.0]])
    y = np.linspace(-y_max, y_max, n_y)
    w = np.full(n_y, y[1] - y[0])
    w[[0, -1]] *= 0.5
    return np.column_stack([y, w])


def write_quadrature_tables(root: Path, n_pT: int, n_phi: int, n_eta: int,
                            pT_max: float = 3.0, eta_max: float = 4.0,
                            n_y: int = 1) -> None:
    """Gauss-Laguerre and Gauss-Legendre tables, and the pT, phi, y and eta
    tables (the pT weights carry the pT of pT dpT)."""
    t = Path(root) / "tables"
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
    np.savetxt(t / "momentum/y_table.dat", y_table(n_y), fmt="%.16e")
    eta, weta = _gauss_legendre(n_eta, -eta_max, eta_max)
    np.savetxt(t / "spacetime_rapidity/eta_table.dat",
               np.column_stack([eta, weta]), fmt="%.16e")


def compute_tables(species: dict, T_min=0.1, T_max=0.2, n_T=101,
                   muB_min=0.0, muB_max=0.8, n_muB=81) -> dict:
    """The Grad 14-moment (c0..c4) and Chapman-Enskog (F, G, betabulk,
    betaV, betapi) coefficient tables over a (T, muB) grid, as (n_muB, n_T)
    arrays with the temperature-power scaling of the shipped tables
    (deltaf_table.cpp:144-394), by 64-point Gauss-Laguerre HRG integrals.
    ``species`` holds the mass, gspin, baryon and sign arrays."""
    fams = {a: roots_genlaguerre(64, a) for a in (1, 2, 3, 4)}
    T = np.linspace(T_min, T_max, n_T)
    muB = np.linspace(muB_min, muB_max, n_muB)
    keep = species["mass"] > 0.0
    m = species["mass"][keep]
    g = species["gspin"][keep]
    b = species["baryon"][keep]
    th = species["sign"][keep]

    def gauss(a, integrand):
        p, w = fams[a]
        p4 = p[None, None, :]
        w_q = w[None, None, :]
        mbar = m[None, :, None] / T[:, None, None]
        Ebar = np.sqrt(p4 * p4 + mbar * mbar)
        out = np.empty((len(muB), len(T), len(m)))
        for iB in range(len(muB)):
            alpha = (b[None, :, None] * muB[iB] / T[:, None, None])
            val = integrand(p4, Ebar, alpha, b[None, :, None], th[None, :, None])
            out[iB] = (w_q * val).sum(axis=-1)
        return out

    def w1(p, Ebar, alpha, th):
        return np.exp(p) / (np.exp(Ebar - alpha) + th)

    def w2(p, Ebar, alpha, th):
        q = np.exp(Ebar - alpha) + th
        return np.exp(p + Ebar - alpha) / (q * q)

    I = {}
    I["J20"] = gauss(2, lambda p, E, a, bb, th: E * w2(p, E, a, th))
    I["J21"] = gauss(2, lambda p, E, a, bb, th: p * p / E * w2(p, E, a, th))
    I["J40"] = gauss(4, lambda p, E, a, bb, th: E**3 / (p * p) * w2(p, E, a, th))
    I["J41"] = gauss(4, lambda p, E, a, bb, th: E * w2(p, E, a, th))
    I["N10"] = gauss(1, lambda p, E, a, bb, th: bb * p * w2(p, E, a, th))
    I["N30"] = gauss(3, lambda p, E, a, bb, th: bb * E * E / p * w2(p, E, a, th))
    I["N31"] = gauss(3, lambda p, E, a, bb, th: bb * p * w2(p, E, a, th))
    I["M20"] = gauss(2, lambda p, E, a, bb, th: bb * bb * E * w2(p, E, a, th))
    I["M21"] = gauss(2, lambda p, E, a, bb, th: bb * bb * p * p / E * w2(p, E, a, th))
    I["e"] = gauss(2, lambda p, E, a, bb, th: E * w1(p, E, a, th))
    I["p"] = gauss(2, lambda p, E, a, bb, th: p * p / E * w1(p, E, a, th))
    I["J30"] = gauss(3, lambda p, E, a, bb, th: E * E / p * w2(p, E, a, th))
    I["J32"] = gauss(3, lambda p, E, a, bb, th: p**3 / (E * E) * w2(p, E, a, th))
    I["nB"] = gauss(1, lambda p, E, a, bb, th: bb * p * w1(p, E, a, th))
    I["N20"] = gauss(2, lambda p, E, a, bb, th: bb * E * w2(p, E, a, th))
    I["M10"] = gauss(1, lambda p, E, a, bb, th: bb * bb * p * w2(p, E, a, th))
    I["M11"] = gauss(1, lambda p, E, a, bb, th: bb * bb * p**3 / (E * E) * w2(p, E, a, th))

    T2 = T[None, :] ** 2
    T3 = T[None, :] ** 3
    T4 = T[None, :] ** 4
    T5 = T[None, :] ** 5
    T6 = T[None, :] ** 6
    m2 = (m * m)[None, None, :]
    gk = g[None, None, :]
    C = TWO_PI2_HBARC3

    def s(key, fact, with_mass2=False):
        pref = gk * m2 if with_mass2 else gk
        return (pref * I[key]).sum(axis=-1) * fact

    J20 = s("J20", T4 / C)
    J21 = s("J21", T4 / (3 * C))
    J40 = s("J40", T6 / C)
    J41 = s("J41", T6 / (3 * C))
    N10 = s("N10", T3 / C)
    N30 = s("N30", T5 / C)
    N31 = s("N31", T5 / (3 * C))
    M20 = s("M20", T4 / C)
    M21 = s("M21", T4 / (3 * C))
    A20 = s("J20", T4 / C, with_mass2=True)
    A21 = s("J21", T4 / (3 * C), with_mass2=True)
    B10 = s("N10", T3 / C, with_mass2=True)

    bulk0 = (4 * N30 - B10) * N30 - M20 * (4 * J40 - A20)
    bulk1 = (B10 - N30) * (4 * J40 - A20) - (4 * N30 - B10) * (A20 - J40)
    bulk2 = M20 * (A20 - J40) - (B10 - N30) * N30
    denom = (A21 - J41) * bulk0 + N31 * bulk1 + (4 * J41 - A21) * bulk2
    diff_den = N31 * N31 - M21 * J41
    out = {
        "c0": bulk0 / denom * T4,
        "c1": bulk1 / denom * T3,
        "c2": bulk2 / denom * T4,
        "c3": J41 / diff_den * T4,
        "c4": -N31 / diff_den * T5,
    }
    e = s("e", T4 / C)
    p_ = s("p", T4 / (3 * C))
    J30 = s("J30", T5 / C)
    J32 = s("J32", T5 / (15 * C))
    nB = s("nB", T3 / C)
    N20 = s("N20", T4 / C)
    M10 = s("M10", T3 / C)
    M11 = s("M11", T3 / (3 * C))
    ce_den = J30 * M10 - N20 * N20
    G = ((e + p_) * N20 - J30 * nB) / ce_den
    F = T2 * (N20 * nB - (e + p_) * M10) / ce_den
    betabulk = G * nB * T[None, :] + F * (e + p_) / T[None, :] + 5 * J32 / (3 * T[None, :])
    betaV = M11 - nB * nB * T[None, :] / (e + p_)
    betapi = J32 / T[None, :]
    out.update({
        "G": G,
        "F": F / T[None, :],
        "betabulk": betabulk / T4,
        "betaV": betaV / T3,
        "betapi": betapi / T4,
    })
    out["T"] = T
    out["muB"] = muB
    return out


_HEADERS = {
    "c0": "c0_T4 [fm^3/GeV^3 * GeV^4]",
    "c1": "c1_T3 [fm^3/GeV^2 * GeV^3]",
    "c2": "c2_T4 [fm^3/GeV^3 * GeV^4]",
    "c3": "c3_T4 [fm^3/GeV * GeV^4]",
    "c4": "c4_T5 [fm^3/GeV^2 * GeV^5]",
    "G": "G [1]",
    "F": "F_over_T [fm^-1 / GeV]",
    "betabulk": "betabulk_over_T4 [fm^-4 / GeV^4]",
    "betaV": "betaV_over_T3 [fm^-3 / GeV^3]",
    "betapi": "betapi_over_T4 [fm^-4 / GeV^4]",
}


def write_tables(tables: dict, out_dir: Path) -> None:
    """The coefficient files: two header ints, one header line, then
    ``T muB value`` rows, T fastest, six decimals."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    T = tables["T"]
    muB = tables["muB"]
    for name, header in _HEADERS.items():
        data = tables[name]
        with open(out_dir / f"{name}.dat", "w") as fh:
            fh.write(f"{len(T)}\n{len(muB)}\n")
            fh.write(f"T [GeV]\t\tmuB [GeV]\t\t{header}\n")
            for iB in range(len(muB)):
                for iT in range(len(T)):
                    fh.write(f"{T[iT]:.6f}\t\t{muB[iB]:.6f}\t\t"
                             f"{data[iB, iT]:.6f}\n")


def write_data_dir(root: Path, cfg: dict) -> dict:
    """Write everything the driver's set-up reads for configuration
    ``cfg`` (its "inputs" group) under ``root``; returns the species of
    the hadron list (species_of_lines) and the chosen MC IDs (every
    species, in list order)."""
    inp = cfg["inputs"]
    root = Path(root)
    (root / "PDG").mkdir(parents=True, exist_ok=True)
    lines = pdg_box_lines(inp["n_species"])
    (root / "PDG/pdg_box.dat").write_text("\n".join(lines) + "\n")
    species = species_of_lines(lines)
    (root / "PDG/chosen_particles.dat").write_text(
        "\n".join(str(int(m)) for m in species["mc_id"]) + "\n")
    write_quadrature_tables(root, inp["n_pT"], inp["n_phi"], inp["n_eta"],
                            n_y=inp["n_y"])
    write_tables(compute_tables(species, n_T=inp["n_T"], n_muB=1),
                 root / "deltaf_coefficients/vh/smash_box")
    return species


def make_surfaces(cfg: dict, seed: int, count: int,
                  device="cpu") -> list[dict]:
    """``count`` distinct surfaces of configuration ``cfg``, surface k
    drawn from the seed sequence (seed, k): every seed gives the same cell
    count and the same distributions.  Where ``cfg["inputs"]`` sets
    ``eos_consistent``, each surface's E and P then become those of the
    configuration's hadron list at the cell's T (make_eos_consistent on
    ``device``), as a df-5 reconstruction needs."""
    inp = cfg["inputs"]
    surfaces = [make_surface(inp["n_cells"], [seed, k],
                             dimension=inp["dimension"],
                             shear_scale=inp["shear_scale"],
                             bulk_scale=inp["bulk_scale"])
                for k in range(count)]
    if inp.get("eos_consistent"):
        species = species_of_lines(pdg_box_lines(inp["n_species"]))
        for s in surfaces:
            make_eos_consistent(s, species, device)
    return surfaces
