"""Plain reference of the op-1 spectra: the Cooper-Frye integral with the
Grad 14-moment (df 1) or the PTB modified-equilibrium (df 4) distribution,
in plain torch, written from the reference iS3D's MomentumSpectra.cpp and
DeltafData.cpp and from the JAX package's f64 engines as a pattern.

It imports nothing of the program.  It reads the same raw inputs the
program reads (the surface arrays, the hadron list, the quadrature and
delta-f coefficient files of the data directory) and works out again
everything the program derives from them: the completed shear tensor,
the live cells, the delta-f coefficients and their splines, the PTB
(lambda, z) splines at the surface-averaged temperature, the local rest
frame, the transformation matrix A, its determinant and inverse, the
breakdown and narrow-window branches.  No eta fold and no packing: every
eta node (2+1d) or every (cell, y) row (3+1d) is evaluated.

Only the requested bins (species, pT, phi, y) are computed, summed over
blocks of cells, so a check over a sample of bins at full surface size
fits in seconds on the card.  ``dtype`` sets the precision of the
per-evaluation arithmetic (f64 for the reference; a lower one for a
control), the sum over cells running in f64 for f64 and in f32 otherwise.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from scipy.interpolate import CubicSpline

HBARC = 0.197327053
PREFACTOR = (2.0 * math.pi * HBARC) ** -3
TWO_PI2_HBARC3 = 2.0 * math.pi ** 2 * HBARC ** 3
DETA_MIN = 1.0e-5        # the breakdown threshold on det A
WINDOW_DET = 0.01        # 3+1d: det A below it opens the narrow window
BLOCK_ELEMENTS = 1 << 25  # (cells x bins x eta) elements of one block
f64 = torch.float64


# ---------------------------------------------------------------- inputs --

def _decode(mcid: int) -> tuple[int, int, int, bool]:
    """(gspin, baryon, sign, has antiparticle) of a PDG MC ID."""
    d = [(mcid // 10 ** i) % 10 for i in range(10)]
    if mcid == 1000010020:
        return 3, 2, -1, True
    if d[1] == 0 or d[2] == 0:
        raise ValueError(f"MC ID {mcid} is no hadron")
    baryon = 1 if d[3] != 0 else 0
    nJ = d[0] + d[7]
    return (nJ if nJ > 0 else 1), baryon, (1 if baryon else -1), \
        bool(baryon or d[2] != d[1])


def read_species(data_dir: Path) -> dict:
    """Every species of PDG/pdg_box.dat (smash-box lines), and the chosen
    ones of PDG/chosen_particles.dat in file order."""
    table = {}
    all_rows = []
    for line in (Path(data_dir) / "PDG/pdg_box.dat").read_text().splitlines():
        parts = line.split("#", 1)[0].split()
        if len(parts) < 5:
            continue
        for tok in parts[4:8]:
            mcid = int(tok)
            if mcid == 0:
                continue
            g, b, sgn, anti = _decode(mcid)
            rows = [(mcid, float(parts[1]), g, sgn, b)]
            if anti:
                rows.append((-mcid, float(parts[1]), g, sgn, -b))
            for r in rows:
                table[r[0]] = r
                all_rows.append(r)
    chosen = [int(t) for t in
              (Path(data_dir) / "PDG/chosen_particles.dat").read_text().split()]

    def arrays(rows):
        c = list(zip(*rows))
        return {"mc_id": np.array(c[0]), "mass": np.array(c[1], float),
                "gspin": np.array(c[2], float), "sign": np.array(c[3], float),
                "baryon": np.array(c[4], float)}
    return {"all": arrays(all_rows), "chosen": arrays([table[m] for m in chosen])}


def _two_cols(path: Path) -> tuple[np.ndarray, np.ndarray]:
    a = np.loadtxt(path, ndmin=2)
    return a[:, 0], a[:, 1]


def read_grids(data_dir: Path) -> dict:
    t = Path(data_dir) / "tables"
    out = {}
    for key, rel in (("pT", "momentum/pT_table.dat"),
                     ("phi", "momentum/phi_table.dat"),
                     ("y", "momentum/y_table.dat"),
                     ("eta", "spacetime_rapidity/eta_table.dat")):
        out[key], out[key + "_w"] = _two_cols(t / rel)
    return out


def read_laguerre(data_dir: Path, family: int) -> tuple[np.ndarray, np.ndarray]:
    """Roots and weights of one generalized Gauss-Laguerre family of
    tables/gauss/gla_roots_weights.txt."""
    rows = np.loadtxt(Path(data_dir) / "tables/gauss/gla_roots_weights.txt",
                      skiprows=1)
    sel = rows[:, 0] == family
    return rows[sel, 1], rows[sel, 2]


def read_coefficient(data_dir: Path, name: str) -> tuple[np.ndarray, np.ndarray]:
    """The muB = 0 row of one delta-f coefficient file: (T grid, values)."""
    path = Path(data_dir) / "deltaf_coefficients/vh/smash_box" / f"{name}.dat"
    with open(path) as fh:
        n_T = int(fh.readline())
        fh.readline()
        fh.readline()
        rows = np.loadtxt(fh, max_rows=n_T, ndmin=2)
    return rows[:, 0], rows[:, 2]


def _spline(x: np.ndarray, y: np.ndarray):
    return CubicSpline(x, y, bc_type="natural")


# ------------------------------------------------------------- per cell --

def _plasma_temperature(s: dict) -> float:
    """The surface average of T weighted by the largest volume element
    |u.ds| + sqrt(|(u.ds)^2 - ds.ds|) (readindata.cpp:342-366)."""
    tau2 = s["tau"] ** 2
    ut = np.sqrt(1.0 + s["ux"] ** 2 + s["uy"] ** 2 + tau2 * s["un"] ** 2)
    uds = ut * s["dat"] + s["ux"] * s["dax"] + s["uy"] * s["day"] + s["un"] * s["dan"]
    dsds = s["dat"] ** 2 - s["dax"] ** 2 - s["day"] ** 2 - s["dan"] ** 2 / tau2
    w = np.abs(uds) + np.sqrt(np.abs(uds ** 2 - dsds))
    return float((s["T"] * w).sum() / w.sum())


def _jonah_splines(species_all: dict, T: float, roots, weights):
    """lambda^2 and z as splines of Pi / P_eq over lambda in [-1, 2], at
    the surface-averaged T (DeltafData.cpp:220-295), and the largest
    Pi / P_eq of the scan."""
    keep = species_all["mass"] > 0.0
    mbar = species_all["mass"][keep] / T
    g = species_all["gspin"][keep]
    sgn = species_all["sign"][keep]
    lam = np.linspace(-1.0, 2.0, 301)
    p = roots[None, None, :]
    E = np.sqrt(p * p + mbar[None, :, None] ** 2)
    occ = np.exp(p - E) / (1.0 + sgn[None, :, None] * np.exp(-E))

    def moments(lam):
        scale2 = ((1.0 + lam) ** 2)[:, None, None]
        Em = np.sqrt(p * p * scale2 + mbar[None, :, None] ** 2)
        return ((weights * Em * occ).sum(-1) @ g,
                (weights * p * p * scale2 / Em * occ).sum(-1) @ g / 3.0)

    E_mod, P_mod = moments(lam)
    (E0,), (P0,) = moments(np.zeros(1))
    z = E0 / E_mod
    x = P_mod / P0 * z - 1.0
    return _spline(x, lam * lam), _spline(x, z), float(x.max())


def prepare(surface: dict, data_dir: Path, cfg: dict, device) -> dict:
    """Per-cell f64 tensors of the live cells (u.dsigma > 0) on ``device``:
    the geometry, the flow, the completed shear tensor and the delta-f
    state of ``cfg``'s df mode (1 or 4)."""
    s = surface
    df_mode = cfg["params"]["df_mode"]
    tau, ux, uy, un = s["tau"], s["ux"], s["uy"], s["un"]
    ut = np.sqrt(1.0 + ux * ux + uy * uy + (tau * un) ** 2)
    live = (ut * s["dat"] + ux * s["dax"] + uy * s["day"] + un * s["dan"]) > 0.0
    c = {k: v[live] for k, v in s.items()}
    c["ut"] = ut[live]
    tau, ux, uy, un, ut = c["tau"], c["ux"], c["uy"], c["un"], c["ut"]

    # pi^{tau mu} and pi^{eta eta} from pi.u = 0 and Tr pi = 0
    # (MomentumSpectra.cpp:149-161)
    tau2 = tau * tau
    pixx, pixy, pixn, piyy, piyn = (c["pixx"], c["pixy"], c["pixn"],
                                    c["piyy"], c["piyn"])
    pinn = (pixx * (ux * ux - ut * ut) + piyy * (uy * uy - ut * ut)
            + 2.0 * (pixy * ux * uy + tau2 * un * (pixn * ux + piyn * uy))) \
        / (tau2 * (1.0 + ux * ux + uy * uy))
    pitn = (pixn * ux + piyn * uy + tau2 * un * pinn) / ut
    pity = (pixy * ux + piyy * uy + tau2 * un * piyn) / ut
    pitx = (pixx * ux + pixy * uy + tau2 * un * pixn) / ut
    pitt = (pitx * ux + pity * uy + tau2 * un * pitn) / ut
    c.update(pinn=pinn, pitn=pitn, pity=pity, pitx=pitx, pitt=pitt)

    T, E, P, Pi = c["T"], c["E"], c["P"], c["bulkPi"]
    if df_mode == 1:
        Tg, c0 = read_coefficient(data_dir, "c0")
        _, c2 = read_coefficient(data_dir, "c2")
        c0 = _spline(Tg, c0)(T) / T ** 4
        c2 = _spline(Tg, c2)(T) / T ** 4
        c["shear"] = 1.0 / (2.0 * T * T * (E + P))
        c["bulk_m2"] = (c0 - c2) * Pi
        c["bulk_E2"] = (4.0 * c2 - c0) * Pi
    elif df_mode == 4:
        c.update(_ptb_cells(c, data_dir, _plasma_temperature(s)))
    else:
        raise ValueError("the reference implements df 1 and df 4")
    out = {k: torch.as_tensor(np.ascontiguousarray(v), dtype=f64, device=device)
           for k, v in c.items()}
    out["n_live"] = int(live.sum())
    return out


def _ptb_cells(c: dict, data_dir: Path, T_avg: float) -> dict:
    """The PTB state of each cell (MomentumSpectra.cpp:601-826,
    EmissionFunction.cpp:65-109): the regulated bulk pressure, lambda, z,
    delta lambda, delta z, the LRF shear tensor, A, det A, A^-1, the
    breakdown flag and the renormalisation z / det A (3+1d)."""
    species = read_species(data_dir)["all"]
    roots, weights = read_laguerre(data_dir, 2)
    lam2_of, z_of, x_max = _jonah_splines(species, T_avg, roots, weights)
    T, E, P = c["T"], c["E"], c["P"]
    Pi = np.minimum(np.maximum(c["bulkPi"], -(1.0 - 1.0e-5) * P),
                    P * (x_max - 1.0e-5))
    x = Pi / P
    lam = np.sign(Pi) * np.sqrt(np.maximum(lam2_of(x), 0.0))
    z = z_of(x)
    Tg, bp = read_coefficient(data_dir, "betapi")
    betapi = _spline(Tg, bp)(T) * T ** 4
    dlam = Pi / (5.0 * betapi - 3.0 * P * (E + P) / E)
    dz = -3.0 * dlam * P / E

    # local rest frame (LocalRestFrame.cpp:12-41) and pi in it
    tau, ux, uy, un, ut = c["tau"], c["ux"], c["uy"], c["un"], c["ut"]
    tau2 = tau * tau
    uperp = np.sqrt(ux * ux + uy * uy)
    utperp = np.sqrt(1.0 + ux * ux + uy * uy)
    sinhL, coshL = tau * un / utperp, ut / utperp
    big = uperp > 1.0e-5
    safe = np.where(big, uperp, 1.0)
    Xt, Xn = uperp * coshL, uperp * sinhL / tau
    Xx = np.where(big, utperp * ux / safe, 1.0)
    Xy = np.where(big, utperp * uy / safe, 0.0)
    Yx = np.where(big, -uy / safe, 0.0)
    Yy = np.where(big, ux / safe, 1.0)
    Zt, Zn = sinhL, coshL / tau
    # pi^{mu nu} as a (cells, 4, 4) array and the tetrad's covariant legs
    pi = np.empty((len(tau), 4, 4))
    comp = {(0, 0): "pitt", (0, 1): "pitx", (0, 2): "pity", (0, 3): "pitn",
            (1, 1): "pixx", (1, 2): "pixy", (1, 3): "pixn", (2, 2): "piyy",
            (2, 3): "piyn", (3, 3): "pinn"}
    for (i, j), k in comp.items():
        pi[:, i, j] = pi[:, j, i] = c[k]
    metric = np.stack([np.ones_like(tau), -np.ones_like(tau),
                       -np.ones_like(tau), -tau2], axis=1)
    legs = np.stack([np.stack([Xt, Xx, Xy, Xn], 1),
                     np.stack([0 * tau, Yx, Yy, 0 * tau], 1),
                     np.stack([Zt, 0 * tau, 0 * tau, Zn], 1)], axis=1)
    low = legs * metric[:, None, :]              # X_mu, Y_mu, Z_mu
    pi_lrf = np.einsum("cam,cmn,cbn->cab", low, pi, low)
    A = (np.eye(3)[None] * (1.0 + lam)[:, None, None]
         + pi_lrf * (0.5 / betapi)[:, None, None])
    detA = np.linalg.det(A)
    breaks = (detA <= DETA_MIN) | (z < 0.0)
    ok = np.abs(detA) > 1e-300
    Ainv = np.where(ok[:, None, None],
                    np.linalg.inv(np.where(ok[:, None, None], A, np.eye(3))),
                    0.0)
    renorm = z / np.where(ok, detA, 1.0)
    return {"Pi_reg": Pi, "shear_b": 0.5 / (betapi * T), "dlam": dlam,
            "dz": dz, "Xt": Xt, "Xx": Xx, "Xy": Xy, "Xn": Xn, "Yx": Yx,
            "Yy": Yy, "Zt": Zt, "Zn": Zn,
            **{f"Ai{i}{j}": Ainv[:, i, j] for i in range(3) for j in range(3)},
            "detA": detA, "breaks": breaks.astype(float), "renorm": renorm}


def branch_rows(prep: dict, y_nodes: np.ndarray) -> tuple[int, int]:
    """3+1d df 4: the (live cell, y) rows that take the modified and the
    linearised (breakdown or narrow-window) branch."""
    y = torch.as_tensor(y_nodes, dtype=f64, device=prep["tau"].device)
    d = y[None, :] - prep["eta"][:, None]
    det = prep["detA"][:, None]
    lin = (prep["breaks"][:, None] > 0) | ((det < WINDOW_DET) & (d.abs() < det))
    n_lin = int(lin.sum())
    return lin.numel() - n_lin, n_lin


# ---------------------------------------------------------- the integral --

def _psi(prep: dict, key: str, dtype):
    return prep[key].to(dtype)[:, None, None]


def _value_grad(c, m2, sgn, pt, pn, px, py, w):
    """w (p.dsigma) f_eq (1 + df) with the Grad 14-moment df."""
    tau2 = c("tau") * c("tau")
    pdd = pt * c("dat") + px * c("dax") + py * c("day") + pn * c("dan")
    E = pt * c("ut") - px * c("ux") - py * c("uy") - pn * (tau2 * c("un"))
    feq = 1.0 / (torch.exp(E / c("T")) + sgn)
    pipp = (c("pitt") * pt * pt + c("pixx") * px * px + c("piyy") * py * py
            + (tau2 * tau2 * c("pinn")) * pn * pn
            + 2.0 * (-(c("pitx") * px + c("pity") * py) * pt
                     + c("pixy") * px * py
                     + tau2 * pn * (c("pixn") * px + c("piyn") * py
                                    - c("pitn") * pt)))
    df = (1.0 - sgn * feq) * (c("shear") * pipp + c("bulk_m2") * m2
                              + c("bulk_E2") * E * E)
    return w * pdd * feq * (1.0 + df)


def _value_ptb_3d(c, m2, sgn, pt, pn, px, py, delta):
    """p.dsigma f for PTB in 3+1d: the modified equilibrium, or the
    linearised df where the cell breaks down or the row lies in the
    narrow window |y - eta| < det A < 0.01."""
    tau2 = c("tau") * c("tau")
    pdd = pt * c("dat") + px * c("dax") + py * c("day") + pn * c("dan")
    # linearised (MomentumSpectra.cpp:900-929)
    E = pt * c("ut") - px * c("ux") - py * c("uy") - pn * (tau2 * c("un"))
    feq = 1.0 / (torch.exp(E / c("T")) + sgn)
    feqbar = 1.0 - sgn * feq
    pipp = (c("pitt") * pt * pt + c("pixx") * px * px + c("piyy") * py * py
            + (tau2 * tau2 * c("pinn")) * pn * pn
            + 2.0 * (-(c("pitx") * px + c("pity") * py) * pt
                     + c("pixy") * px * py
                     + tau2 * pn * (c("pixn") * px + c("piyn") * py
                                    - c("pitn") * pt)))
    df = (feqbar * c("shear_b") * pipp / E + c("dz") - 3.0 * c("dlam")
          + feqbar * c("dlam") * (E - m2 / E) / c("T"))
    lin = pdd * feq * (1.0 + df)
    # modified: p_mod = A^-1 p_LRF, f = |z / det A| / (exp(E_mod / T) + sign)
    qx = -c("Xt") * pt + c("Xx") * px + c("Xy") * py + c("Xn") * (tau2 * pn)
    qy = c("Yx") * px + c("Yy") * py
    qz = -c("Zt") * pt + c("Zn") * (tau2 * pn)
    mx = c("Ai00") * qx + c("Ai01") * qy + c("Ai02") * qz
    my = c("Ai10") * qx + c("Ai11") * qy + c("Ai12") * qz
    mz = c("Ai20") * qx + c("Ai21") * qy + c("Ai22") * qz
    E_mod = torch.sqrt(m2 + mx * mx + my * my + mz * mz)
    mod = pdd * c("renorm").abs() / (torch.exp(E_mod / c("T")) + sgn)
    det = c("detA")
    use_lin = (c("breaks") > 0) | ((det < WINDOW_DET) & (delta.abs() < det))
    return torch.where(use_lin, lin, mod)


def spectra_bins(prep: dict, species: dict, grids: dict, bins: dict,
                 cfg: dict, dtype=f64) -> np.ndarray:
    """dN / (pT dpT dphi dy) at the bins (arrays ``s``, ``pT``, ``phi``,
    ``y`` of indices into the chosen species and the grids), summed over
    every live cell (and every eta node in 2+1d)."""
    dev = prep["tau"].device
    acc_t = f64 if dtype == f64 else torch.float32
    p = cfg["params"]

    def b(a):
        return torch.as_tensor(np.asarray(a), dtype=f64, device=dev)

    s = np.asarray(bins["s"])
    mass = b(species["mass"][s])
    pT = b(grids["pT"][bins["pT"]])
    phi = b(grids["phi"][bins["phi"]])
    y = b(grids["y"][bins["y"]])
    sgn = b(species["sign"][s]).to(dtype)[None, :, None]
    m2 = (mass * mass).to(dtype)[None, :, None]
    mT = torch.sqrt(mass * mass + pT * pT)
    px = (pT * torch.cos(phi)).to(dtype)[None, :, None]
    py = (pT * torch.sin(phi)).to(dtype)[None, :, None]
    if p["dimension"] == 2:
        eta, w_eta = b(grids["eta"]), b(grids["eta_w"])
        n_e = eta.shape[0]
    else:
        n_e = 1
    nb = mass.shape[0]
    n_cells = prep["tau"].shape[0]
    blk = max(1, BLOCK_ELEMENTS // (nb * n_e))
    acc = torch.zeros(nb, dtype=acc_t, device=dev)
    for i in range(0, n_cells, blk):
        cb = {k: v[i:i + blk] for k, v in prep.items() if k != "n_live"}

        def c(key):
            return _psi(cb, key, dtype)

        if p["dimension"] == 2:
            # delta = y - eta with y = 0: p^tau = mT cosh eta,
            # p^eta = -mT sinh eta / tau
            pt = (mT[:, None] * torch.cosh(eta)[None, :])[None].to(dtype)
            pn = (-(mT[:, None] * torch.sinh(eta)[None, :])[None]
                  / cb["tau"][:, None, None]).to(dtype)
            w = w_eta.to(dtype)[None, None, :]
            if p["df_mode"] != 1:
                raise ValueError("2+1d: the reference implements df 1")
            val = _value_grad(c, m2, sgn, pt, pn, px, py, w)
        else:
            delta = y[None, :, None] - cb["eta"][:, None, None]
            pt = (mT[None, :, None] * torch.cosh(delta)).to(dtype)
            pn = (mT[None, :, None] * torch.sinh(delta)
                  / cb["tau"][:, None, None]).to(dtype)
            if p["df_mode"] == 1:
                val = _value_grad(c, m2, sgn, pt, pn, px, py, 1.0)
            else:
                val = _value_ptb_3d(c, m2, sgn, pt, pn, px, py, delta.to(dtype))
        acc += val.to(acc_t).sum(dim=(0, 2))
    g = b(species["gspin"][s])
    return (PREFACTOR * g * acc.to(f64)).cpu().numpy()
