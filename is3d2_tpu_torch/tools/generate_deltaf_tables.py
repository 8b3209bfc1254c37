"""Delta-f coefficient table generator (numpy copy of
is3d2_tpu/tools/generate_deltaf_tables.py).

Replaces the reference's standalone C++ generator
(generate_delta_f_coefficients/*/df_vh_dimensionless/src/deltaf_table.cpp):
computes the dimensionless Grad 14-moment (c0..c4) and RTA Chapman-Enskog
(F, G, betabulk, betaV, betapi) coefficient tables over a (T, muB) grid by
HRG thermal integrals, and writes them in the exact file format consumed by
io/deltaf_tables.py (two header ints, one header line, "T muB value" rows,
T fastest).

Fully vectorized over (T, muB, species, quadrature) with numpy; 64-point
generalized Gauss-Laguerre families are generated with scipy (identical to
the reference's gla_roots_weights_64_points.txt).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.special import roots_genlaguerre

from ..constants import two_pi2_hbarC3
from ..io.pdg import SpeciesTable

GLA_PTS = 64


def _families(n=GLA_PTS):
    return {a: roots_genlaguerre(n, a) for a in (1, 2, 3, 4)}


def compute_tables(species: SpeciesTable,
                   T_min=0.1, T_max=0.2, n_T=101,
                   muB_min=0.0, muB_max=0.8, n_muB=81):
    """Returns dict of (n_muB, n_T) arrays with the temperature-power scaling
    of the shipped tables (deltaf_table.cpp:240-246, 389-394)."""
    fams = _families()
    T = np.linspace(T_min, T_max, n_T)             # (nT,)
    muB = np.linspace(muB_min, muB_max, n_muB)     # (nB,)

    mask = species.mass > 0.0
    m = species.mass[mask]
    g = species.gspin[mask]
    b = species.baryon[mask]
    th = species.sign[mask]

    # axes: [B, T_, k(species), q]; loop over muB to bound memory
    def gauss(a, integrand):
        p, w = fams[a]
        p4 = p[None, None, :]
        w_q = w[None, None, :]
        mbar = m[None, :, None] / T[:, None, None]           # (T, k, 1)
        Ebar = np.sqrt(p4 * p4 + mbar * mbar)
        out = np.empty((len(muB), len(T), len(m)))
        for iB in range(len(muB)):
            alpha = (b[None, :, None] * muB[iB] / T[:, None, None])
            val = integrand(p4, Ebar, alpha, b[None, :, None], th[None, :, None])
            out[iB] = (w_q * val).sum(axis=-1)
        return out                                           # (B, T, k)

    # first/second-order statistical weights
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
    C = two_pi2_hbarC3

    def s(key, fact, with_mass2=False):
        pref = gk * m2 if with_mass2 else gk
        return (pref * I[key]).sum(axis=-1) * fact

    # 14-moment thermodynamic integrals (deltaf_table.cpp:144-206)
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

    # Chapman-Enskog (deltaf_table.cpp:306-394)
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


def write_tables(tables: dict, out_dir: str | Path) -> None:
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


def main(argv=None):
    import argparse
    from ..io.pdg import read_pdg

    ap = argparse.ArgumentParser(description="generate delta-f coefficient tables")
    ap.add_argument("--hrg-eos", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--pdg-dir", default="PDG")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    species = read_pdg(args.hrg_eos, args.pdg_dir)
    tables = compute_tables(species)
    write_tables(tables, args.out)
    print(f"wrote 10 coefficient tables to {args.out}")


if __name__ == "__main__":
    main()
