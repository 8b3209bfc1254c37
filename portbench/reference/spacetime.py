"""Plain reference of operation 0: the spacetime distributions
dN/(tau dtau dy), dN/(2 pi r dr dy) and dN/(dphi_s dy) of a 2+1d df-1
surface, in plain torch, written from the reference iS3D's
SpacetimeDistribution.cpp.

It imports nothing of the program.  A live cell's (u.dsigma > 0) dN/dy of
a species is the Cooper-Frye integrand of cooper_frye.py (``prepare``,
``_value_grad``) at every node of the eta table (no eta fold, no pack),
contracted with the pT, phi and eta quadrature weights, times the
prefactor and the degeneracy.  The cells are binned here, in f64 on the
host, as SpacetimeDistribution.cpp:413-421 bins them: floor((tau -
tau_min) / dtau), r = sqrt(x^2 + y^2), phi_s in [0, 2 pi); a cell out of
range on an axis is dropped on that axis.  The bins are normalised as
:449-490 do, by tau_mid dtau, 2 pi r_mid dr and dphi.

Cells go in blocks, so that a check at 100,000 cells fits on the card.
``dtype`` sets the precision of the per-evaluation arithmetic (f64 for
the reference; a lower one for a control), the sums over momenta, eta and
the cells of a bin running in f64 for f64 and in f32 otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cooper_frye import BLOCK_ELEMENTS, PREFACTOR, _psi, _value_grad

f64 = torch.float64


def _widths(p: dict) -> tuple[float, float, float]:
    """The bin widths of tau, r and phi_s."""
    return ((p["tau_max"] - p["tau_min"]) / p["tau_bins"],
            (p["r_max"] - p["r_min"]) / p["r_bins"],
            2.0 * math.pi / p["phip_bins"])


def bin_indices(tau: np.ndarray, x: np.ndarray, y: np.ndarray,
                p: dict) -> list[tuple[np.ndarray, int]]:
    """(bin of each cell, number of bins) of the axes tau, r and phi_s,
    from the configuration's parameters ``p``."""
    dtau, dr, dphi = _widths(p)
    r = np.sqrt(x * x + y * y)
    phi = np.arctan2(y, x)
    phi = np.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return [(np.floor((tau - p["tau_min"]) / dtau).astype(np.int64),
             p["tau_bins"]),
            (np.floor((r - p["r_min"]) / dr).astype(np.int64), p["r_bins"]),
            (np.floor(phi / dphi).astype(np.int64), p["phip_bins"])]


def bin_norms(p: dict) -> list[np.ndarray]:
    """What each axis's bin sums are divided by: tau_mid dtau,
    2 pi r_mid dr and dphi."""
    dtau, dr, dphi = _widths(p)
    tau_mid = p["tau_min"] + dtau * (np.arange(p["tau_bins"]) + 0.5)
    r_mid = p["r_min"] + dr * (np.arange(p["r_bins"]) + 0.5)
    return [tau_mid * dtau, 2.0 * math.pi * r_mid * dr,
            np.full(p["phip_bins"], dphi)]


def dN_dy_cells(prep: dict, species: dict, grids: dict, cfg: dict,
                dtype=f64) -> torch.Tensor:
    """(live cells, species) sums of w_pT w_phi w_eta (p.dsigma) f over
    every pT, phi and eta node, without the prefactor and the degeneracy,
    in the sums' dtype."""
    p = cfg["params"]
    if p["dimension"] != 2 or p["df_mode"] != 1:
        raise ValueError("the op-0 reference implements 2+1d df 1")
    dev = prep["tau"].device
    acc_t = f64 if dtype == f64 else torch.float32

    def b(a):
        return torch.as_tensor(np.asarray(a), dtype=f64, device=dev)

    n_s, n_pT, n_phi = len(species["mass"]), len(grids["pT"]), len(grids["phi"])
    s, k, f = (a.ravel() for a in np.meshgrid(
        np.arange(n_s), np.arange(n_pT), np.arange(n_phi), indexing="ij"))
    mass = b(species["mass"][s])
    pT = b(grids["pT"][k])
    phi = b(grids["phi"][f])
    w_pf = b(grids["pT_w"][k] * grids["phi_w"][f]).to(acc_t)
    sgn = b(species["sign"][s]).to(dtype)[None, :, None]
    m2 = (mass * mass).to(dtype)[None, :, None]
    mT = torch.sqrt(mass * mass + pT * pT)
    px = (pT * torch.cos(phi)).to(dtype)[None, :, None]
    py = (pT * torch.sin(phi)).to(dtype)[None, :, None]
    eta, w_eta = b(grids["eta"]), b(grids["eta_w"])
    # y = 0: p^tau = mT cosh eta, p^eta = -mT sinh eta / tau
    pt = (mT[:, None] * torch.cosh(eta)[None, :])[None].to(dtype)
    mT_sinh = (mT[:, None] * torch.sinh(eta)[None, :])[None]
    w = w_eta.to(dtype)[None, None, :]
    n_cells = prep["tau"].shape[0]
    blk = max(1, BLOCK_ELEMENTS // (mass.shape[0] * eta.shape[0]))
    out = []
    for i in range(0, n_cells, blk):
        cb = {key: v[i:i + blk] for key, v in prep.items() if key != "n_live"}

        def c(key):
            return _psi(cb, key, dtype)

        pn = (-mT_sinh / cb["tau"][:, None, None]).to(dtype)
        val = _value_grad(c, m2, sgn, pt, pn, px, py, w)
        per = val.to(acc_t).sum(dim=2) * w_pf[None, :]
        out.append(per.reshape(-1, n_s, n_pT * n_phi).sum(dim=2))
    return torch.cat(out)


def dN_dX(prep: dict, species: dict, grids: dict, cfg: dict,
          dtype=f64) -> np.ndarray:
    """The normalised distributions of ``species`` (arrays ``mass``,
    ``sign``, ``gspin``) over the live cells of ``prep``: (species,
    tau_bins + r_bins + phip_bins) f64, the axes tau, r, phi_s in turn."""
    p = cfg["params"]
    dN = dN_dy_cells(prep, species, grids, cfg, dtype)
    dev = dN.device
    host = [prep[key].cpu().numpy() for key in ("tau", "x", "y")]
    g = torch.as_tensor(species["gspin"], dtype=f64, device=dev)[:, None]
    out = []
    for (idx, n_bins), norm in zip(bin_indices(*host, p), bin_norms(p)):
        ok = np.nonzero((idx >= 0) & (idx < n_bins))[0]
        acc = torch.zeros((dN.shape[1], n_bins), dtype=dN.dtype, device=dev)
        acc.index_add_(1, torch.as_tensor(idx[ok], device=dev),
                       dN[torch.as_tensor(ok, device=dev)].T)
        out.append((PREFACTOR * g * acc.to(f64)).cpu().numpy() / norm)
    return np.concatenate(out, axis=1)
