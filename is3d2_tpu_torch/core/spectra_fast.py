"""Helpers of the compensated-f32 ("f32c") spectra path.

Counterpart of the f32c pieces of is3d2_tpu/core/spectra_fast.py: the eta
quadrature fold with its exactness gates (df 1/2, and the strict one of the
feqmod kernel), the split-exact arithmetic, and the 3+1d light-cone rows
(``momentum_matrix_3d(_comp)``, ``_cell_Q_3d(_comp)``) that kernel B1's
3+1d mode takes.

The plain-f32 path is ~3e-6 relative: the exp amplifies the f32 rounding of
its argument a = u.p/T - alphaB b.  The compensated path computes only that
argument in split-exact arithmetic:

  * every f64 factor splits into (hi, lo) with hi carrying 12 significant
    bits, so every hi*hi product is exact in f32 (12+12 <= 24-bit mantissa);
  * the main terms sum through branchless Knuth TwoSum chains, the small
    parts accumulate separately;
  * one final TwoSum gives A + r with |r| <= ulp(A), and
    exp(a) = exp(A) * (1 + r).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..transfer import to_device
from .cells import CellArrays
from .spectra import MomentumGridDevice, SpeciesArrays


def _two_sum(x, y):
    """Branchless Knuth TwoSum: s + err == x + y exactly (6 flops), as long
    as no operation is fused or reassociated (true for eager torch ops)."""
    s = x + y
    b = s - x
    return s, (x - (s - b)) + (y - b)


def _split12(x64: torch.Tensor):
    """Split f64 -> (hi, lo) f32 with hi carrying 12 significant bits, so
    products of two hi parts are exact in f32."""
    h = x64.to(torch.float32)
    hi = (h.view(torch.int32) & -4096).view(torch.float32)   # 0xFFFFF000
    lo = (x64 - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def fold_eta_quadrature(cells: CellArrays, grid: MomentumGridDevice,
                        cfg: Config, strict: bool = False):
    """Fold the symmetric 2+1d eta quadrature onto half the nodes.

    At y = 0 the CF integrand splits into even and odd parts in eta.  The
    odd part -- sourced by un/dan (linear rows) and pitn/pixn/piyn/Vn --
    cancels pairwise over symmetric nodes, so evaluating only the even part
    on the eta >= 0 half-nodes with doubled weights reproduces the full
    quadrature while halving the eta loop.

    Exactness gate (returns inputs unchanged when any fails):
      * cfg.dimension == 2 and cfg.eta_fold != 0 and >= 2 nodes;
      * the node/weight table is symmetric;
      * un == 0 everywhere (u.p sits inside exp: its odd part must vanish
        pointwise, not just in the sum);
      * dan == 0 OR every active odd delta-f source (pitn/pixn/piyn when
        shear df is on, Vn when baryon diffusion is on) is zero -- the
        odd(dan)*odd(df) product is even in eta and survives the quadrature;
      * outflow off OR dan == 0 (Theta(p.dsigma) is pointwise nonlinear);
      * delta-f regulation off OR all active odd delta-f sources zero.
    The even part is selected by zeroing dan/pitn/pixn/piyn/Vn on the copy
    of ``cells`` used for this engine call; un is exactly zero by the gate.
    The six maxima come from the host columns where ``cells`` carries them
    (cells.HostFacts: the same values, nothing read back from the device).

    ``strict=True`` is the gate for the nonlinear feqmod integrand
    (feq(|A^-1 p_LRF|/T_mod) is not linear in the odd sources, so they
    cannot be zeroed away): it folds only when every odd source is exactly
    zero, as on every physical boost-invariant surface.  The integrand is
    then pointwise even, and the outflow/regulation sub-gates do not matter.

    Returns (cells, grid, folded: bool).
    """
    if cfg.eta_fold == 0 or cfg.dimension != 2:
        return cells, grid, False
    folded = fold_eta_table(grid)
    if folded is None:
        return cells, grid, False

    if cells.host is not None:
        mx = list(cells.host.odd_max)
    else:   # one device->host read for all six maxima
        mx = torch.stack([f.abs().max() for f in
                          (cells.un, cells.dan, cells.pitn, cells.pixn,
                           cells.piyn, cells.Vn)]).cpu().tolist()
    un_mx, dan_mx, pitn_mx, pixn_mx, piyn_mx, vn_mx = mx
    if strict:
        if max(mx) != 0.0:
            return cells, grid, False
    else:
        if un_mx != 0.0:
            return cells, grid, False
        odd_df = 0.0
        if cfg.include_shear_deltaf:
            odd_df = max(pitn_mx, pixn_mx, piyn_mx)
        if cfg.include_baryon and cfg.include_baryondiff_deltaf:
            odd_df = max(odd_df, vn_mx)
        if dan_mx != 0.0 and odd_df != 0.0:
            return cells, grid, False
        if cfg.outflow and dan_mx != 0.0:
            return cells, grid, False
        if cfg.regulate_deltaf and odd_df != 0.0:
            return cells, grid, False

    if not strict:  # strict mode checked that the odd sources are zero
        zeros = torch.zeros_like(cells.dan)
        cells = dataclasses.replace(cells, dan=zeros, pitn=zeros, pixn=zeros,
                                    piyn=zeros, Vn=zeros)
    return cells, folded, True


def fold_eta_table(grid: MomentumGridDevice) -> MomentumGridDevice | None:
    """The eta >= 0 half of a symmetric node and weight table with doubled
    weights, or None for fewer than 2 nodes or a table that is not
    symmetric.  The table half of every eta fold (the spectra's above, the
    polarization's in core/polarization.py); what a fold may drop of the
    integrand is each caller's own gate.  It reads the grid's host copy of
    the table where it has one."""
    if grid.host_eta is not None:
        eta, w = grid.host_eta
    else:
        eta = grid.eta.cpu().numpy()
        w = grid.eta_weight.cpu().numpy()
    n = eta.shape[0]
    if n < 2:
        return None
    order = np.argsort(eta)
    es, ws = eta[order], w[order]
    if not (np.allclose(es, -es[::-1], rtol=0.0, atol=1e-14)
            and np.allclose(ws, ws[::-1], rtol=1e-14)):
        return None
    half = n // 2
    fold_eta = es[half + (n % 2):]
    fold_w = 2.0 * ws[half + (n % 2):]
    if n % 2:  # a zero node pairs with itself: keep its original weight
        fold_eta = np.concatenate([[0.0], fold_eta])
        fold_w = np.concatenate([[ws[half]], fold_w])
    dev = grid.eta.device
    out = dataclasses.replace(grid, eta=to_device(fold_eta, dev),
                              eta_weight=to_device(fold_w, dev))
    out.host_eta = (fold_eta, fold_w)
    return out


# ----------------------------------------------------------------------
# 3+1d rows (the port's copies of is3d2_tpu/core/spectra_fast.py:76-164
# and :401-458), in f64; the pack of kernel B1's 3+1d mode casts them
# ----------------------------------------------------------------------

def momentum_matrix_3d(species: SpeciesArrays,
                       grid: MomentumGridDevice) -> dict:
    """3+1d f64 rows of the momenta m = (species, pT, y, phi): the
    light-cone m+ = mT e^y and m- = mT e^-y, px, py, mass^2, baryon number
    and sign.  In the light-cone basis p^tau = a m+ + b m- with the cell's
    a = e^-eta / 2, b = e^eta / 2 is a sum of positives, where a cosh/sinh
    basis cancels ~e^(|y| + |eta|) down to O(1) in f32.

    The JAX package orders m as (species, pT, phi, y); here y comes before
    phi, so that m+, m-, mass^2, b and sign are constant along each run of
    Nphi momenta (kernel B1's register tile takes consecutive phi of one
    row)."""
    S, NpT = species.mass.shape[0], grid.pT.shape[0]
    Ny, Nphi = grid.y.shape[0], grid.cos_phi.shape[0]
    shape = (S, NpT, Ny, Nphi)
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)

    def flat(a):
        return a.expand(shape).reshape(-1)

    return {
        "mp": flat((mT[:, :, None] * torch.exp(grid.y)[None, None, :])
                   [:, :, :, None]),
        "px": flat((grid.pT[:, None] * grid.cos_phi[None, :])[None, :, None]),
        "py": flat((grid.pT[:, None] * grid.sin_phi[None, :])[None, :, None]),
        "mm": flat((mT[:, :, None] * torch.exp(-grid.y)[None, None, :])
                   [:, :, :, None]),
        "mass2": flat((species.mass ** 2)[:, None, None, None]),
        "b": flat(species.baryon[:, None, None, None]),
        "sgn": flat(species.sign[:, None, None, None]),
    }


def momentum_matrix_3d_comp(species: SpeciesArrays,
                            grid: MomentumGridDevice) -> dict:
    """momentum_matrix_3d with the 12-bit splits (``<row>1``, ``<row>2``)
    of m+, px, py and m- for the compensated argument, and their f64
    values as ``<row>f``."""
    rows = momentum_matrix_3d(species, grid)
    out = {k: rows[k] for k in ("mass2", "b", "sgn")}
    for name in ("mp", "px", "py", "mm"):
        out[name + "1"], out[name + "2"] = _split12(rows[name])
        out[name + "f"] = rows[name]
    return out


def _cell_Q_3d(cells: CellArrays, coeffs: dict) -> dict:
    """Per-cell f64 contraction rows in the light-cone basis (m+, px, py,
    m-): p^tau = a m+ + b m-, tau p^eta = a m+ - b m- with a = e^-eta / 2,
    b = e^eta / 2 of the cell's eta.  Q_E (u.p), Q_d (p.dsigma), Q_pi
    (pi^munu p_mu p_nu against m+m+, pxpx, pypy, m-m-, m+px, m+py, m+m-,
    pxpy, px m-, py m-) and Q_V (V.p), then 1/T, alphaB, the mask and the
    delta-f coefficients."""
    c = cells
    tau = c.tau
    tau2 = tau * tau
    a = 0.5 * torch.exp(-c.eta)
    b = 0.5 * torch.exp(c.eta)
    # u.p: the coefficient of m+ is a (ut - tau un), of m- b (ut + tau un),
    # both sums of like-signed terms
    tun = tau * c.un
    Q_E = torch.stack([a * (c.ut - tun), -c.ux, -c.uy, b * (c.ut + tun)], 1)
    dan_t = c.dan / tau
    Q_d = torch.stack([a * (c.dat + dan_t), c.dax, c.day,
                       b * (c.dat - dan_t)], 1)
    # quadratic coefficients against (p^tau, px, py, tau p^eta) ...
    k1, k2, k3, k4 = c.pitt, c.pixx, c.piyy, tau2 * c.pinn
    k5, k6, k7 = -2.0 * c.pitx, -2.0 * c.pity, -2.0 * tau * c.pitn
    k8, k9, k10 = 2.0 * c.pixy, 2.0 * tau * c.pixn, 2.0 * tau * c.piyn
    # ... in the light-cone basis
    Q_pi = torch.stack([a * a * (k1 + k4 + k7), k2, k3, b * b * (k1 + k4 - k7),
                        a * (k5 + k9), a * (k6 + k10), 2.0 * a * b * (k1 - k4),
                        k8, b * (k5 - k9), b * (k6 - k10)], 1)
    tVn = tau * c.Vn
    Q_V = torch.stack([a * (c.Vt - tVn), -c.Vx, -c.Vy, b * (c.Vt + tVn)], 1)
    return {"Q_E": Q_E, "Q_d": Q_d, "Q_pi": Q_pi, "Q_V": Q_V,
            "invT": 1.0 / c.T, "alphaB": c.alphaB, "mask": c.mask, **coeffs}


def _cell_Q_3d_comp(cells: CellArrays, coeffs: dict) -> dict:
    """_cell_Q_3d plus the 12-bit splits of the u.p / T light-cone
    coefficients (qp: m+, qx, qy, qm: m-) and of alphaB (abf, abl), and T.
    There is no eta loop to fold hyperbolics into: the cell's eta lives in
    the rows, so the compensated argument is one TwoSum chain over four
    exact products and -abf b."""
    q = _cell_Q_3d(cells, coeffs)
    invT = q["invT"]
    for name, k in (("qp", 0), ("qx", 1), ("qy", 2), ("qm", 3)):
        q[name + "1"], q[name + "2"] = _split12(q["Q_E"][:, k] * invT)
    q["abf"], q["abl"] = _split12(cells.alphaB)
    q["Tf"] = cells.T
    return q
