"""Helpers of the compensated-f32 ("f32c") spectra path.

Counterpart of the f32c pieces of is3d2_tpu/core/spectra_fast.py: the eta
quadrature fold with its exactness gates (df 1/2, and the strict one of the
feqmod kernel), and the split-exact arithmetic.

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
from .cells import CellArrays
from .spectra import MomentumGridDevice


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

    ``strict=True`` is the gate for the nonlinear feqmod integrand
    (feq(|A^-1 p_LRF|/T_mod) is not linear in the odd sources, so they
    cannot be zeroed away): it folds only when every odd source is exactly
    zero, as on every physical boost-invariant surface.  The integrand is
    then pointwise even, and the outflow/regulation sub-gates do not matter.

    Returns (cells, grid, folded: bool).
    """
    if cfg.eta_fold == 0 or cfg.dimension != 2:
        return cells, grid, False
    eta = grid.eta.cpu().numpy()
    w = grid.eta_weight.cpu().numpy()
    n = eta.shape[0]
    if n < 2:
        return cells, grid, False
    order = np.argsort(eta)
    es, ws = eta[order], w[order]
    if not (np.allclose(es, -es[::-1], rtol=0.0, atol=1e-14)
            and np.allclose(ws, ws[::-1], rtol=1e-14)):
        return cells, grid, False

    # one device->host read for all six maxima
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

    half = n // 2
    fold_eta = es[half + (n % 2):]
    fold_w = 2.0 * ws[half + (n % 2):]
    if n % 2:  # a zero node pairs with itself: keep its original weight
        fold_eta = np.concatenate([[0.0], fold_eta])
        fold_w = np.concatenate([[ws[half]], fold_w])

    if not strict:  # strict mode checked that the odd sources are zero
        zeros = torch.zeros_like(cells.dan)
        cells = dataclasses.replace(cells, dan=zeros, pitn=zeros, pixn=zeros,
                                    piyn=zeros, Vn=zeros)
    dev = grid.eta.device
    grid = dataclasses.replace(
        grid,
        eta=torch.as_tensor(fold_eta, dtype=torch.float64, device=dev),
        eta_weight=torch.as_tensor(fold_w, dtype=torch.float64, device=dev))
    return cells, grid, True
