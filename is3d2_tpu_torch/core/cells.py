"""Per-cell tensors for the Cooper-Frye engines.

Counterpart of is3d2_tpu/core/cells.py: flattens the freezeout surface into
padded f64 tensors on the run's device, completes the shear tensor and the
diffusion time component, and computes the cell validity masks (the
reference's per-cell preamble, MomentumSpectra.cpp:109-246, as one pass).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..io.surface import SurfaceData
from ..physics import lrf
from ..physics.deltaf import DeltafCoefficients, DeltafData


@dataclasses.dataclass
class CellArrays:
    """Padded per-cell f64 tensors (length rounded up to a block multiple).

    ``mask`` is 1.0 for real cells with u.dsigma > 0 (the reference skips
    u.dsigma <= 0 cells, MomentumSpectra.cpp:132) and 0.0 for padding;
    ``pad_mask`` is 1.0 for every real cell, which the polarization sums
    over (it keeps the u.dsigma <= 0 cells), and 0.0 for padding.  The
    spectra and the sampler read ``mask`` only.
    """

    mask: torch.Tensor
    pad_mask: torch.Tensor
    tau: torch.Tensor
    x: torch.Tensor        # cell position (the sampler's particle rows)
    y_pos: torch.Tensor
    eta: torch.Tensor
    dat: torch.Tensor
    dax: torch.Tensor
    day: torch.Tensor
    dan: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    un: torch.Tensor
    ut: torch.Tensor
    T: torch.Tensor
    P: torch.Tensor
    E: torch.Tensor
    # completed shear tensor (zeros when shear is off)
    pitt: torch.Tensor
    pitx: torch.Tensor
    pity: torch.Tensor
    pitn: torch.Tensor
    pixx: torch.Tensor
    pixy: torch.Tensor
    pixn: torch.Tensor
    piyy: torch.Tensor
    piyn: torch.Tensor
    pinn: torch.Tensor
    bulkPi: torch.Tensor
    muB: torch.Tensor
    alphaB: torch.Tensor
    Vt: torch.Tensor
    Vx: torch.Tensor
    Vy: torch.Tensor
    Vn: torch.Tensor
    baryon_enthalpy_ratio: torch.Tensor
    # thermal vorticity (zeros unless the surface is mode 5)
    wtx: torch.Tensor
    wty: torch.Tensor
    wtn: torch.Tensor
    wxy: torch.Tensor
    wxn: torch.Tensor
    wyn: torch.Tensor

    @property
    def n_padded(self) -> int:
        return self.tau.shape[0]


_VORTICITY = ("wtx", "wty", "wtn", "wxy", "wxn", "wyn")


def _pad(a: np.ndarray, n_pad: int, fill: float = 0.0) -> np.ndarray:
    if n_pad == 0:
        return a
    return np.concatenate([a, np.full(n_pad, fill, dtype=a.dtype)])


def prepare_cells(surf: SurfaceData, cfg: Config, device,
                  block: int | None = None) -> CellArrays:
    """Build padded per-cell tensors on ``device`` from a surface.

    The padding is host numpy (as in the JAX package); the shear completion
    runs in torch f64 on the host, so its bits do not depend on the device.
    """
    n = surf.n_cells
    block = block or cfg.cell_block
    n_padded = ((n + block - 1) // block) * block
    pad = n_padded - n

    tau = _pad(surf.tau, pad, 1.0)
    ux = _pad(surf.ux, pad)
    uy = _pad(surf.uy, pad)
    un = _pad(surf.un, pad)
    ut = np.sqrt(1.0 + ux**2 + uy**2 + (tau * un) ** 2)

    dat = _pad(surf.dat, pad)
    dax = _pad(surf.dax, pad)
    day = _pad(surf.day, pad)
    dan = _pad(surf.dan, pad)

    udsigma = ut * dat + ux * dax + uy * day + un * dan
    mask = (udsigma > 0.0).astype(np.float64)
    mask[n:] = 0.0
    pad_mask = np.ones(n_padded)
    pad_mask[n:] = 0.0

    # pad T with a safe temperature to keep exp() finite on padding cells
    T = _pad(surf.T, pad, 0.15)
    P = _pad(surf.P, pad, 0.08)
    E = _pad(surf.E, pad, 0.25)

    zeros = np.zeros(n_padded)
    if cfg.include_shear_deltaf:
        pixx = _pad(surf.pixx, pad)
        pixy = _pad(surf.pixy, pad)
        pixn = _pad(surf.pixn, pad)
        piyy = _pad(surf.piyy, pad)
        piyn = _pad(surf.piyn, pad)
        h = torch.from_numpy
        pitt, pitx, pity, pitn, pinn = (v.numpy() for v in lrf.complete_shear(
            h(tau), h(ux), h(uy), h(un), h(pixx), h(pixy), h(pixn),
            h(piyy), h(piyn)))
    else:
        pixx = pixy = pixn = piyy = piyn = zeros
        pitt = pitx = pity = pitn = pinn = zeros

    bulkPi = _pad(surf.bulkPi, pad) if cfg.include_bulk_deltaf else zeros

    if cfg.include_baryon and cfg.include_baryondiff_deltaf:
        muB = _pad(surf.muB, pad)
        nB = _pad(surf.nB, pad)
        Vx = _pad(surf.Vx, pad)
        Vy = _pad(surf.Vy, pad)
        Vn = _pad(surf.Vn, pad)
        Vt = (Vx * ux + Vy * uy + Vn * tau**2 * un) / ut
        alphaB = muB / T
        ratio = nB / (E + P)
    elif cfg.include_baryon:
        muB = _pad(surf.muB, pad)
        alphaB = muB / T
        Vt = Vx = Vy = Vn = ratio = zeros
    else:
        muB = alphaB = zeros
        Vt = Vx = Vy = Vn = ratio = zeros

    def j(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device)

    return CellArrays(
        mask=j(mask), pad_mask=j(pad_mask), tau=j(tau), x=j(_pad(surf.x, pad)),
        y_pos=j(_pad(surf.y, pad)), eta=j(_pad(surf.eta, pad)), dat=j(dat), dax=j(dax), day=j(day),
        dan=j(dan), ux=j(ux), uy=j(uy), un=j(un), ut=j(ut), T=j(T), P=j(P),
        E=j(E), pitt=j(pitt), pitx=j(pitx), pity=j(pity), pitn=j(pitn),
        pixx=j(pixx), pixy=j(pixy), pixn=j(pixn), piyy=j(piyy), piyn=j(piyn),
        pinn=j(pinn), bulkPi=j(bulkPi), muB=j(muB), alphaB=j(alphaB),
        Vt=j(Vt), Vx=j(Vx), Vy=j(Vy), Vn=j(Vn), baryon_enthalpy_ratio=j(ratio),
        **{f: j(_pad(getattr(surf, f), pad)) for f in _VORTICITY},
    )


def evaluate_cell_deltaf(cells: CellArrays, df_data: DeltafData,
                         cfg: Config) -> DeltafCoefficients:
    """Per-cell delta-f coefficients (with PTB bulk clamping where needed)."""
    bulkPi = cells.bulkPi
    if cfg.df_mode == 4:
        bulkPi = df_data.regulate_bulkPi_ptb(bulkPi, cells.P)
    return df_data.evaluate(cells.T, cells.muB, cells.E, cells.P, bulkPi)
