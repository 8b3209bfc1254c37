"""Operand packing for the compensated Cooper-Frye kernel, and the f32c
spectra entry point.

Counterpart of is3d2_tpu/ops/spectra_fast_common.py::pack_inputs_comp and
compute_spectra_pallas(dot_impl="comp").  Every split is prepared in f64 on
the run's device with the same column meanings as the JAX pack; the layout
is the one the CUDA kernel reads (see ops/cooper_frye_comp.py).  Nothing is
padded: the kernel masks the ragged ends itself.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.cells import CellArrays
from ..core.spectra import PREFACTOR, MomentumGridDevice, SpeciesArrays
from ..core.spectra_fast import _split12, fold_eta_quadrature
from .cooper_frye_comp import CELL_COLS, MOM_ROWS, cooper_frye_comp

f32 = torch.float32
f64 = torch.float64


@dataclasses.dataclass
class CompOperands:
    """The kernel's operands (see ops/cooper_frye_comp.py)."""

    cell: torch.Tensor    # (C, 32) f32
    qm: torch.Tensor      # (C, Ne, 2) f32
    eta: torch.Tensor     # (Ne, 2) f32
    eta_w: torch.Tensor   # (Ne,) f64
    mom: torch.Tensor     # (12, M) f32

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x eta x M."""
        return self.cell.shape[0] * self.eta.shape[0] * self.mom.shape[1]


def pack_inputs_comp(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                     grid: MomentumGridDevice, cfg: Config) -> CompOperands:
    c = cells
    tau = c.tau
    tau2 = tau * tau
    invT = 1.0 / c.T
    qx1, qx2 = _split12(-c.ux * invT)
    qy1, qy2 = _split12(-c.uy * invT)
    abf, abl = _split12(c.alphaB)
    cols = {
        "qx1": qx1, "qx2": qx2, "qy1": qy1, "qy2": qy2, "abf": abf, "abl": abl,
        "Tf": c.T,
        **{k: coeffs[k] for k in ("shear", "bulk0", "bulk1", "bulk2",
                                  "diff0", "diff1")},
        # p.dsigma rows against (mT cosh, px, py, mT sinh), mask folded in
        "qd0": c.dat * c.mask, "qd1": c.dax * c.mask, "qd2": c.day * c.mask,
        "qd3": c.dan / tau * c.mask,
        # V.p rows
        "qv0": c.Vt, "qv1": -c.Vx, "qv2": -c.Vy, "qv3": -tau * c.Vn,
        # pi^munu p_mu p_nu against the ten quadratics of (m1, px, py, m4)
        "qpi0": c.pitt, "qpi1": c.pixx, "qpi2": c.piyy, "qpi3": tau2 * c.pinn,
        "qpi4": -2.0 * c.pitx, "qpi5": -2.0 * c.pity, "qpi6": -2.0 * tau * c.pitn,
        "qpi7": 2.0 * c.pixy, "qpi8": 2.0 * tau * c.pixn, "qpi9": 2.0 * tau * c.piyn,
        "unused": torch.zeros_like(tau),
    }
    cell = torch.stack([cols[k].to(f32) for k in CELL_COLS], dim=1).contiguous()

    # per-(cell, eta) split E/T coefficient of mT (y = 0: Delta = -eta)
    cosh_e = torch.cosh(grid.eta)[None, :]
    sinh_e = -torch.sinh(grid.eta)[None, :]
    qm64 = (c.ut[:, None] * cosh_e - (tau * c.un)[:, None] * sinh_e) * invT[:, None]
    qm = torch.stack(_split12(qm64), dim=2).contiguous()          # (C, Ne, 2)
    eta = torch.stack([cosh_e[0], sinh_e[0]], dim=1).to(f32).contiguous()

    # momentum rows, m = (species, pT, phi)
    S = species.mass.shape[0]
    NpT = grid.pT.shape[0]
    Nphi = grid.cos_phi.shape[0]
    shape = (S, NpT, Nphi)
    mT64 = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)

    def flat(a):
        return a.expand(shape).reshape(-1)

    mT = flat(mT64[:, :, None])
    px = flat((grid.pT[:, None] * grid.cos_phi[None, :])[None])
    py = flat((grid.pT[:, None] * grid.sin_phi[None, :])[None])
    mT1, mT2 = _split12(mT)
    px1, px2 = _split12(px)
    py1, py2 = _split12(py)
    rows = {"mT1": mT1, "mT2": mT2, "mTf": mT, "px1": px1, "px2": px2,
            "pxf": px, "py1": py1, "py2": py2, "pyf": py,
            "mass2": flat((species.mass ** 2)[:, None, None]),
            "b": flat(species.baryon[:, None, None]),
            "sgn": flat(species.sign[:, None, None])}
    mom = torch.stack([rows[k].to(f32) for k in MOM_ROWS]).contiguous()
    return CompOperands(cell=cell, qm=qm, eta=eta,
                        eta_w=grid.eta_weight.to(f64).contiguous(), mom=mom)


def comp_operands(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                  grid: MomentumGridDevice, cfg: Config) -> CompOperands:
    """Fold the eta quadrature where exact, then pack."""
    if cfg.dimension != 2 or cfg.df_mode not in (1, 2):
        raise ValueError("the compensated kernel implements 2+1d df 1/2")
    cells, grid, _ = fold_eta_quadrature(cells, grid, cfg)
    return pack_inputs_comp(cells, coeffs, species, grid, cfg)


def compute_spectra_comp(cells: CellArrays, coeffs: dict,
                         species: SpeciesArrays, grid: MomentumGridDevice,
                         cfg: Config) -> torch.Tensor:
    """f32c spectra through the compensated kernel: (S, NpT, Nphi, 1) f64."""
    ops = comp_operands(cells, coeffs, species, grid, cfg)
    flat = cooper_frye_comp(ops.cell, ops.qm, ops.eta, ops.eta_w, ops.mom, cfg)
    out = flat.reshape(species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)
    return PREFACTOR * species.degeneracy[:, None, None, None] * out
