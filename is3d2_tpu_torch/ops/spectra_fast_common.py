"""Operand packing for the df-1/2 Cooper-Frye kernels, and their spectra
entry points.

Counterparts of is3d2_tpu/ops/spectra_fast_common.py: ``pack_inputs_comp``
and ``compute_spectra_comp`` for the compensated kernel B1
(``compute_spectra_pallas(dot_impl="comp")``), ``pack_inputs`` and
``compute_spectra_f32`` for the plain-f32 kernel B2 (its non-comp branch).
Every column is prepared in f64 on the run's device with the same meanings
as the JAX packs and cast once to f32; the layouts are the ones the CUDA
kernels read (see ops/cooper_frye_comp.py and ops/cooper_frye_f32.py).
Nothing is padded: the kernels mask the ragged ends themselves.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.cells import CellArrays
from ..core.spectra import PREFACTOR, MomentumGridDevice, SpeciesArrays
from ..core.spectra_fast import _split12, fold_eta_quadrature
from . import cooper_frye_f32 as b2
from .cooper_frye_comp import CELL_COLS, MOM_ROWS, cooper_frye_comp

f32 = torch.float32
f64 = torch.float64


@dataclasses.dataclass
class CompOperands:
    """Kernel B1's operands (see ops/cooper_frye_comp.py)."""

    cell: torch.Tensor    # (C, 32) f32
    qm: torch.Tensor      # (C, Ne, 2) f32
    eta: torch.Tensor     # (Ne, 2) f32
    eta_w: torch.Tensor   # (Ne,) f64
    mom: torch.Tensor     # (12, M) f32
    row_len: int          # Nphi: momenta per (species, pT) row of mom

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x eta x M."""
        return self.cell.shape[0] * self.eta.shape[0] * self.mom.shape[1]

    def args(self) -> tuple:
        return self.cell, self.qm, self.eta, self.eta_w, self.mom


@dataclasses.dataclass
class F32Operands:
    """Kernel B2's operands (see ops/cooper_frye_f32.py)."""

    cell: torch.Tensor    # (C, 32) f32
    eta: torch.Tensor     # (Ne, 2) f32
    eta_w: torch.Tensor   # (Ne,) f64
    mom: torch.Tensor     # (6, M) f32
    row_len: int          # Nphi: momenta per (species, pT) row of mom

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x eta x M."""
        return self.cell.shape[0] * self.eta.shape[0] * self.mom.shape[1]

    def args(self) -> tuple:
        return self.cell, self.eta, self.eta_w, self.mom


def _linear_cols(c: CellArrays, coeffs: dict) -> dict:
    """The f64 columns both packs share: the delta-f coefficients, p.dsigma
    (mask folded in), V.p and pi^munu p_mu p_nu against (mT cosh, px, py,
    -mT sinh) and its ten quadratics."""
    tau = c.tau
    tau2 = tau * tau
    return {
        **{k: coeffs[k] for k in ("shear", "bulk0", "bulk1", "bulk2",
                                  "diff0", "diff1")},
        "qd0": c.dat * c.mask, "qd1": c.dax * c.mask, "qd2": c.day * c.mask,
        "qd3": c.dan / tau * c.mask,
        "qv0": c.Vt, "qv1": -c.Vx, "qv2": -c.Vy, "qv3": -tau * c.Vn,
        "qpi0": c.pitt, "qpi1": c.pixx, "qpi2": c.piyy, "qpi3": tau2 * c.pinn,
        "qpi4": -2.0 * c.pitx, "qpi5": -2.0 * c.pity, "qpi6": -2.0 * tau * c.pitn,
        "qpi7": 2.0 * c.pixy, "qpi8": 2.0 * tau * c.pixn, "qpi9": 2.0 * tau * c.piyn,
    }


def _momentum_rows(species: SpeciesArrays, grid: MomentumGridDevice) -> dict:
    """f64 rows of m = (species, pT, phi): mT, px, py, mass2, b, sgn."""
    S = species.mass.shape[0]
    shape = (S, grid.pT.shape[0], grid.cos_phi.shape[0])
    mT64 = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)

    def flat(a):
        return a.expand(shape).reshape(-1)

    return {"mT": flat(mT64[:, :, None]),
            "px": flat((grid.pT[:, None] * grid.cos_phi[None, :])[None]),
            "py": flat((grid.pT[:, None] * grid.sin_phi[None, :])[None]),
            "mass2": flat((species.mass ** 2)[:, None, None]),
            "b": flat(species.baryon[:, None, None]),
            "sgn": flat(species.sign[:, None, None])}


def _eta_rows(grid: MomentumGridDevice):
    """(Ne, 2) f32 cosh(eta), -sinh(eta) (y = 0: Delta = -eta) and the f64
    weights."""
    eta = torch.stack([torch.cosh(grid.eta), -torch.sinh(grid.eta)], dim=1)
    return eta.to(f32).contiguous(), grid.eta_weight.to(f64).contiguous()


def pack_inputs_comp(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                     grid: MomentumGridDevice, cfg: Config) -> CompOperands:
    c = cells
    invT = 1.0 / c.T
    qx1, qx2 = _split12(-c.ux * invT)
    qy1, qy2 = _split12(-c.uy * invT)
    abf, abl = _split12(c.alphaB)
    cols = {
        "qx1": qx1, "qx2": qx2, "qy1": qy1, "qy2": qy2, "abf": abf, "abl": abl,
        "Tf": c.T, **_linear_cols(c, coeffs),
        "unused": torch.zeros_like(c.tau),
    }
    cell = torch.stack([cols[k].to(f32) for k in CELL_COLS], dim=1).contiguous()

    # per-(cell, eta) split E/T coefficient of mT (y = 0: Delta = -eta)
    cosh_e = torch.cosh(grid.eta)[None, :]
    sinh_e = -torch.sinh(grid.eta)[None, :]
    qm64 = (c.ut[:, None] * cosh_e - (c.tau * c.un)[:, None] * sinh_e) * invT[:, None]
    qm = torch.stack(_split12(qm64), dim=2).contiguous()          # (C, Ne, 2)
    eta, eta_w = _eta_rows(grid)

    p = _momentum_rows(species, grid)
    mT1, mT2 = _split12(p["mT"])
    px1, px2 = _split12(p["px"])
    py1, py2 = _split12(p["py"])
    rows = {"mT1": mT1, "mT2": mT2, "mTf": p["mT"], "px1": px1, "px2": px2,
            "pxf": p["px"], "py1": py1, "py2": py2, "pyf": p["py"],
            "mass2": p["mass2"], "b": p["b"], "sgn": p["sgn"]}
    mom = torch.stack([rows[k].to(f32) for k in MOM_ROWS]).contiguous()
    return CompOperands(cell=cell, qm=qm, eta=eta, eta_w=eta_w, mom=mom,
                        row_len=grid.cos_phi.shape[0])


def pack_inputs(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                grid: MomentumGridDevice, cfg: Config) -> F32Operands:
    """Kernel B2's operands: the columns of the JAX pack_inputs (Q_E, Q_d
    with the mask folded in, Q_pi, Q_V, then 1/T, alphaB and the delta-f
    coefficients) without its tile padding."""
    c = cells
    zero = torch.zeros_like(c.tau)
    cols = {"qe0": c.ut, "qe1": -c.ux, "qe2": -c.uy, "qe3": -c.tau * c.un,
            "invT": 1.0 / c.T, "alphaB": c.alphaB, **_linear_cols(c, coeffs),
            "unused0": zero, "unused1": zero}
    cell = torch.stack([cols[k].to(f32) for k in b2.CELL_COLS],
                       dim=1).contiguous()
    eta, eta_w = _eta_rows(grid)
    p = _momentum_rows(species, grid)
    mom = torch.stack([p[k].to(f32) for k in b2.MOM_ROWS]).contiguous()
    return F32Operands(cell=cell, eta=eta, eta_w=eta_w, mom=mom,
                       row_len=grid.cos_phi.shape[0])


def _fold(cells: CellArrays, grid: MomentumGridDevice, cfg: Config, what: str):
    if cfg.dimension != 2 or cfg.df_mode not in (1, 2):
        raise ValueError(f"the {what} kernel implements 2+1d df 1/2")
    cells, grid, _ = fold_eta_quadrature(cells, grid, cfg)
    return cells, grid


def comp_operands(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                  grid: MomentumGridDevice, cfg: Config) -> CompOperands:
    """Fold the eta quadrature where exact, then pack for kernel B1."""
    cells, grid = _fold(cells, grid, cfg, "compensated")
    return pack_inputs_comp(cells, coeffs, species, grid, cfg)


def f32_operands(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                 grid: MomentumGridDevice, cfg: Config) -> F32Operands:
    """Fold the eta quadrature where exact, then pack for kernel B2."""
    cells, grid = _fold(cells, grid, cfg, "plain-f32")
    return pack_inputs(cells, coeffs, species, grid, cfg)


def _spectra(flat: torch.Tensor, species: SpeciesArrays,
             grid: MomentumGridDevice) -> torch.Tensor:
    out = flat.reshape(species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)
    return PREFACTOR * species.degeneracy[:, None, None, None] * out


def compute_spectra_comp(cells: CellArrays, coeffs: dict,
                         species: SpeciesArrays, grid: MomentumGridDevice,
                         cfg: Config) -> torch.Tensor:
    """f32c spectra through the compensated kernel B1: (S, NpT, Nphi, 1)
    f64."""
    ops = comp_operands(cells, coeffs, species, grid, cfg)
    return _spectra(cooper_frye_comp(*ops.args(), cfg, row_len=ops.row_len),
                    species, grid)


def compute_spectra_f32(cells: CellArrays, coeffs: dict,
                        species: SpeciesArrays, grid: MomentumGridDevice,
                        cfg: Config) -> torch.Tensor:
    """Plain-f32 spectra through kernel B2: (S, NpT, Nphi, 1) f64."""
    ops = f32_operands(cells, coeffs, species, grid, cfg)
    return _spectra(b2.cooper_frye_f32(*ops.args(), cfg, row_len=ops.row_len),
                    species, grid)
