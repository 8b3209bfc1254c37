"""Per-cell modified-equilibrium (feqmod) state for df modes 3/4.

Counterpart of is3d2_tpu/core/feqmod.py (the per-cell feqmod preamble of
MomentumSpectra.cpp:632-826 and EmissionFunction.cpp:33-109) on f64 tensors
of the run's device:

  * the momentum-transformation matrix A = (1 + bulk_mod) I + shear_mod pi_LRF,
    its determinant and inverse, and detA_bulk^{2/3} = (1 + bulk_mod)^2;
  * the breakdown test (detA <= detA_min, negative linearised pion density
    for PTM, z < 0 for PTB);
  * the modified temperature and chemical potential (PTM);
  * the per-(cell, species) renormalisation n_linear / n_mod (PTM) or z (PTB).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..constants import two_pi2_hbarC3
from ..io.tables import GaussLaguerre
from ..physics import lrf, thermal
from ..physics.deltaf import DeltafData
from .cells import CellArrays, evaluate_cell_deltaf
from .spectra import SpeciesArrays

f64 = torch.float64

# (cells x species x Gauss-Laguerre points) f64 elements of one PTM
# renormalisation block: bounds its ~10 live intermediates to ~32 MB each
_RENORM_BLOCK_ELEMENTS = 1 << 22


@dataclasses.dataclass
class FeqmodCellData:
    """Per-cell feqmod quantities (all shape (c,) f64 unless noted)."""

    # LRF basis (needed to project momenta)
    Xt: torch.Tensor
    Xx: torch.Tensor
    Xy: torch.Tensor
    Xn: torch.Tensor
    Yx: torch.Tensor
    Yy: torch.Tensor
    Zt: torch.Tensor
    Zn: torch.Tensor
    # A matrix (symmetric) and inverse
    Axx: torch.Tensor
    Axy: torch.Tensor
    Axz: torch.Tensor
    Ayy: torch.Tensor
    Ayz: torch.Tensor
    Azz: torch.Tensor
    Ainv: torch.Tensor          # (c, 3, 3)
    detA: torch.Tensor
    detA_bulk_23: torch.Tensor  # (1 + bulk_mod)^2
    eta_scale: torch.Tensor
    breaks_down: torch.Tensor   # bool (c,)
    T_mod: torch.Tensor
    alphaB_mod: torch.Tensor
    # linearised-df coefficient columns for the breakdown branch
    shear_coeff: torch.Tensor
    bulk0: torch.Tensor
    bulk1: torch.Tensor
    bulk2: torch.Tensor
    # PTB linearised coefficients
    delta_z: torch.Tensor
    delta_lambda: torch.Tensor
    # regulated bulk pressure actually used
    bulkPi: torch.Tensor
    betaV: torch.Tensor
    z: torch.Tensor
    renorm: torch.Tensor        # (c, S) renormalisation including the detA division


def _sym3_inverse(Axx, Axy, Axz, Ayy, Ayz, Azz, detA):
    """Adjugate inverse of a symmetric 3x3 (the reference's GSL LU inverse,
    MomentumSpectra.cpp:729-747; identical result in exact arithmetic)."""
    c00 = Ayy * Azz - Ayz * Ayz
    c01 = Axz * Ayz - Axy * Azz
    c02 = Axy * Ayz - Axz * Ayy
    c11 = Axx * Azz - Axz * Axz
    c12 = Axy * Axz - Axx * Ayz
    c22 = Axx * Ayy - Axy * Axy
    inv = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c01, c11, c12], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return inv / detA[:, None, None]


def pion0_density_negative(T, bulkPi, F, betabulk, mass_pion0,
                           laguerre: GaussLaguerre):
    """Linearised pion0 density < 0 breakdown test
    (EmissionFunction.cpp:52-97), vectorised over cells."""
    r1, w1 = laguerre.roots[1], laguerre.weights[1]
    r2, w2 = laguerre.roots[2], laguerre.weights[2]
    mbar = mass_pion0 / T
    zero = torch.zeros_like(T)
    bose = -torch.ones_like(T)
    neq_fact = T**3 / two_pi2_hbarC3
    J20_fact = T * neq_fact
    neq = neq_fact * thermal.neq_integral(r1, w1, mbar, zero, zero, bose)
    J20 = J20_fact * thermal.J20_integral(r2, w2, mbar, zero, zero, bose)
    dn = bulkPi * (neq + J20 * F / (T * T)) / betabulk
    return (neq + dn) < 0.0


def _renorm_ptm(c: CellArrays, species: SpeciesArrays, T_mod, alphaB_mod,
                bulkPi, df, laguerre: GaussLaguerre) -> torch.Tensor:
    """PTM per-(cell, species) renormalisation n_linear / n_mod
    (MomentumSpectra.cpp:790-826): four (cells x species x 32)-point
    Gauss-Laguerre quadratures, blocked over cells.

    The JAX package computes this in f64 on the host, except for its f32
    fast path, which moved it to an f32 device computation because host f64
    took minutes at 1e4+ cells.  Here it is f64 on the run's device for
    every compute_dtype: one path, at least as exact as either, and fast on
    a GPU."""
    r1, w1 = laguerre.roots[1], laguerre.weights[1]
    r2, w2 = laguerre.roots[2], laguerre.weights[2]
    S = species.mass.shape[0]
    g = species.degeneracy[None, :]
    b = species.baryon[None, :]
    sgn = species.sign[None, :]
    C = c.n_padded
    blk = max(1, min(C, _RENORM_BLOCK_ELEMENTS // (S * r1.shape[0])))
    out = []
    for i in range(0, C, blk):
        T = c.T[i:i + blk, None]
        Tm = T_mod[i:i + blk, None]
        aB = c.alphaB[i:i + blk, None]
        aB_mod = alphaB_mod[i:i + blk, None]
        mbar = species.mass[None, :] / T
        mbar_mod = species.mass[None, :] / Tm
        neq_fact = T**3 / two_pi2_hbarC3
        J20_fact = T**4 / two_pi2_hbarC3
        nmod_fact = Tm**3 / two_pi2_hbarC3
        neq = neq_fact * g * thermal.neq_integral(r1, w1, mbar, aB, b, sgn)
        N10 = b * neq_fact * g * thermal.J10_integral(r1, w1, mbar, aB, b, sgn)
        J20 = J20_fact * g * thermal.J20_integral(r2, w2, mbar, aB, b, sgn)
        dn_fact = (bulkPi / df.betabulk)[i:i + blk, None]
        n_linear = neq + dn_fact * (neq + N10 * df.G[i:i + blk, None]
                                    + J20 * df.F[i:i + blk, None] / T**2)
        n_mod = nmod_fact * g * thermal.neq_integral(r1, w1, mbar_mod, aB_mod,
                                                     b, sgn)
        out.append(n_linear / n_mod)
    return torch.cat(out)


def prepare_feqmod(cells: CellArrays, species: SpeciesArrays,
                   df_data: DeltafData, cfg: Config,
                   laguerre: GaussLaguerre) -> FeqmodCellData:
    """The per-cell feqmod state of a df 3/4 run, in f64 on the cells'
    device.  2+1d rescales eta by detA / (1 + bulk_mod)^2 and divides the
    renormalisation by (1 + bulk_mod)^2; 3+1d has no eta rescale and
    divides it by detA (MomentumSpectra.cpp:766-773, 826)."""
    if cfg.df_mode not in (3, 4):
        raise ValueError("prepare_feqmod implements df 3/4")
    c = cells
    df = evaluate_cell_deltaf(c, df_data, cfg)   # bulkPi clamped for PTB
    bulkPi = c.bulkPi
    if cfg.df_mode == 4:
        bulkPi = df_data.regulate_bulkPi_ptb(bulkPi, c.P)

    basis = lrf.milne_basis(c.tau, c.ux, c.uy, c.un)
    pi = lrf.boost_shear(basis, c.tau, c.pitt, c.pitx, c.pity, c.pitn,
                         c.pixx, c.pixy, c.pixn, c.piyy, c.piyn, c.pinn)

    if cfg.df_mode == 3:
        T_mod = c.T + bulkPi * df.F / df.betabulk
        alphaB_mod = c.alphaB + bulkPi * df.G / df.betabulk
        bulk_mod = bulkPi / (3.0 * df.betabulk)
    else:
        T_mod = c.T
        alphaB_mod = c.alphaB
        bulk_mod = df.lam

    shear_mod = 0.5 / df.betapi

    Axx = 1.0 + pi.xx * shear_mod + bulk_mod
    Axy = pi.xy * shear_mod
    Axz = pi.xz * shear_mod
    Ayy = 1.0 + pi.yy * shear_mod + bulk_mod
    Ayz = pi.yz * shear_mod
    Azz = 1.0 + pi.zz * shear_mod + bulk_mod

    detA = (Axx * (Ayy * Azz - Ayz * Ayz) - Axy * (Axy * Azz - Ayz * Axz)
            + Axz * (Axy * Ayz - Ayy * Axz))
    detA_bulk_23 = (1.0 + bulk_mod) ** 2

    # breakdown predicate (does_feqmod_breakdown, EmissionFunction.cpp:65-109)
    if cfg.df_mode == 3:
        pion_neg = pion0_density_negative(c.T, bulkPi, df.F, df.betabulk,
                                          cfg.mass_pion0, laguerre)
        breaks = (detA <= cfg.deta_min) | pion_neg
    else:
        breaks = (detA <= cfg.deta_min) | (df.z < 0.0)

    # eta rescaling (2+1d narrow (y-eta) trick, MomentumSpectra.cpp:766-773)
    if cfg.dimension == 2:
        eta_scale = torch.where(detA > cfg.deta_min, detA / detA_bulk_23, 1.0)
    else:
        eta_scale = torch.ones_like(detA)

    # guard detA for the inverse (and the 3+1d renorm) on broken-down cells
    # (their branch is masked out)
    detA_safe = torch.where(detA.abs() > 1e-300, detA, 1.0)
    Ainv = _sym3_inverse(Axx, Axy, Axz, Ayy, Ayz, Azz, detA_safe)

    # per-(cell, species) renormalisation (MomentumSpectra.cpp:790-826)
    S = species.mass.shape[0]
    if not cfg.include_bulk_deltaf:
        renorm = torch.ones((c.n_padded, S), dtype=f64, device=c.T.device)
    elif cfg.df_mode == 3:
        renorm = _renorm_ptm(c, species, T_mod, alphaB_mod, bulkPi, df,
                             laguerre)
    else:
        renorm = df.z[:, None].expand(c.n_padded, S)
    if cfg.dimension == 2:
        renorm = renorm / detA_bulk_23[:, None]
    else:
        renorm = renorm / detA_safe[:, None]

    # linearised-df columns for the breakdown branch (MomentumSpectra.cpp:676-680)
    shear_coeff = 0.5 / (df.betapi * c.T)
    bulk0 = df.F / (c.T * c.T * df.betabulk)
    bulk1 = df.G / df.betabulk
    bulk2 = 1.0 / (3.0 * c.T * df.betabulk)

    return FeqmodCellData(
        Xt=basis.Xt, Xx=basis.Xx, Xy=basis.Xy, Xn=basis.Xn,
        Yx=basis.Yx, Yy=basis.Yy, Zt=basis.Zt, Zn=basis.Zn,
        Axx=Axx, Axy=Axy, Axz=Axz, Ayy=Ayy, Ayz=Ayz, Azz=Azz,
        Ainv=Ainv, detA=detA, detA_bulk_23=detA_bulk_23, eta_scale=eta_scale,
        breaks_down=breaks, T_mod=T_mod, alphaB_mod=alphaB_mod,
        shear_coeff=shear_coeff, bulk0=bulk0, bulk1=bulk1, bulk2=bulk2,
        delta_z=df.delta_z, delta_lambda=df.delta_lambda, bulkPi=bulkPi,
        betaV=df.betaV, z=df.z, renorm=renorm,
    )
