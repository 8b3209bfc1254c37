"""Local-rest-frame kinematics, batched over freezeout cells.

Counterpart of is3d2_tpu/physics/lrf.py (src/cpp/LocalRestFrame.cpp and the
per-cell shear completion of MomentumSpectra.cpp:149-161), as functions of
tensors of shape (n_cells,): f64 for the engines, the invariant checks and
the sampler's prep, f32 for the sampler's per-hadron lab boost.
"""

from __future__ import annotations

import dataclasses

import torch


def u_time_component(tau, ux, uy, un):
    """u^tau from normalization u.u = 1."""
    return torch.sqrt(1.0 + ux * ux + uy * uy + (tau * un) ** 2)


def complete_shear(tau, ux, uy, un, pixx, pixy, pixn, piyy, piyn):
    """Reconstruct (pitt, pitx, pity, pitn, pinn) from the 5 stored components
    enforcing pi.u = 0 and Tr pi = 0 (MomentumSpectra.cpp:149-161)."""
    tau2 = tau * tau
    ut = u_time_component(tau, ux, uy, un)
    ut2 = ut * ut
    ux2 = ux * ux
    uy2 = uy * uy
    utperp2 = 1.0 + ux2 + uy2
    tau2_un = tau2 * un
    pinn = (pixx * (ux2 - ut2) + piyy * (uy2 - ut2)
            + 2.0 * (pixy * ux * uy + tau2_un * (pixn * ux + piyn * uy))) \
        / (tau2 * utperp2)
    pitn = (pixn * ux + piyn * uy + tau2_un * pinn) / ut
    pity = (pixy * ux + piyy * uy + tau2_un * piyn) / ut
    pitx = (pixx * ux + pixy * uy + tau2_un * pixn) / ut
    pitt = (pitx * ux + pity * uy + tau2_un * pitn) / ut
    return pitt, pitx, pity, pitn, pinn


def orthogonal_time_component(tau, ux, uy, un, Vx, Vy, Vn):
    """V^tau from orthogonality V.u = 0 (MomentumSpectra.cpp:183)."""
    tau2 = tau * tau
    ut = u_time_component(tau, ux, uy, un)
    return (Vx * ux + Vy * uy + Vn * tau2 * un) / ut


@dataclasses.dataclass
class MilneBasis:
    """Orthonormal tetrad (U, X, Y, Z) in Milne coordinates
    (LocalRestFrame.cpp:12-41).  Components not listed are zero."""

    Xt: torch.Tensor
    Xx: torch.Tensor
    Xy: torch.Tensor
    Xn: torch.Tensor
    Yx: torch.Tensor
    Yy: torch.Tensor
    Zt: torch.Tensor
    Zn: torch.Tensor


def milne_basis(tau, ux, uy, un) -> MilneBasis:
    ut = u_time_component(tau, ux, uy, un)
    uperp = torch.sqrt(ux * ux + uy * uy)
    utperp = torch.sqrt(1.0 + ux * ux + uy * uy)

    sinhL = tau * un / utperp
    coshL = ut / utperp

    # uperp -> 0 guard (LocalRestFrame.cpp:33-40)
    safe = uperp > 1.0e-5
    inv_uperp = torch.where(safe, 1.0 / torch.where(safe, uperp, 1.0), 0.0)

    Xt = uperp * coshL
    Xx = torch.where(safe, utperp * ux * inv_uperp, 1.0)
    Xy = torch.where(safe, utperp * uy * inv_uperp, 0.0)
    Xn = uperp * sinhL / tau

    Yx = torch.where(safe, -uy * inv_uperp, 0.0)
    Yy = torch.where(safe, ux * inv_uperp, 1.0)

    Zt = sinhL
    Zn = coshL / tau
    return MilneBasis(Xt=Xt, Xx=Xx, Xy=Xy, Xn=Xn, Yx=Yx, Yy=Yy, Zt=Zt, Zn=Zn)


@dataclasses.dataclass
class DsigmaLRF:
    """Surface element boosted to the LRF (LocalRestFrame.cpp:81-98)."""

    t: torch.Tensor          # u.dsigma
    x: torch.Tensor          # -X.dsigma
    y: torch.Tensor
    z: torch.Tensor
    space: torch.Tensor      # |ds_space|
    magnitude: torch.Tensor  # |u.ds| + |ds_space| (max volume element)


def boost_dsigma(basis: MilneBasis, tau, ux, uy, un,
                 dat, dax, day, dan) -> DsigmaLRF:
    ut = u_time_component(tau, ux, uy, un)
    dst = dat * ut + dax * ux + day * uy + dan * un
    dsx = -(dat * basis.Xt + dax * basis.Xx + day * basis.Xy + dan * basis.Xn)
    dsy = -(dax * basis.Yx + day * basis.Yy)
    dsz = -(dat * basis.Zt + dan * basis.Zn)
    space = torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz)
    return DsigmaLRF(t=dst, x=dsx, y=dsy, z=dsz, space=space,
                     magnitude=torch.abs(dst) + space)


@dataclasses.dataclass
class ShearLRF:
    """pi^munu LRF components piij = Xi.pi.Xj (LocalRestFrame.cpp:133-154)."""

    xx: torch.Tensor
    xy: torch.Tensor
    xz: torch.Tensor
    yy: torch.Tensor
    yz: torch.Tensor
    zz: torch.Tensor


def boost_shear(basis: MilneBasis, tau, pitt, pitx, pity, pitn,
                pixx, pixy, pixn, piyy, piyn, pinn) -> ShearLRF:
    tau2 = tau * tau
    Xt, Xx, Xy, Xn = basis.Xt, basis.Xx, basis.Xy, basis.Xn
    Yx, Yy = basis.Yx, basis.Yy
    Zt, Zn = basis.Zt, basis.Zn

    pixx_lrf = (pitt * Xt * Xt + pixx * Xx * Xx + piyy * Xy * Xy
                + tau2 * tau2 * pinn * Xn * Xn
                + 2.0 * (-Xt * (pitx * Xx + pity * Xy) + pixy * Xx * Xy
                         + tau2 * Xn * (pixn * Xx + piyn * Xy - pitn * Xt)))
    pixy_lrf = (Yx * (-pitx * Xt + pixx * Xx + pixy * Xy + tau2 * pixn * Xn)
                + Yy * (-pity * Xt + pixy * Xx + piyy * Xy + tau2 * piyn * Xn))
    pixz_lrf = (Zt * (pitt * Xt - pitx * Xx - pity * Xy - tau2 * pitn * Xn)
                - tau2 * Zn * (pitn * Xt - pixn * Xx - piyn * Xy - tau2 * pinn * Xn))
    piyy_lrf = pixx * Yx * Yx + 2.0 * pixy * Yx * Yy + piyy * Yy * Yy
    piyz_lrf = -Zt * (pitx * Yx + pity * Yy) + tau2 * Zn * (pixn * Yx + piyn * Yy)
    pizz_lrf = -(pixx_lrf + piyy_lrf)
    return ShearLRF(xx=pixx_lrf, xy=pixy_lrf, xz=pixz_lrf,
                    yy=piyy_lrf, yz=piyz_lrf, zz=pizz_lrf)


def boost_diffusion(basis: MilneBasis, tau, Vt, Vx, Vy, Vn):
    """V^mu LRF components (LocalRestFrame.cpp:173-185)."""
    tau2 = tau * tau
    Vx_lrf = -Vt * basis.Xt + Vx * basis.Xx + Vy * basis.Xy + tau2 * Vn * basis.Xn
    Vy_lrf = Vx * basis.Yx + Vy * basis.Yy
    Vz_lrf = -Vt * basis.Zt + tau2 * Vn * basis.Zn
    return Vx_lrf, Vy_lrf, Vz_lrf


def boost_momentum_to_lab(basis: MilneBasis, tau, ux, uy, un, E, px, py, pz):
    """LRF momentum -> lab (Milne) components p^tau, p^x, p^y, p^eta
    (Momentum.cpp:14-31)."""
    ut = u_time_component(tau, ux, uy, un)
    ptau = E * ut + px * basis.Xt + pz * basis.Zt
    p_x = E * ux + px * basis.Xx + py * basis.Yx
    p_y = E * uy + px * basis.Xy + py * basis.Yy
    pn = E * un + px * basis.Xn + pz * basis.Zn
    return ptau, p_x, p_y, pn
