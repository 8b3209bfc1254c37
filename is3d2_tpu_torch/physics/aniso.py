"""Anisotropic (VAH) variable reconstruction and famod coefficients.

Counterpart of is3d2_tpu/physics/aniso.py (the reference's
src/cpp/AnisoVariables.cpp): the 3D Newton solve
F(Lambda, a_T, a_L) = (I_200 - E, I_201 - P_T, I_220 - P_L) = 0 with the
analytic Jacobian and Numerical-Recipes line backtracking, batched over
cells from the equilibrium guess, and the famod shear/diffusion
coefficients beta_{pi,perp}, beta_{W,perp}.

The JAX module's two while_loops are Python loops here.  Each lane's
values depend only on its own state and a lane that is done stays frozen,
so the Newton iterates on the lanes not yet done alone (gathered once per
iteration, scattered back), and the per-lane results and the iteration
count are the JAX loop's, which runs every lane until all are done.  The
count of lanes left is read back once per Newton iteration and the
all-returned flag once per backtracking round: each read stands in for
(cells x species x quadrature) work on frozen lanes.

Everything runs in f64 on the device, on every route (the callers in
core/spectra_famod.py make it so).  The 16-point generalized
Gauss-Laguerre families (AnisoVariables.h:17-121) are regenerated with
scipy.special.roots_genlaguerre, as the JAX module does.
"""

from __future__ import annotations

import dataclasses

import torch
from scipy.special import roots_genlaguerre

from ..constants import four_pi2_hbarC3

N_MAX = 30              # max Newton iterations (AnisoVariables.h:5)
PARTIAL_BACKTRACKS = 20
TOL_DX = 1.0e-4
TOL_F = 1.0e-4
DELTA = 0.01            # Taylor window for the hypergeometric t-functions
PBAR_PTS = 16

_FAMILIES = {a: roots_genlaguerre(PBAR_PTS, a) for a in (1, 2, 3)}


def laguerre(a: int, like: torch.Tensor):
    """(roots, weights) of the 16-point family with alpha = ``a`` in the
    dtype and on the device of ``like``."""
    r, w = _FAMILIES[a]
    return (torch.as_tensor(r, dtype=like.dtype, device=like.device),
            torch.as_tensor(w, dtype=like.dtype, device=like.device))


def _t_functions_200(z):
    """t_200, t_220, t_201 hypergeometric functions with the |z| <= 0.01
    Taylor branch (AnisoVariables.cpp:64-95)."""
    z_safe_pos = torch.where(z > DELTA, z, 1.0)
    sqrtz = torch.sqrt(z_safe_pos)
    t_pos = torch.arctan(sqrtz) / sqrtz

    z_safe_neg = torch.where((z < -DELTA) & (z > -1.0), z, -0.5)
    sqrtmz = torch.sqrt(-z_safe_neg)
    t_neg = torch.arctanh(sqrtmz) / sqrtmz

    t = torch.where(z > DELTA, t_pos, t_neg)
    zs = torch.where(torch.abs(z) <= DELTA, 1.0, z)  # avoid /0 in exact branches

    t200_e = 1.0 + (1.0 + z) * t
    t220_e = (-1.0 + (1.0 + z) * t) / zs
    t201_e = (1.0 + (z - 1.0) * t) / zs

    z2 = z * z
    z3 = z2 * z
    z4 = z3 * z
    z5 = z4 * z
    z6 = z5 * z
    t200_t = (2. + 0.6666666666666667 * z - 0.1333333333333333 * z2
              + 0.05714285714285716 * z3 - 0.031746031746031744 * z4
              + 0.020202020202020193 * z5 - 0.013986013986013984 * z6)
    t220_t = (0.6666666666666667 - 0.1333333333333333 * z
              + 0.05714285714285716 * z2 - 0.031746031746031744 * z3
              + 0.020202020202020193 * z4 - 0.013986013986013984 * z5
              + 0.010256410256410262 * z6)
    t201_t = (1.3333333333333333 - 0.5333333333333333 * z
              + 0.34285714285714286 * z2 - 0.25396825396825395 * z3
              + 0.20202020202020202 * z4 - 0.16783216783216784 * z5
              + 0.14358974358974358 * z6)

    taylor = torch.abs(z) <= DELTA
    return (torch.where(taylor, t200_t, t200_e),
            torch.where(taylor, t220_t, t220_e),
            torch.where(taylor, t201_t, t201_e))


def _t_functions_400(z):
    """t_402, t_421, t_440 with the |z| <= 0.01 Taylor branch
    (AnisoVariables.cpp:201-245)."""
    z_safe_pos = torch.where(z > DELTA, z, 1.0)
    sqrtz = torch.sqrt(z_safe_pos)
    t_pos = torch.arctan(sqrtz) / sqrtz
    z_safe_neg = torch.where((z < -DELTA) & (z > -1.0), z, -0.5)
    sqrtmz = torch.sqrt(-z_safe_neg)
    t_neg = torch.arctanh(sqrtmz) / sqrtmz
    t = torch.where(z > DELTA, t_pos, t_neg)

    z2 = z * z
    zs2 = torch.where(torch.abs(z) <= DELTA, 1.0, z2)

    t402_e = (3. * (z - 1.) + (z * (3. * z - 2.) + 3.) * t) / (4. * zs2)
    t421_e = (3. + z + (1. + z) * (z - 3.) * t) / (4. * zs2)
    t440_e = (-(3. + 5. * z) + 3. * (z + 1.) * (z + 1.) * t) / (4. * zs2)

    z3 = z2 * z
    z4 = z3 * z
    z5 = z4 * z
    z6 = z5 * z
    t402_t = (1.0666666666666667 - 0.4571428571428572 * z
              + 0.3047619047619048 * z2 - 0.23088023088023088 * z3
              + 0.1864801864801865 * z4 - 0.15664335664335666 * z5
              + 0.13514328808446457 * z6)
    t421_t = (0.2666666666666666 - 0.0761904761904762 * z
              + 0.0380952380952381 * z2 - 0.023088023088023088 * z3
              + 0.015540015540015537 * z4 - 0.011188811188811189 * z5
              + 0.00844645550527904 * z6)
    t440_t = (0.4 - 0.057142857142857106 * z + 0.019047619047619063 * z2
              - 0.008658008658008663 * z3 + 0.004662004662004657 * z4
              - 0.002797202797202792 * z5 + 0.0018099547511312257 * z6)

    taylor = torch.abs(z) <= DELTA
    return (torch.where(taylor, t402_t, t402_e),
            torch.where(taylor, t421_t, t421_e),
            torch.where(taylor, t440_t, t440_e))


def _valid_degeneracy(mass, degeneracy):
    """(1, n, 1) degeneracy with massless species (photons) masked out."""
    return (degeneracy * (mass > 0.0))[None, :, None]


def compute_F(X, Ea, PTa, PLa, mass, sign, degeneracy):
    """F(X) = (I_200 - E, I_201 - P_T, I_220 - P_L), batched over cells.

    X: (c, 3) = (lambda, aT, aL); mass/sign/degeneracy: (n,) species
    tensors.  AnisoVariables.cpp:15-131."""
    lam, aT, aL = X[:, 0], X[:, 1], X[:, 2]
    aT2 = aT * aT
    aL2 = aL * aL
    common = aT2 * aL * lam**4 / four_pi2_hbarC3

    mbar = mass[None, :] / lam[:, None]                           # (c,n)
    mbar2 = mbar * mbar
    r, wq = laguerre(2, X)
    p = r[None, None, :]                                          # (1,1,q)
    w_q = wq[None, None, :]

    Ebar = torch.sqrt(p * p + mbar2[:, :, None])
    w = torch.sqrt(aL2[:, None, None] + mbar2[:, :, None] / (p * p))
    z = (aT2 - aL2)[:, None, None] / (w * w)
    t200, t220, t201 = _t_functions_200(z)

    # overflow-safe: exp(p)/(exp(E)+s) = exp(p-E)/(1+s exp(-E))
    cw = p * w_q * torch.exp(p - Ebar) / (1.0 + sign[None, :, None]
                                          * torch.exp(-Ebar))
    g = _valid_degeneracy(mass, degeneracy)

    I200 = torch.sum(g * cw * t200 * w, dim=(1, 2)) * common
    I220 = torch.sum(g * cw * t220 / w, dim=(1, 2)) * common * aL2
    I201 = torch.sum(g * cw * t201 / w, dim=(1, 2)) * common * aT2 / 2.0
    return torch.stack([I200 - Ea, I201 - PTa, I220 - PLa], dim=-1)


def compute_J(X, F, Ea, PTa, PLa, mass, sign, degeneracy):
    """Analytic Jacobian (AnisoVariables.cpp:134-299), batched: (c, 3, 3)."""
    lam, aT, aL = X[:, 0], X[:, 1], X[:, 2]
    aT2 = aT * aT
    aL2 = aL * aL
    lam2 = lam * lam
    lam3 = lam2 * lam
    lam_aT3 = lam * aT2 * aT
    lam_aL3 = lam * aL2 * aL
    common = aT2 * aL * lam2 * lam3 / four_pi2_hbarC3

    mbar = mass[None, :] / lam[:, None]
    mbar2 = mbar * mbar
    r, wq = laguerre(3, X)
    p = r[None, None, :]
    w_q = wq[None, None, :]
    p2 = p * p

    Ebar = torch.sqrt(p2 + mbar2[:, :, None])
    w = torch.sqrt(aL2[:, None, None] + mbar2[:, :, None] / p2)
    z = (aT2 - aL2)[:, None, None] / (w * w)

    t200, t220, t201 = _t_functions_200(z)
    t402, t421, t440 = _t_functions_400(z)

    # overflow-safe: exp(p+E)/(exp(E)+s)^2 = exp(p-E)/(1+s exp(-E))^2
    d = 1.0 + sign[None, :, None] * torch.exp(-Ebar)
    cw = w_q * torch.exp(p - Ebar) / (d * d)
    g = _valid_degeneracy(mass, degeneracy)

    def total(a):
        return torch.sum(a, dim=(1, 2))

    J2001 = total(g * Ebar * cw * t200 * w) * common
    J2011 = total(g * Ebar * cw * t201 / w) * common * aT2 / 2.0
    J2201 = total(g * Ebar * cw * t220 / w) * common * aL2
    J402m1 = total(g * p2 / Ebar * cw * t402 / w) * common * aT2 * aT2 / 8.0
    J421m1 = total(g * p2 / Ebar * cw * t421 / w) * common * aT2 * aL2 / 2.0
    J440m1 = total(g * p2 / Ebar * cw * t440 / w) * common * aL2 * aL2

    Eai = F[:, 0] + Ea
    PTai = F[:, 1] + PTa
    PLai = F[:, 2] + PLa

    row0 = torch.stack([J2001 / lam2, 2.0 * (Eai + PTai) / aT,
                        (Eai + PLai) / aL], dim=-1)
    row1 = torch.stack([J2011 / lam2, 4.0 * J402m1 / lam_aT3,
                        J421m1 / lam_aL3], dim=-1)
    row2 = torch.stack([J2201 / lam2, 2.0 * J421m1 / lam_aT3,
                        J440m1 / lam_aL3], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _solve3x3(A, b):
    """Batched 3x3 solve via the adjugate (Cramer), as the JAX module
    solves it."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    c00 = a11 * a22 - a12 * a21
    c10 = a02 * a21 - a01 * a22
    c20 = a01 * a12 - a02 * a11
    det = a00 * c00 + a10 * c10 + a20 * c20
    inv_det = 1.0 / det
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = ((a12 * a20 - a10 * a22) * b0 + (a00 * a22 - a02 * a20) * b1
          + (a02 * a10 - a00 * a12) * b2) * inv_det
    x2 = ((a10 * a21 - a11 * a20) * b0 + (a01 * a20 - a00 * a21) * b1
          + (a00 * a11 - a01 * a10) * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def _line_backtrack(X, dX, dX_abs, g0, Fargs):
    """Batched Numerical-Recipes line search (AnisoVariables.cpp:302-390).

    Returns (l, F(X + l dX)).  Lanes that returned keep their values
    frozen; the rounds stop when every lane returned (read before each
    round's F evaluation) or after PARTIAL_BACKTRACKS rounds."""
    gprime0 = -2.0 * g0
    alpha = 1.0e-4

    F1 = compute_F(X + dX, *Fargs)
    f = 0.5 * torch.sum(F1 * F1, dim=-1)
    Fcur = F1
    l = torch.ones_like(g0)
    lprev = torch.zeros_like(g0)
    fprev = torch.zeros_like(g0)
    returned = torch.zeros_like(g0, dtype=torch.bool)

    for n in range(PARTIAL_BACKTRACKS):
        ret_now = (l * dX_abs <= TOL_DX) | (f <= g0 + l * alpha * gprime0)
        returned = returned | ret_now
        if bool(returned.all()):
            break   # the round would leave every lane as it is

        # quadratic model on the first round, cubic afterwards
        ll = torch.where(l == 0.0, 1.0, l)
        lp = torch.where(lprev == 0.0, 1.0, lprev)
        dl = torch.where(torch.abs(ll - lp) > 0.0, ll - lp, 1.0)
        if n == 0:
            lroot = -gprime0 / (2.0 * (f - g0 - gprime0))
        else:
            a = ((f - g0 - ll * gprime0) / (ll * ll)
                 - (fprev - g0 - lp * gprime0) / (lp * lp)) / dl
            b = (-lp * (f - g0 - ll * gprime0) / (ll * ll)
                 + ll * (fprev - g0 - lp * gprime0) / (lp * lp)) / dl
            zq = b * b - 3.0 * a * gprime0
            a_safe = torch.where(a == 0.0, 1.0, a)
            sq = torch.sqrt(torch.abs(zq))
            lroot = torch.where(
                a == 0.0, -gprime0 / (2.0 * torch.where(b == 0.0, 1.0, b)),
                torch.where(zq < 0.0, 0.5 * ll,
                            torch.where(b <= 0.0, (-b + sq) / (3.0 * a_safe),
                                        -gprime0 / (b + sq))))
            lroot = torch.minimum(lroot, 0.5 * ll)
        l_new = torch.maximum(lroot, 0.5 * l)

        Fn = compute_F(X + l_new[:, None] * dX, *Fargs)
        fn = 0.5 * torch.sum(Fn * Fn, dim=-1)

        lprev = torch.where(returned, lprev, l)
        fprev = torch.where(returned, fprev, f)
        l = torch.where(returned, l, l_new)
        f = torch.where(returned, f, fn)
        Fcur = torch.where(returned[:, None], Fcur, Fn)
    return l, Fcur


@dataclasses.dataclass
class AnisoSolution:
    lam: torch.Tensor
    aT: torch.Tensor
    aL: torch.Tensor
    failed: torch.Tensor  # bool (c,)
    iterations: int       # Newton iterations the loop ran
    lane_iterations: int  # lanes iterated, summed over the iterations


def find_anisotropic_variables(E, pl, pt, lam0, aT0, aL0,
                               mass, sign, degeneracy) -> AnisoSolution:
    """Batched Newton solve (AnisoVariables.cpp:393-538).

    E, pl, pt: (c,) energy density and longitudinal / transverse pressure;
    lam0, aT0, aL0: (c,) initial guesses; species tensors: the (<= 320)
    PDG entries the reference uses (MomentumSpectra.cpp:1295).  Failed
    lanes keep the initial guess, as the reference returns it."""
    Fargs = (E, pt, pl, mass, sign, degeneracy)

    X = torch.stack([lam0, aT0, aL0], dim=-1)
    done = (E < 0) | (pt < 0) | (pl < 0)
    converged = torch.zeros_like(done)
    F = compute_F(X, *Fargs)
    stepmax = 100.0 * torch.clamp(torch.sqrt(torch.sum(X * X, dim=-1)),
                                  min=3.0)

    n = lanes = 0
    while n < N_MAX:
        live = torch.nonzero(~done).squeeze(1)   # one read per iteration
        if live.numel() == 0:
            break
        lanes += live.numel()
        Xa, Fa = X[live], F[live]
        args = (E[live], pt[live], pl[live], mass, sign, degeneracy)
        J = compute_J(Xa, Fa, *args)
        f = 0.5 * torch.sum(Fa * Fa, dim=-1)
        dX = _solve3x3(J, -Fa)
        dX_abs = torch.sqrt(torch.sum(dX * dX, dim=-1))
        smax = stepmax[live]
        rescale = torch.where(dX_abs > smax, smax / dX_abs, 1.0)
        dX = dX * rescale[:, None]
        dX_abs = torch.minimum(dX_abs, smax)

        l, F_new = _line_backtrack(Xa, dX, dX_abs, f, args)
        X_new = Xa + l[:, None] * dX
        F_abs = torch.sqrt(torch.sum(F_new * F_new, dim=-1))
        dX_abs = dX_abs * l

        went_negative = torch.any(X_new < 0.0, dim=-1)
        conv_now = (dX_abs <= TOL_DX) & (F_abs <= TOL_F)

        X[live] = X_new
        F[live] = F_new
        converged[live] = conv_now & ~went_negative
        done[live] = went_negative | conv_now
        n += 1

    failed = ~converged
    return AnisoSolution(lam=torch.where(failed, lam0, X[:, 0]),
                         aT=torch.where(failed, aT0, X[:, 1]),
                         aL=torch.where(failed, aL0, X[:, 2]),
                         failed=failed, iterations=n, lane_iterations=lanes)


def compute_famod_coefficients(lam, aT, aL, mass, sign, degeneracy):
    """beta_{pi,perp}, beta_{W,perp} (AnisoVariables.cpp:541-643), batched
    (the JAX module's mixed_precision=False)."""
    aT2 = aT * aT
    aL2 = aL * aL
    lam2 = lam * lam
    common = aT2 * aL * lam * lam2 * lam2 / four_pi2_hbarC3

    mbar = mass[None, :] / lam[:, None]
    mbar2 = mbar * mbar
    r, wq = laguerre(3, lam)
    p = r[None, None, :]
    w_q = wq[None, None, :]
    p2 = p * p

    Ebar = torch.sqrt(p2 + mbar2[:, :, None])
    w = torch.sqrt(aL2[:, None, None] + mbar2[:, :, None] / p2)
    z = (aT2 - aL2)[:, None, None] / (w * w)
    t402, t421, _ = _t_functions_400(z)

    d = 1.0 + sign[None, :, None] * torch.exp(-Ebar)
    cw = w_q * torch.exp(p - Ebar) / (d * d)
    g = _valid_degeneracy(mass, degeneracy)

    # quadrature sum, then species sum (the JAX module's order)
    q402 = torch.sum(g * p2 / Ebar * cw * t402 / w, dim=2)       # (c, n)
    q421 = torch.sum(g * p2 / Ebar * cw * t421 / w, dim=2)
    J402m1 = torch.sum(q402, dim=1) * common * aT2 * aT2 / 8.0
    J421m1 = torch.sum(q421, dim=1) * common * aT2 * aL2 / 2.0

    betapiperp = J402m1 / (aT2 * lam)
    betaWperp = J421m1 / (aT * aL * lam)
    return betapiperp, betaWperp


def aniso_density_integral(lam, mass, sign, chem=0.0):
    """I_100 anisotropic density integral over the a = 1 Laguerre family
    (ParticleSampler.cpp:1484-1494), batched over (cells, species);
    ``chem``: a number or a (cells, species) tensor."""
    r, wq = laguerre(1, lam)
    p = r[None, None, :]
    w_q = wq[None, None, :]
    mbar = mass[None, :] / lam[:, None]
    Ebar = torch.sqrt(p * p + mbar[:, :, None] ** 2)
    chem_b = torch.as_tensor(chem, dtype=lam.dtype,
                             device=lam.device).expand(mbar.shape)[:, :, None]
    return torch.sum(w_q * p * torch.exp(p - Ebar - chem_b)
                     / (1.0 + sign[None, :, None] * torch.exp(-Ebar - chem_b)),
                     dim=-1)
