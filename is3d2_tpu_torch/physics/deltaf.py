"""Delta-f coefficient evaluation for df 1-5 (df 5 takes the
Chapman-Enskog coefficients, as df 2 and 3 do).

Counterpart of is3d2_tpu/physics/deltaf.py (Deltaf_Data,
src/cpp/DeltafData.cpp:220-519): cubic-spline (muB = 0) or bilinear
(T, muB) interpolation of the Grad-14 / Chapman-Enskog coefficient tables
with the temperature-power scaling undone, and the PTB (Jonah)
lambda^2(Pi/Peq), z(Pi/Peq) splines, on f64 tensors over the cell axis;
and the per-species densities at the surface-averaged (T, muB) that the
sampler's fast mode and yield estimate read (compute_particle_densities).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import two_pi2_hbarC3
from ..io.deltaf_tables import DeltafTables
from ..io.pdg import SpeciesTable
from ..io.surface import ThermoAverages
from ..io.tables import GaussLaguerre
from . import thermal
from .spline import CubicSpline

# lambda nodes of the PTB scan over [-1, 2] (DeltafData.cpp:220-295)
_JONAH_POINTS = 301


@dataclasses.dataclass
class DeltafCoefficients:
    """Per-cell coefficient tensors (the reference's deltaf_coefficients
    struct, readindata.h:93-119).  Unused entries for a df_mode are zeros."""

    # Grad 14-moment
    c0: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor
    c4: torch.Tensor
    shear14: torch.Tensor
    # Chapman-Enskog
    F: torch.Tensor
    G: torch.Tensor
    betabulk: torch.Tensor
    betaV: torch.Tensor
    betapi: torch.Tensor
    # PTB (Jonah)
    lam: torch.Tensor
    z: torch.Tensor
    delta_lambda: torch.Tensor
    delta_z: torch.Tensor


class DeltafData:
    """Interpolators over the delta-f coefficient tables."""

    def __init__(self, tables: DeltafTables, df_mode: int, include_baryon: bool):
        if df_mode not in (1, 2, 3, 4, 5):
            raise ValueError("df_mode must be in 1..5")
        self.tables = tables
        self.df_mode = df_mode
        self.include_baryon = include_baryon

        t = tables
        if not include_baryon:
            # cubic splines in T at muB = 0 (DeltafData.cpp:298-321)
            self._c0 = CubicSpline(t.T_grid, t.c0[0])
            self._c2 = CubicSpline(t.T_grid, t.c2[0])
            self._F = CubicSpline(t.T_grid, t.F[0])
            self._betabulk = CubicSpline(t.T_grid, t.betabulk[0])
            self._betapi = CubicSpline(t.T_grid, t.betapi[0])
        else:
            self._grids = {name: np.asarray(getattr(t, name))
                           for name in ("c0", "c1", "c2", "c3", "c4",
                                        "F", "G", "betabulk", "betaV", "betapi")}
            self._T_min = float(t.T_grid[0])
            self._muB_min = float(t.muB_grid[0])
            self._dT = float(abs(t.T_grid[1] - t.T_grid[0]))
            self._dmuB = float(abs(t.muB_grid[1] - t.muB_grid[0])) if t.points_muB > 1 else 1.0
            self._T_grid = np.asarray(t.T_grid)
            self._muB_grid = np.asarray(t.muB_grid)

        # PTB splines, set by compute_jonah_coefficients
        self._lambda_squared_spline: CubicSpline | None = None
        self._z_spline: CubicSpline | None = None
        self.bulkPi_over_Peq_max: float = -1.0

    # ------------------------------------------------------------------
    def compute_jonah_coefficients(self, species: SpeciesTable,
                                   laguerre: GaussLaguerre,
                                   plasma: ThermoAverages) -> None:
        """Scan lambda in [-1, 2] and build the lambda^2(Pi/Peq) and
        z(Pi/Peq) splines (DeltafData.cpp:220-295), in f64 on the host.
        Photons (mass 0) are skipped."""
        T = plasma.temperature
        keep = species.mass > 0.0

        def h(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64)

        mbar = h(species.mass[keep] / T)
        g = h(species.gspin[keep])
        sgn = h(species.sign[keep])
        roots2, weights2 = laguerre.roots[2], laguerre.weights[2]
        lam = np.linspace(-1.0, 2.0, _JONAH_POINTS)
        lam_t = h(lam)

        # (n_lambda, n_species) integrals; lambda = 0 gives the unmodified E, P
        E_mod = thermal.E_mod_integral(roots2, weights2, mbar[None, :],
                                       lam_t[:, None], sgn[None, :])
        P_mod = thermal.P_mod_integral(roots2, weights2, mbar[None, :],
                                       lam_t[:, None], sgn[None, :])
        zero = torch.zeros_like(mbar)
        E0 = thermal.E_mod_integral(roots2, weights2, mbar, zero, sgn)
        P0 = thermal.P_mod_integral(roots2, weights2, mbar, zero, sgn)

        E = float(torch.sum(g * E0))
        P = float(torch.sum(g * P0)) / 3.0
        E_mod_tot = torch.sum(g[None, :] * E_mod, dim=1).numpy()
        P_mod_tot = torch.sum(g[None, :] * P_mod, dim=1).numpy() / 3.0

        z = E / E_mod_tot
        bulkPi_over_Peq = (P_mod_tot / P) * z - 1.0

        self.bulkPi_over_Peq_max = float(np.max(bulkPi_over_Peq))
        self._lambda_squared_spline = CubicSpline(bulkPi_over_Peq, lam * lam)
        self._z_spline = CubicSpline(bulkPi_over_Peq, z)

    # ------------------------------------------------------------------
    def _bilinear(self, grid, T, muB):
        """Bilinear interpolation in (T, muB) on the uniform grid
        (DeltafData.cpp:404-441)."""
        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=T.device)

        grid = t(grid)
        iT = torch.clamp(torch.floor((T - self._T_min) / self._dT).to(torch.int64),
                         0, self.tables.points_T - 2)
        iB = torch.clamp(torch.floor((muB - self._muB_min) / self._dmuB).to(torch.int64),
                         0, max(self.tables.points_muB - 2, 0))
        T_grid = t(self._T_grid)
        muB_grid = t(self._muB_grid)
        TL = T_grid[iT]
        TR = T_grid[iT + 1]
        if self.tables.points_muB > 1:
            muBL = muB_grid[iB]
            muBR = muB_grid[iB + 1]
            f_LL = grid[iB, iT]
            f_LR = grid[iB + 1, iT]
            f_RL = grid[iB, iT + 1]
            f_RR = grid[iB + 1, iT + 1]
            return ((f_LL * (TR - T) + f_RL * (T - TL)) * (muBR - muB)
                    + (f_LR * (TR - T) + f_RR * (T - TL)) * (muB - muBL)) \
                / (self._dT * self._dmuB)
        f_L = grid[0, iT]
        f_R = grid[0, iT + 1]
        return (f_L * (TR - T) + f_R * (T - TL)) / self._dT

    def evaluate(self, T, muB, E, P, bulkPi) -> DeltafCoefficients:
        """Vectorized evaluate_df_coefficients (DeltafData.cpp:324-519) on
        per-cell f64 tensors; temperature-power scaling undone."""
        zeros = torch.zeros_like(T)
        c0 = c1 = c2 = c3 = c4 = shear14 = zeros
        F = G = betabulk = betapi = zeros
        betaV = torch.ones_like(T)
        lam = z = delta_lambda = delta_z = zeros

        T3 = T * T * T
        T4 = T3 * T
        T5 = T4 * T

        mode = self.df_mode
        if not self.include_baryon:
            if mode == 1:
                c0 = self._c0(T) / T4
                c2 = self._c2(T) / T4
                shear14 = 2.0 * T * T * (E + P)
            elif mode in (2, 3, 5):
                F = self._F(T) * T
                betabulk = self._betabulk(T) * T4
                betapi = self._betapi(T) * T4
            else:
                if self._lambda_squared_spline is None:
                    raise RuntimeError("PTB requires compute_jonah_coefficients first")
                x = bulkPi / P
                lam2 = self._lambda_squared_spline(x)
                lam = torch.sign(bulkPi) * torch.sqrt(torch.clamp(lam2, min=0.0))
                z = self._z_spline(x)
                betapi = self._betapi(T) * T4
                delta_lambda = bulkPi / (5.0 * betapi - 3.0 * P * (E + P) / E)
                delta_z = -3.0 * delta_lambda * P / E
        else:
            g = self._grids
            if mode == 1:
                c0 = self._bilinear(g["c0"], T, muB) / T4
                c1 = self._bilinear(g["c1"], T, muB) / T3
                c2 = self._bilinear(g["c2"], T, muB) / T4
                c3 = self._bilinear(g["c3"], T, muB) / T4
                c4 = self._bilinear(g["c4"], T, muB) / T5
                shear14 = 2.0 * T * T * (E + P)
            elif mode in (2, 3, 5):
                F = self._bilinear(g["F"], T, muB) * T
                G = self._bilinear(g["G"], T, muB)
                betabulk = self._bilinear(g["betabulk"], T, muB) * T4
                betaV = self._bilinear(g["betaV"], T, muB) * T3
                betapi = self._bilinear(g["betapi"], T, muB) * T4
            else:
                raise ValueError("PTB (Jonah) df does not support nonzero muB")

        return DeltafCoefficients(
            c0=c0, c1=c1, c2=c2, c3=c3, c4=c4, shear14=shear14,
            F=F, G=G, betabulk=betabulk, betaV=betaV, betapi=betapi,
            lam=lam, z=z, delta_lambda=delta_lambda, delta_z=delta_z)

    # ------------------------------------------------------------------
    def regulate_bulkPi_ptb(self, bulkPi, P):
        """Clamp the bulk pressure to the PTB spline domain
        (MomentumSpectra.cpp:601-615)."""
        lo = -(1.0 - 1.0e-5) * P
        hi = P * (self.bulkPi_over_Peq_max - 1.0e-5)
        return torch.minimum(torch.maximum(bulkPi, lo), hi)


def compute_particle_densities(species: SpeciesTable, df_data: DeltafData,
                               laguerre: GaussLaguerre,
                               plasma: ThermoAverages) -> None:
    """Per-species (neq, dn_bulk, dn_diff) at the surface-averaged (T, muB)
    (DeltafData.cpp:555-690), in f64 on the host, cached on the species
    table for the sampler's fast mode and the yield estimate."""
    def h(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    T = plasma.temperature
    E = plasma.energy_density
    P = plasma.pressure
    muB = plasma.baryon_chemical_potential
    nB = plasma.net_baryon_density
    df = df_data.evaluate(h(T), h(muB), h(E), h(P), h(0.0))

    alphaB = muB / T
    baryon_enthalpy_ratio = nB / (E + P)
    mass = h(species.mass)
    mbar = mass / T
    g = h(species.gspin)
    b = h(species.baryon)
    sgn = h(species.sign)
    r1, w1 = laguerre.roots[1], laguerre.weights[1]
    r2, w2 = laguerre.roots[2], laguerre.weights[2]
    r3, w3 = laguerre.roots[3], laguerre.weights[3]

    neq_fact = g * T**3 / two_pi2_hbarC3
    neq = neq_fact * thermal.neq_integral(r1, w1, mbar, alphaB, b, sgn)

    mode = df_data.df_mode
    if mode == 1:
        J10 = g * T**3 / two_pi2_hbarC3 * thermal.J10_integral(r1, w1, mbar, alphaB, b, sgn)
        J20 = g * T**4 / two_pi2_hbarC3 * thermal.J20_integral(r2, w2, mbar, alphaB, b, sgn)
        J30 = g * T**5 / two_pi2_hbarC3 * thermal.J30_integral(r3, w3, mbar, alphaB, b, sgn)
        J31 = g * T**5 / two_pi2_hbarC3 / 3.0 * thermal.J31_integral(r3, w3, mbar, alphaB, b, sgn)
        dn_bulk = (df.c0 - df.c2) * mass**2 * J10 + df.c1 * b * J20 \
            + (4.0 * df.c2 - df.c0) * J30
        dn_diff = b * df.c3 * neq * T + df.c4 * J31
    elif mode in (2, 3, 5):
        J10 = g * T**3 / two_pi2_hbarC3 * thermal.J10_integral(r1, w1, mbar, alphaB, b, sgn)
        J11 = g * T**3 / two_pi2_hbarC3 / 3.0 * thermal.J11_integral(r1, w1, mbar, alphaB, b, sgn)
        J20 = g * T**4 / two_pi2_hbarC3 * thermal.J20_integral(r2, w2, mbar, alphaB, b, sgn)
        dn_bulk = (neq + b * J10 * df.G + J20 * df.F / T**2) / df.betabulk
        dn_diff = (neq * T * baryon_enthalpy_ratio - b * J11) / df.betaV
    else:   # PTB: the yield comes from z, not from linear bulk/diffusion terms
        dn_bulk = torch.zeros_like(neq)
        dn_diff = torch.zeros_like(neq)

    species.equilibrium_density = neq.numpy()
    species.bulk_density = dn_bulk.numpy()
    species.diff_density = dn_diff.numpy()
