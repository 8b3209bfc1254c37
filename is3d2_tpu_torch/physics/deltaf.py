"""Delta-f coefficient evaluation for df 1/2.

Counterpart of is3d2_tpu/physics/deltaf.py (Deltaf_Data,
src/cpp/DeltafData.cpp:298-519): cubic-spline (muB = 0) or bilinear
(T, muB) interpolation of the Grad-14 / Chapman-Enskog coefficient tables
with the temperature-power scaling undone, on f64 tensors over the cell
axis.

Not ported yet, because op-1 df 1/2 never reads them: the PTB (Jonah)
splines of ``compute_jonah_coefficients`` feed only df 4, and
``compute_particle_densities`` feeds only the sampler (ROADMAP A3, A6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.deltaf_tables import DeltafTables
from .spline import CubicSpline


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


class DeltafData:
    """Interpolators over the delta-f coefficient tables."""

    def __init__(self, tables: DeltafTables, df_mode: int, include_baryon: bool):
        if df_mode not in (1, 2):
            raise NotImplementedError(
                f"df_mode {df_mode} coefficients are not ported yet "
                "(ROADMAP A9, A10)")
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

    def evaluate(self, T, muB, E, P) -> DeltafCoefficients:
        """Vectorized evaluate_df_coefficients (DeltafData.cpp:324-519) for
        df 1/2 on per-cell f64 tensors; temperature-power scaling undone."""
        zeros = torch.zeros_like(T)
        c0 = c1 = c2 = c3 = c4 = shear14 = zeros
        F = G = betabulk = betapi = zeros
        betaV = torch.ones_like(T)

        T3 = T * T * T
        T4 = T3 * T
        T5 = T4 * T

        if not self.include_baryon:
            if self.df_mode == 1:
                c0 = self._c0(T) / T4
                c2 = self._c2(T) / T4
                shear14 = 2.0 * T * T * (E + P)
            else:
                F = self._F(T) * T
                betabulk = self._betabulk(T) * T4
                betapi = self._betapi(T) * T4
        else:
            g = self._grids
            if self.df_mode == 1:
                c0 = self._bilinear(g["c0"], T, muB) / T4
                c1 = self._bilinear(g["c1"], T, muB) / T3
                c2 = self._bilinear(g["c2"], T, muB) / T4
                c3 = self._bilinear(g["c3"], T, muB) / T4
                c4 = self._bilinear(g["c4"], T, muB) / T5
                shear14 = 2.0 * T * T * (E + P)
            else:
                F = self._bilinear(g["F"], T, muB) * T
                G = self._bilinear(g["G"], T, muB)
                betabulk = self._bilinear(g["betabulk"], T, muB) * T4
                betaV = self._bilinear(g["betaV"], T, muB) * T3
                betapi = self._bilinear(g["betapi"], T, muB) * T4

        return DeltafCoefficients(
            c0=c0, c1=c1, c2=c2, c3=c3, c4=c4, shear14=shear14,
            F=F, G=G, betabulk=betabulk, betaV=betaV, betapi=betapi)
