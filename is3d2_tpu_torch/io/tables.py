"""Numeric table and quadrature loaders.

Replaces the reference's Table class (src/cpp/Table.cpp:32-225) and the
Gauss_Laguerre / Gauss_Legendre loaders (src/cpp/readindata.cpp:20-95) with
numpy-based readers.  All tables are plain whitespace-separated columns.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


def load_table(path: str | Path) -> np.ndarray:
    """Load a whitespace-separated numeric table as a (rows, cols) f64 array.

    Matches the reference's Table block reader for the table files it uses
    (momentum grids, chosen-particle lists): blank lines are skipped.
    """
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    return data


@dataclasses.dataclass
class GaussLaguerre:
    """Generalized Gauss-Laguerre roots/weights, one family per power alpha.

    File format (tables/gauss/gla_roots_weights.txt, readindata.cpp:26-61):
    header "<n_alpha> <n_points>", then n_alpha blocks of n_points rows
    "<alpha_index> <root> <weight>".
    """

    roots: np.ndarray    # (n_alpha, n_points)
    weights: np.ndarray  # (n_alpha, n_points)

    @property
    def points(self) -> int:
        return self.roots.shape[1]

    @classmethod
    def from_file(cls, path: str | Path) -> "GaussLaguerre":
        tokens = Path(path).read_text().split()
        n_alpha, n_points = int(tokens[0]), int(tokens[1])
        body = np.array(tokens[2:], dtype=np.float64).reshape(n_alpha * n_points, 3)
        roots = body[:, 1].reshape(n_alpha, n_points)
        weights = body[:, 2].reshape(n_alpha, n_points)
        return cls(roots=roots, weights=weights)


@dataclasses.dataclass
class GaussLegendre:
    """Gauss-Legendre roots/weights (tables/gauss/gauss_legendre.dat)."""

    roots: np.ndarray
    weights: np.ndarray

    @property
    def points(self) -> int:
        return self.roots.shape[0]

    @classmethod
    def from_file(cls, path: str | Path) -> "GaussLegendre":
        tokens = Path(path).read_text().split()
        n = int(tokens[0])
        body = np.array(tokens[1:], dtype=np.float64).reshape(n, 2)
        return cls(roots=body[:, 0], weights=body[:, 1])


@dataclasses.dataclass
class MomentumGrids:
    """The four momentum/rapidity tables used by the continuous CF spectra.

    Columns are (value, weight); weight columns may be absent for pure-value
    grids (then weight = 0).  Reference: iS3D.cpp:254-257, tables/readme.txt.
    """

    pT: np.ndarray          # (NpT,)
    pT_weight: np.ndarray
    phi: np.ndarray         # (Nphi,)
    phi_weight: np.ndarray
    y: np.ndarray           # (Ny,)
    y_weight: np.ndarray
    eta: np.ndarray         # (Neta,)
    eta_weight: np.ndarray

    @classmethod
    def from_dir(cls, tables_dir: str | Path) -> "MomentumGrids":
        tables_dir = Path(tables_dir)

        def _load(rel: str) -> tuple[np.ndarray, np.ndarray]:
            t = load_table(tables_dir / rel)
            vals = t[:, 0]
            w = t[:, 1] if t.shape[1] > 1 else np.zeros_like(vals)
            return vals, w

        pT, pTw = _load("momentum/pT_table.dat")
        phi, phiw = _load("momentum/phi_table.dat")
        y, yw = _load("momentum/y_table.dat")
        eta, etaw = _load("spacetime_rapidity/eta_table.dat")
        return cls(pT, pTw, phi, phiw, y, yw, eta, etaw)
