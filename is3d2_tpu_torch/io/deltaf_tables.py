"""Delta-f coefficient table loader.

Replaces Deltaf_Data::load_df_coefficient_data (src/cpp/DeltafData.cpp:65-217).

Each file deltaf_coefficients/vh/<eos>/<name>.dat holds a (points_T x
points_muB) grid: two header ints (points_T, points_muB), one header line,
then rows "T muB value" with T varying fastest inside each muB block.
Values carry temperature-power scaling that is undone at evaluation time
(physics/deltaf.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

_GRAD_NAMES = ("c0", "c1", "c2", "c3", "c4")
_CE_NAMES = ("F", "G", "betabulk", "betaV", "betapi")

_EOS_DIRS = {1: "urqmd", 2: "smash", 3: "smash_box"}


def _load_coeff_file(path: Path, include_baryon: bool):
    with open(path) as f:
        points_T = int(f.readline())
        points_muB = int(f.readline())
        f.readline()  # column header line
        n_muB = points_muB if include_baryon else 1
        rows = np.loadtxt(f, dtype=np.float64, max_rows=points_T * n_muB, ndmin=2)
    T = rows[:points_T, 0]
    muB = rows[::points_T, 1][:n_muB]
    data = rows[:, 2].reshape(n_muB, points_T)
    return T, muB, data


@dataclasses.dataclass
class DeltafTables:
    """Raw (T, muB) coefficient grids for one HRG EoS."""

    T_grid: np.ndarray       # (points_T,) GeV
    muB_grid: np.ndarray     # (points_muB,) GeV
    # Grad 14-moment (temperature-power scaled)
    c0: np.ndarray           # (points_muB, points_T)
    c1: np.ndarray
    c2: np.ndarray
    c3: np.ndarray
    c4: np.ndarray
    # RTA Chapman-Enskog (temperature-power scaled)
    F: np.ndarray
    G: np.ndarray
    betabulk: np.ndarray
    betaV: np.ndarray
    betapi: np.ndarray

    @property
    def points_T(self) -> int:
        return self.T_grid.shape[0]

    @property
    def points_muB(self) -> int:
        return self.muB_grid.shape[0]

    @classmethod
    def from_dir(cls, coeff_dir: str | Path, include_baryon: bool) -> "DeltafTables":
        coeff_dir = Path(coeff_dir)
        arrays = {}
        T = muB = None
        for name in _GRAD_NAMES + _CE_NAMES:
            T, muB, data = _load_coeff_file(coeff_dir / f"{name}.dat", include_baryon)
            arrays[name] = data
        return cls(T_grid=T, muB_grid=muB, **arrays)

    @classmethod
    def load(cls, hrg_eos: int, include_baryon: bool,
             base_dir: str | Path = "deltaf_coefficients/vh") -> "DeltafTables":
        return cls.from_dir(Path(base_dir) / _EOS_DIRS[hrg_eos], include_baryon)
