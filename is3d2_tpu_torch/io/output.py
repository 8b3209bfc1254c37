"""Op-1 result writers with reference-compatible file formats and naming.

Counterpart of the continuous writers of is3d2_tpu/io/output.py, which mirror
EmissionFunction.cpp:406-878:

  results/continuous/dN_pTdpTdphidy_<mcid>.dat      (y phip pT value)
  results/continuous/vn_<mcid>.dat                  (y pT v1..v7)
  results/continuous/dN_2pipTdpTdy_<mcid>.dat
  results/continuous/dN_dphidy_<mcid>.dat
  results/continuous/dN_dy_<mcid>.dat

Rows are formatted with ``%``-formatting one blank-line block at a time,
which gives the same bytes as the JAX package's per-row f-string loop and
its native block writer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import two_pi
from .tables import MomentumGrids


def _continuous_dir(results_dir: Path) -> Path:
    d = Path(results_dir) / "continuous"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _write_blocks(path: Path, header: str, cols: list[np.ndarray],
                  block: int, blank_tail: bool) -> None:
    """Write the float columns as %.8e rows separated by tabs, one blank line
    after every ``block`` rows (after the last block only if
    ``blank_tail``); an empty ``header`` writes no header line."""
    data = np.column_stack(cols)
    n_blocks = data.shape[0] // block
    fmt = ("\t".join(["%.8e"] * data.shape[1]) + "\n") * block
    parts = [header + "\n"] if header else []
    for k in range(n_blocks):
        parts.append(fmt % tuple(data[k * block:(k + 1) * block].ravel()))
        if blank_tail or k < n_blocks - 1:
            parts.append("\n")
    path.write_text("".join(parts))


def write_spectra(results_dir: Path, mcids, spectra: np.ndarray,
                  grids: MomentumGrids, dimension: int) -> None:
    """dN_pTdpTdphidy_<mcid>.dat (EmissionFunction.cpp:406-440)."""
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    d = _continuous_dir(results_dir)
    y_c = np.repeat(y_vals, Nphi * NpT)
    phi_c = np.tile(np.repeat(grids.phi, NpT), Ny)
    pT_c = np.tile(grids.pT, Ny * Nphi)
    vals = np.asarray(spectra).transpose(0, 3, 2, 1).reshape(S, -1)
    for i, mcid in enumerate(mcids):
        _write_blocks(d / f"dN_pTdpTdphidy_{mcid}.dat",
                      "y\tphip\tpT\tdN_pTdpTdphidy",
                      [y_c, phi_c, pT_c, vals[i]], NpT, True)


def write_vn(results_dir: Path, mcids, spectra: np.ndarray,
             grids: MomentumGrids, dimension: int, k_max: int = 7) -> None:
    """vn_<mcid>.dat (EmissionFunction.cpp:804-878)."""
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    w = grids.phi_weight
    cos_k = np.stack([np.cos((k + 1) * grids.phi) for k in range(k_max)])
    sin_k = np.stack([np.sin((k + 1) * grids.phi) for k in range(k_max)])

    sp_all = np.asarray(spectra)
    wsp = w[None, None, :, None] * sp_all                      # (S,NpT,Nphi,Ny)
    den = wsp.sum(axis=2)                                      # (S,NpT,Ny)
    re = np.einsum("kf,spfy->kspy", cos_k, wsp)
    im = np.einsum("kf,spfy->kspy", sin_k, wsp)
    vns = np.where(den[None] < 1e-15, 0.0,
                   np.hypot(re, im) / np.maximum(den[None], 1e-300))

    d = _continuous_dir(results_dir)
    y_c = np.repeat(y_vals, NpT)
    pT_c = np.tile(grids.pT, Ny)
    for i, mcid in enumerate(mcids):
        cols = [y_c, pT_c] + [vns[k, i].T.reshape(-1) for k in range(k_max)]
        _write_blocks(d / f"vn_{mcid}.dat", "", cols, NpT, True)


def write_dN_2pipTdpTdy(results_dir: Path, mcids, spectra, grids, dimension):
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    vals = np.einsum("f,spfy->spy", grids.phi_weight,
                     np.asarray(spectra)) / two_pi          # (S,NpT,Ny)
    d = _continuous_dir(results_dir)
    y_c = np.repeat(y_vals, NpT)
    pT_c = np.tile(grids.pT, Ny)
    for i, mcid in enumerate(mcids):
        _write_blocks(d / f"dN_2pipTdpTdy_{mcid}.dat", "",
                      [y_c, pT_c, vals[i].T.reshape(-1)], NpT, False)


def write_dN_dphidy(results_dir: Path, mcids, spectra, grids, dimension):
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    vals = np.einsum("p,spfy->sfy", grids.pT_weight,
                     np.asarray(spectra))                    # (S,Nphi,Ny)
    d = _continuous_dir(results_dir)
    y_c = np.repeat(y_vals, Nphi)
    phi_c = np.tile(grids.phi, Ny)
    for i, mcid in enumerate(mcids):
        _write_blocks(d / f"dN_dphidy_{mcid}.dat", "",
                      [y_c, phi_c, vals[i].T.reshape(-1)], Nphi, False)


def write_dN_dy(results_dir: Path, mcids, spectra, grids, dimension):
    S, NpT, Nphi, Ny = spectra.shape
    y_vals = grids.y if dimension == 3 else np.zeros(1)
    d = _continuous_dir(results_dir)
    for i, mcid in enumerate(mcids):
        with open(d / f"dN_dy_{mcid}.dat", "w") as fh:
            for iy in range(Ny):
                val = float((grids.phi_weight[None, :]
                             * grids.pT_weight[:, None]
                             * spectra[i, :, :, iy]).sum())
                fh.write(f"{y_vals[iy]:.8f}\t{val:.8f}\n")
