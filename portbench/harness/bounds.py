"""The card's peaks and the operations a Cooper-Frye evaluation needs:
the yardstick of the ``*_bound_pct`` metrics.

Frozen copies of ``chip_smoke.py``'s ``PEAK_FP32_OPS``, ``PEAK_BYTES`` and
of the ``BOUND_OPS_PER_EVALUATION`` values of B1 and of B3's 3+1d mode
(the fewer of the plain version's operations and the kernel's executed
operations per evaluation; f64 operations count at the FP32 rate, so the
bound stays a lower bound).  Copied as numbers, so a later change to the
kernels or to chip_smoke.py cannot move them.

The evaluations are counted from the inputs, not from the program's
packs: live cells (u.dsigma > 0) x folded eta nodes x momenta in 2+1d;
live cells x momenta x y in 3+1d, each (cell, y) row in the branch the
reference's own classification gives it.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

# B1, 2+1d df 1 (chip_smoke.py: min(70 + 26/12, 41 + 16/4 + 45/12))
B1_OPS_PER_EVALUATION = 48.75
# B3's 3+1d mode, df 4: modified rows min(55, 33 + 12/2 + 12/7),
# linearised (breakdown or narrow-window) rows min(64, 60 + 3/4)
B3_3D_OPS_PER_EVALUATION = {"modified": 33 + 12 / 2 + 12 / 7,
                            "linearised": 60 + 3 / 4}

# the surface fields op 1 reads (tau, eta, dsigma_mu, u^x, u^y, u^eta, T,
# E, P, five pi^{mu nu}, bulk pressure), f64 each
SURFACE_BYTES_PER_CELL = 18 * 8


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES)


def bytes_moved(n_cells: int, n_out: int) -> float:
    """Each input read once (the surface), each output written once (the
    f64 spectra)."""
    return n_cells * SURFACE_BYTES_PER_CELL + 8 * n_out
