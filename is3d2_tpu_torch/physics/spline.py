"""Natural cubic spline (counterpart of is3d2_tpu/physics/spline.py).

Replaces the reference's GSL cspline usage (DeltafData.cpp:298-321,
gsl_spline_eval).  Coefficients are precomputed with numpy at setup time (the
tridiagonal solve is tiny); evaluation is a vectorized torch gather on the
query's device, over arbitrary batch shapes.

The math is the standard natural cubic spline (second derivative zero at the
endpoints), identical to GSL's gsl_interp_cspline, so values agree with the
reference to machine precision.
"""

from __future__ import annotations

import numpy as np
import torch

from ..transfer import to_device


class CubicSpline:
    def __init__(self, x: np.ndarray, y: np.ndarray):
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 1 or x.shape != y.shape or x.size < 3:
            raise ValueError("CubicSpline needs 1d x, y with >= 3 points")
        if not np.all(np.diff(x) > 0):
            raise ValueError("CubicSpline x must be strictly increasing")
        n = x.size
        h = np.diff(x)                       # (n-1,)
        # tridiagonal system for second-derivative coefficients c (natural BC)
        # sub/diag/super for interior nodes i = 1..n-2
        rhs = 3.0 * (np.diff(y[1:]) / h[1:] - np.diff(y[:-1]) / h[:-1])
        c = np.zeros(n)
        if n > 2:
            diag = 2.0 * (h[:-1] + h[1:]).copy()
            sub = h[:-1].copy()
            sup = h[1:].copy()
            # Thomas algorithm
            m = n - 2
            cp = np.zeros(m)
            dp = np.zeros(m)
            cp[0] = sup[0] / diag[0]
            dp[0] = rhs[0] / diag[0]
            for i in range(1, m):
                denom = diag[i] - sub[i] * cp[i - 1]
                cp[i] = sup[i] / denom
                dp[i] = (rhs[i] - sub[i] * dp[i - 1]) / denom
            c[m] = dp[m - 1]
            for i in range(m - 1, 0, -1):
                c[i] = dp[i - 1] - cp[i - 1] * c[i + 1]
        b = np.diff(y) / h - h * (c[1:] + 2.0 * c[:-1]) / 3.0
        d = np.diff(c) / (3.0 * h)

        self.x = x
        self.y = y
        self.b = b
        self.c = c[:-1].copy()
        self.d = d

    def __call__(self, xq: torch.Tensor) -> torch.Tensor:
        """Evaluate at xq (f64 tensor, any shape).  Out-of-range queries are
        clamped to the boundary interval (GSL would raise; callers clamp
        beforehand as the reference does for bulkPi,
        MomentumSpectra.cpp:601-615)."""
        def t(a):
            return to_device(a, xq.device)

        x, y, b, c, d = t(self.x), t(self.y), t(self.b), t(self.c), t(self.d)
        i = torch.clamp(torch.searchsorted(x, xq, right=True) - 1,
                        0, x.shape[0] - 2)
        dx = xq - x[i]
        return y[i] + dx * (b[i] + dx * (c[i] + dx * d[i]))
