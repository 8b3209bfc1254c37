"""Gauss-Laguerre thermal integrals, vectorized and overflow-safe.

Counterpart of is3d2_tpu/physics/thermal.py (src/cpp/GaussThermal.cpp:7-116)
on torch f64 tensors of any device.  Each integral contracts a fixed
quadrature axis; all other arguments broadcast, so one call evaluates every
(cell, species) pair at once.

The reference writes the integrands as exp(pbar)/(exp(Ebar - b alphaB) + sign)
etc., whose intermediate exponentials overflow for Ebar ~ O(100).  The
algebraically identical factored forms

    exp(p) / (exp(t) + s)          = exp(p - t) / (1 + s exp(-t))
    exp(p + t) / (exp(t) + s)^2    = exp(p - t) / (1 + s exp(-t))^2

with t = Ebar - b alphaB >= pbar - b alphaB have bounded exponents, so every
integrand is finite.

``roots``/``weights`` are one generalized Gauss-Laguerre family of
tables/gauss/gla_roots_weights.txt (family index = the power of pbar absorbed
into the weight); ``sign`` is +1 (Fermi) / -1 (Bose).
"""

from __future__ import annotations

import torch

from ..transfer import to_device

f64 = torch.float64


def _bcast(roots, weights, *args):
    """The quadrature on the device of the first tensor argument (else the
    roots' own), and each argument with a trailing quadrature axis, all in
    the dtype of the first floating tensor argument (f64 when there is
    none): f32 arguments give an f32 integral, as the sampler's exact rates
    on the f32 route need."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = (tensors[0].device if tensors else
              roots.device if isinstance(roots, torch.Tensor) else "cpu")
    dtype = next((a.dtype for a in tensors if a.is_floating_point()), f64)

    def t(a):
        return to_device(a, device, dtype)

    return (t(roots), t(weights), *(t(a)[..., None] for a in args))


def _w1(p, t, sign):
    """exp(p) / (exp(t) + sign), overflow-safe."""
    return torch.exp(p - t) / (1.0 + sign * torch.exp(-t))


def _w2(p, t, sign):
    """exp(p + t) / (exp(t) + sign)^2, overflow-safe."""
    d = 1.0 + sign * torch.exp(-t)
    return torch.exp(p - t) / (d * d)


def neq_integral(roots, weights, mbar, alphaB, baryon, sign):
    """Equilibrium density integral, family a=1 (GaussThermal.cpp:19-25)."""
    p, w, mbar, alphaB, baryon, sign = _bcast(roots, weights, mbar, alphaB,
                                              baryon, sign)
    E = torch.sqrt(p * p + mbar * mbar)
    return torch.sum(w * p * _w1(p, E - baryon * alphaB, sign), dim=-1)


def J10_integral(roots, weights, mbar, alphaB, baryon, sign):
    """a=1 family (GaussThermal.cpp:45-52)."""
    p, w, mbar, alphaB, baryon, sign = _bcast(roots, weights, mbar, alphaB,
                                              baryon, sign)
    E = torch.sqrt(p * p + mbar * mbar)
    return torch.sum(w * p * _w2(p, E - baryon * alphaB, sign), dim=-1)


def J11_integral(roots, weights, mbar, alphaB, baryon, sign):
    """a=1 family (GaussThermal.cpp:54-60)."""
    p, w, mbar, alphaB, baryon, sign = _bcast(roots, weights, mbar, alphaB,
                                              baryon, sign)
    E = torch.sqrt(p * p + mbar * mbar)
    return torch.sum(w * p**3 / (E * E) * _w2(p, E - baryon * alphaB, sign),
                     dim=-1)


def J20_integral(roots, weights, mbar, alphaB, baryon, sign):
    """a=2 family (GaussThermal.cpp:62-69)."""
    p, w, mbar, alphaB, baryon, sign = _bcast(roots, weights, mbar, alphaB,
                                              baryon, sign)
    E = torch.sqrt(p * p + mbar * mbar)
    return torch.sum(w * E * _w2(p, E - baryon * alphaB, sign), dim=-1)


def J30_integral(roots, weights, mbar, alphaB, baryon, sign):
    """a=3 family (GaussThermal.cpp:71-77)."""
    p, w, mbar, alphaB, baryon, sign = _bcast(roots, weights, mbar, alphaB,
                                              baryon, sign)
    E = torch.sqrt(p * p + mbar * mbar)
    return torch.sum(w * E * E / p * _w2(p, E - baryon * alphaB, sign), dim=-1)


def J31_integral(roots, weights, mbar, alphaB, baryon, sign):
    """a=3 family (GaussThermal.cpp:79-85)."""
    p, w, mbar, alphaB, baryon, sign = _bcast(roots, weights, mbar, alphaB,
                                              baryon, sign)
    E = torch.sqrt(p * p + mbar * mbar)
    return torch.sum(w * p * _w2(p, E - baryon * alphaB, sign), dim=-1)


def E_mod_integral(roots, weights, mbar, lam, sign):
    """Jonah modified energy density integrand, a=2 family
    (GaussThermal.cpp:100-107)."""
    p, w, mbar, lam, sign = _bcast(roots, weights, mbar, lam, sign)
    scale2 = (1.0 + lam) ** 2
    E = torch.sqrt(p * p + mbar * mbar)
    f = torch.sqrt(p * p * scale2 + mbar * mbar) * _w1(p, E, sign)
    return torch.sum(w * f, dim=-1)


def P_mod_integral(roots, weights, mbar, lam, sign):
    """Jonah modified pressure integrand, a=2 family (GaussThermal.cpp:109-116)."""
    p, w, mbar, lam, sign = _bcast(roots, weights, mbar, lam, sign)
    scale2 = (1.0 + lam) ** 2
    E = torch.sqrt(p * p + mbar * mbar)
    f = p * p * scale2 / torch.sqrt(p * p * scale2 + mbar * mbar) * _w1(p, E, sign)
    return torch.sum(w * f, dim=-1)
