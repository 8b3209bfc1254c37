"""Sampler-test histogram binning (test_sampler = 1).

Counterpart of is3d2_tpu/core/sampler_hist.py (BinSampledParticle.cpp:9-133
and the event-averaged writers' accumulators, EmissionFunction.cpp:685-975):
segment sums over the flat axis of kept hadrons, on their device.  Counts
are integer bincounts; the v_n sums are f64 index_add_s of the f32 cos/sin
terms.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..constants import two_pi

K_MAX = 7  # v1..v7 (EmissionFunction.h:102)
_COUNTS = ("dN_dy", "dN_deta", "dN_2pipTdpTdy", "dN_dphipdy", "dN_taudtaudy",
           "dN_2pirdrdy", "dN_dphisdy")


@dataclasses.dataclass
class SampledHistograms:
    """Raw bin counts (event averaging happens in the writers)."""

    n_events: int
    dN_dy: np.ndarray             # (S, y_bins)
    dN_deta: np.ndarray           # (S, eta_bins)
    dN_2pipTdpTdy: np.ndarray     # (S, pT_bins)
    dN_dphipdy: np.ndarray        # (S, phip_bins)
    pT_count: np.ndarray          # (S, pT_bins)
    vn_real: np.ndarray           # (K_MAX, S, pT_bins)
    vn_imag: np.ndarray
    dN_taudtaudy: np.ndarray      # (S, tau_bins)
    dN_2pirdrdy: np.ndarray       # (S, r_bins)
    dN_dphisdy: np.ndarray        # (S, phip_bins)


def bin_histograms(out: dict, S: int, cfg: Config) -> dict:
    """The full histogram set of one batch of kept hadrons (the columns
    sp_idx, px, py, x, y, rapidity, eta, tau; an optional bool ``keep``
    selects rows) -> dict of tensors on the hadrons' device: int64 counts,
    f64 v_n sums.  Bins are computed in f32 as the JAX binner does."""
    sp = out["sp_idx"].to(torch.int64)
    keep = out.get("keep")
    px, py = out["px"], out["py"]

    y_w = 2.0 * cfg.y_cut / cfg.y_bins
    eta_w = 2.0 * cfg.eta_cut / cfg.eta_bins
    pT_w = (cfg.pT_max - cfg.pT_min) / cfg.pT_bins
    phip_w = two_pi / cfg.phip_bins
    tau_w = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    r_w = (cfg.r_max - cfg.r_min) / cfg.r_bins

    pT = torch.sqrt(px ** 2 + py ** 2)
    phip = torch.atan2(py, px)
    phip = torch.where(phip < 0.0, phip + two_pi, phip)
    r = torch.sqrt(out["x"] ** 2 + out["y"] ** 2)
    phis = torch.atan2(out["y"], out["x"])
    phis = torch.where(phis < 0.0, phis + two_pi, phis)

    def axis(values, lo, width, nbins):
        ib = torch.floor((values.to(torch.float32) - lo) / width).to(torch.int64)
        ok = (ib >= 0) & (ib < nbins)
        if keep is not None:
            ok = ok & keep
        return ib, ok, nbins

    specs = dict(zip(_COUNTS, (
        axis(out["rapidity"], -cfg.y_cut, y_w, cfg.y_bins),
        axis(out["eta"], -cfg.eta_cut, eta_w, cfg.eta_bins),
        axis(pT, cfg.pT_min, pT_w, cfg.pT_bins),
        axis(phip, 0.0, phip_w, cfg.phip_bins),
        axis(out["tau"], cfg.tau_min, tau_w, cfg.tau_bins),
        axis(r, cfg.r_min, r_w, cfg.r_bins),
        axis(phis, 0.0, phip_w, cfg.phip_bins))))

    res = {}
    for name, (ib, ok, nb) in specs.items():
        flat = (sp * nb + ib)[ok]
        res[name] = torch.bincount(flat, minlength=S * nb).reshape(S, nb)
    res["pT_count"] = res["dN_2pipTdpTdy"]

    ib, ok, nb = specs["dN_2pipTdpTdy"]
    flat = (sp * nb + ib)[ok]
    ph = phip.to(torch.float32)[ok]
    k = torch.arange(1, K_MAX + 1, device=ph.device, dtype=torch.float32)
    kph = k[:, None] * ph[None, :]                       # (K, n) f32
    for name, trig in (("vn_real", torch.cos), ("vn_imag", torch.sin)):
        acc = torch.zeros((K_MAX, S * nb), dtype=torch.float64,
                          device=ph.device)
        acc.index_add_(1, flat, trig(kph).to(torch.float64))
        res[name] = acc.reshape(K_MAX, S, nb)
    return res


def _result(acc: dict, n_events: int) -> SampledHistograms:
    return SampledHistograms(n_events=n_events,
                             **{k: v.cpu().numpy() for k, v in acc.items()})


def bin_sampled_particles(out: dict, S: int, cfg: Config,
                          n_events: int) -> SampledHistograms:
    return _result(bin_histograms(out, S, cfg), n_events)


class ChunkBinner:
    """Streaming histogram accumulator for sample_particles'
    ``chunk_consumer``: bins each finalized chunk on its device and sums,
    so the campaign's hadron axis is never concatenated or transferred."""

    def __init__(self, S: int, cfg: Config):
        self.S, self.cfg = S, cfg
        self._acc = None

    def __call__(self, chunk: dict) -> None:
        h = bin_histograms(chunk, self.S, self.cfg)
        if self._acc is None:
            self._acc = h
        else:
            for k, v in h.items():
                if k != "pT_count":
                    self._acc[k] += v

    def result(self, n_events: int) -> SampledHistograms:
        return _result(self._acc, n_events)
