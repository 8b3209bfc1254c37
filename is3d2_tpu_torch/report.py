"""Run-time diagnostics the reference always prints.

Counterpart of is3d2_tpu/report.py: the u.dsigma <= 0 skip count, the
feqmod / famod breakdown count and the proper-time horizon below which cells
fell back (MomentumSpectra.cpp:1039-1040, 1674-1678), the famod pl < 0 and
reconstruction-failure counts (:1675-1677) with the reconstruction's
seconds and Newton iterations, the sampler's momentum efficiency
(ParticleSampler.cpp:1133), kept and drawn hadrons and dropped lanes, and
the tetrad orthonormality / pi.u = 0 / Tr pi = 0 / V.u = 0 invariant
warnings (LocalRestFrame.cpp:43-71, 115-131, 164-171).
"""

from __future__ import annotations

import dataclasses

import torch

from .physics import lrf


@dataclasses.dataclass
class RunReport:
    """Aggregated per-run health metrics (None = not applicable this run)."""

    n_cells: int = 0
    skipped_cells: int | None = None          # u.dsigma <= 0 (masked out)
    # feqmod / famod breakdown (df 3/4/5)
    breakdown_cells: int | None = None
    tau_breakdown: float = 0.0                # latest tau with a breakdown
    pl_negative_cells: int | None = None      # famod: pl < 0 or pt < 0
    tau_pl: float = 0.0
    reconstruction_failures: int | None = None  # famod Newton non-convergence
    reconstruction: object = None             # spectra_famod.Reconstruction
    # sampler
    mom_proposals: int | None = None          # rejection-loop draws
    mom_acceptances: int | None = None
    hadrons_drawn: int | None = None          # Poisson lanes processed
    hadrons_kept: int | None = None
    dropped_lanes: int | None = None          # never-accepted rejection lanes
    sampler_chunks: int = 0
    sampler_syncs: int = 0                    # device -> host reads
    largest_chunk: int = 0                    # lanes of the largest chunk
    sampler_prep_seconds: float = 0.0         # setup + alias tables
    invariants: dict | None = None            # name -> (max violation, tol)

    def record_breakdown(self, breaks_down, tau, mask, pl_negative=None,
                         recon_failed=None) -> None:
        """Fill the breakdown counters from per-cell tensors; famod (df 5)
        also hands its pl < 0 and reconstruction-failure masks."""
        valid = mask > 0.0
        b = breaks_down.bool() & valid
        self.breakdown_cells = int(b.sum().item())
        self.tau_breakdown = float(tau[b].max().item()) if self.breakdown_cells else 0.0
        if pl_negative is not None:
            p = pl_negative.bool() & valid
            self.pl_negative_cells = int(p.sum().item())
            self.tau_pl = float(tau[p].max().item()) if self.pl_negative_cells else 0.0
        if recon_failed is not None:
            self.reconstruction_failures = int(
                (recon_failed.bool() & valid).sum().item())

    def lines(self) -> list[str]:
        out = []
        if self.skipped_cells:
            out.append(f"skipped {self.skipped_cells} / {self.n_cells} cells "
                       "with u.dsigma <= 0")
        if self.breakdown_cells is not None:
            kind = "famod" if self.pl_negative_cells is not None else "feqmod"
            out.append(f"{kind} breaks down for {self.breakdown_cells} / "
                       f"{self.n_cells} cells until t = "
                       f"{self.tau_breakdown:.3f} fm/c")
        if self.pl_negative_cells is not None:
            out.append(f"pl went negative for {self.pl_negative_cells} / "
                       f"{self.n_cells} cells until t = {self.tau_pl:.3f} fm/c")
        if self.reconstruction_failures is not None:
            out.append("Number of reconstruction failures = "
                       f"{self.reconstruction_failures}")
        if self.reconstruction is not None:
            r = self.reconstruction
            out.append(f"famod reconstruction: {r.seconds:.3f} s, "
                       f"{r.newton_iterations} Newton iterations "
                       f"({r.blocks} cell blocks, {r.lane_iterations} "
                       "cell-iterations)")
        if self.mom_proposals:
            eff = 100.0 * self.mom_acceptances / max(self.mom_proposals, 1)
            out.append(f"Momentum sampling efficiency = {eff:f} %")
        if self.hadrons_drawn is not None:
            out.append(f"sampled hadrons: {self.hadrons_kept} kept / "
                       f"{self.hadrons_drawn} drawn "
                       f"(flux+viscous keep fraction "
                       f"{self.hadrons_kept / max(self.hadrons_drawn, 1):.3f})")
            out.append(f"sampler: {self.sampler_chunks} chunk(s), "
                       f"{self.sampler_syncs / max(self.sampler_chunks, 1):.1f}"
                       f" device syncs per chunk, largest chunk "
                       f"{self.largest_chunk} lanes (buffers sized exactly), "
                       f"campaign prep {self.sampler_prep_seconds:.3f} s")
        if self.dropped_lanes:
            frac = self.dropped_lanes / max(self.hadrons_drawn or 1, 1)
            out.append(f"WARNING: {self.dropped_lanes} hadron lanes "
                       f"({100 * frac:.2e} %) never accepted a momentum "
                       "proposal and were dropped (yield bias if large)")
        if self.invariants:
            for name, (val, tol) in self.invariants.items():
                if val > tol:
                    out.append(f"WARNING: {name} violated: max |err| = "
                               f"{val:.6g} (tol {tol:g})")
        return out

    def print(self) -> None:
        for line in self.lines():
            print(line, flush=True)


def check_invariants(surf, include_baryondiff: bool = False) -> dict:
    """Tensor-algebra self-checks on a freezeout surface, vectorized over
    cells in f64 on the host (the reference's per-cell test_orthonormality /
    test_pimunu_orthogonality_and_tracelessness / test_Vmu_orthogonality).

    Returns {invariant: (max violation, tolerance)}.
    """
    def h(a):
        return torch.as_tensor(a, dtype=torch.float64)

    tau, ux, uy, un = h(surf.tau), h(surf.ux), h(surf.uy), h(surf.un)
    tau2 = tau * tau
    ut = lrf.u_time_component(tau, ux, uy, un)
    b = lrf.milne_basis(tau, ux, uy, un)

    def mx(a):
        return float(a.abs().max()) if a.shape[0] else 0.0

    eps_basis = 1.0e-14       # LocalRestFrame.cpp:62
    eps_pi = 1.0e-15          # LocalRestFrame.cpp:124
    eps_V = 1.0e-15           # LocalRestFrame.cpp:168

    out = {
        "U normalization (U.U - 1)":
            (mx(ut * ut - ux * ux - uy * uy - tau2 * un * un - 1.0), eps_basis),
        "X normalization (X.X + 1)":
            (mx(b.Xt * b.Xt - b.Xx * b.Xx - b.Xy * b.Xy
                - tau2 * b.Xn * b.Xn + 1.0), eps_basis),
        "Y normalization (Y.Y + 1)":
            (mx(-b.Yx * b.Yx - b.Yy * b.Yy + 1.0), eps_basis),
        "Z normalization (Z.Z + 1)":
            (mx(b.Zt * b.Zt - tau2 * b.Zn * b.Zn + 1.0), eps_basis),
        "U orthogonality (max U.X, U.Y, U.Z)":
            (max(mx(b.Xt * ut - b.Xx * ux - b.Xy * uy - tau2 * b.Xn * un),
                 mx(-b.Yx * ux - b.Yy * uy),
                 mx(b.Zt * ut - tau2 * b.Zn * un)), eps_basis),
        "X orthogonality (max X.Y, X.Z)":
            (max(mx(-b.Xx * b.Yx - b.Xy * b.Yy),
                 mx(b.Xt * b.Zt - tau2 * b.Xn * b.Zn)), eps_basis),
    }

    # completed shear tensor: pi.u = 0 and Tr pi = 0 hold by construction;
    # verify the completion the way the reference verifies its stored tensor
    pixx, pixy, pixn = h(surf.pixx), h(surf.pixy), h(surf.pixn)
    piyy, piyn = h(surf.piyy), h(surf.piyn)
    pitt, pitx, pity, pitn, pinn = lrf.complete_shear(
        tau, ux, uy, un, pixx, pixy, pixn, piyy, piyn)
    pi_mag = torch.sqrt(
        pitt**2 + pitx**2 + pity**2 + tau2**2 * pitn**2 + pixx**2 + pixy**2
        + tau2**2 * pixn**2 + piyy**2 + tau2**2 * piyn**2 + tau2**2 * pinn**2)
    scale = max(float(pi_mag.max()) if pi_mag.shape[0] else 0.0, 1e-300)
    out["pi.u orthogonality"] = (max(
        mx(pitt * ut - pitx * ux - pity * uy - tau2 * pitn * un),
        mx(pitx * ut - pixx * ux - pixy * uy - tau2 * pixn * un),
        mx(pity * ut - pixy * ux - piyy * uy - tau2 * piyn * un),
        mx(pitn * ut - pixn * ux - piyn * uy - tau2 * pinn * un)) / scale, eps_pi)
    out["pi tracelessness (Tr pi)"] = (
        mx(pitt - pixx - piyy - tau2 * pinn) / scale, eps_pi)

    if include_baryondiff:
        Vx, Vy, Vn = h(surf.Vx), h(surf.Vy), h(surf.Vn)
        Vt = lrf.orthogonal_time_component(tau, ux, uy, un, Vx, Vy, Vn)
        V_mag = torch.sqrt(Vt**2 + Vx**2 + Vy**2 + tau2 * Vn**2)
        vscale = max(float(V_mag.max()) if V_mag.shape[0] else 0.0, 1e-300)
        out["V.u orthogonality"] = (
            mx(Vt * ut - Vx * ux - Vy * uy - tau2 * Vn * un) / vscale, eps_V)

    return out
