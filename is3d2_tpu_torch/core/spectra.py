"""Continuous Cooper-Frye momentum spectra dN/(pT dpT dphi dy).

Counterpart of is3d2_tpu/core/spectra.py (the reference's
MomentumSpectra.cpp:32-415) and its dispatcher over df modes.  For df 1/2:

  * the torch f64 engine (``spectra_df12``): the integrand on broadcast
    axes (cell, species, pT, phi, y, eta), summed block by block over the
    cells.  It is the port's own yardstick, the counterpart of
    ``_spectra_df12_jit``;
  * the compensated-f32 kernel B1 (``compute_dtype`` "f32c" or "f32"):
    the hand-written CUDA kernel ops/cooper_frye_comp.py on a GPU, its
    plain torch version on the CPU (ops/spectra_fast_common.py), in its
    2+1d mode or, on a 3+1d surface, its 3+1d mode;
  * the plain-f32 kernel B2 (``use_pallas = 1`` with "f64"):
    ops/cooper_frye_f32.py, likewise.

df 3/4 (feqmod) run the torch f64 engine of core/spectra_feqmod.py or
kernel B3 (ops/cooper_frye_feqmod.py; on a 3+1d surface its 3+1d mode);
df 5 (famod) the torch f64 engine of core/spectra_famod.py or kernel B3's
famod mode.

All data-dependent per-cell branches of the reference (u.dsigma <= 0 skip,
outflow Theta, |df| <= 1 regulation) are masks and where's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config
from ..constants import hbarC
from ..io.pdg import SpeciesTable
from ..io.tables import MomentumGrids
from ..physics.deltaf import DeltafData
from ..tracing import span
from ..transfer import to_device
from .cells import CellArrays, evaluate_cell_deltaf, prepare_cells

PREFACTOR = (2.0 * math.pi * hbarC) ** -3  # CF prefactor (MomentumSpectra.cpp:38)

# elements of one (cells x species x pT x phi x y x eta) f64 block of the
# f64 engine: bounds its working set (~a dozen live blocks of 32 MB)
_F64_BLOCK_ELEMENTS = 1 << 22

f64 = torch.float64


@dataclasses.dataclass
class SpeciesArrays:
    """Chosen-species properties as f64 tensors on the run's device."""

    mass: torch.Tensor        # (S,)
    sign: torch.Tensor
    degeneracy: torch.Tensor
    baryon: torch.Tensor

    @classmethod
    def from_table(cls, table: SpeciesTable, indices: np.ndarray,
                   device) -> "SpeciesArrays":
        def t(a):
            return to_device(a[indices], device)
        return cls(mass=t(table.mass), sign=t(table.sign),
                   degeneracy=t(table.gspin), baryon=t(table.baryon))


@dataclasses.dataclass
class MomentumGridDevice:
    """Momentum and eta quadrature as f64 tensors.  2+1d: y = 0 and the
    eta table; 3+1d: y from the table, and one eta node of weight 1 (each
    cell's own eta enters through the kinematics)."""

    pT: torch.Tensor
    pT_weight: torch.Tensor
    cos_phi: torch.Tensor
    sin_phi: torch.Tensor
    phi_weight: torch.Tensor
    y: torch.Tensor
    eta: torch.Tensor
    eta_weight: torch.Tensor

    # host (eta, eta_weight) f64 arrays, set where the grid is built from
    # host tables, so that the eta fold reads nothing back; not a field
    host_eta = None

    @classmethod
    def from_grids(cls, g: MomentumGrids, dimension: int,
                   device) -> "MomentumGridDevice":
        def t(a):
            return to_device(np.asarray(a), device)
        if dimension == 2:
            y, eta, eta_w = np.zeros(1), g.eta, g.eta_weight
        else:
            y, eta, eta_w = g.y, np.zeros(1), np.ones(1)
        grid = cls(pT=t(g.pT), pT_weight=t(g.pT_weight),
                   cos_phi=t(np.cos(g.phi)), sin_phi=t(np.sin(g.phi)),
                   phi_weight=t(g.phi_weight), y=t(y), eta=t(eta),
                   eta_weight=t(eta_w))
        grid.host_eta = (np.asarray(eta, dtype=np.float64),
                         np.asarray(eta_w, dtype=np.float64))
        return grid


def df12_cell_coefficients(cells: CellArrays, df_data: DeltafData,
                           cfg: Config) -> dict:
    """Per-cell shear/bulk/diffusion coefficient columns
    (MomentumSpectra.cpp:213-246)."""
    df = evaluate_cell_deltaf(cells, df_data, cfg)
    T = cells.T
    bulkPi = cells.bulkPi
    if cfg.df_mode == 1:
        return {
            "shear": 1.0 / df.shear14,
            "bulk0": (df.c0 - df.c2) * bulkPi,
            "bulk1": df.c1 * bulkPi,
            "bulk2": (4.0 * df.c2 - df.c0) * bulkPi,
            "diff0": df.c3,
            "diff1": df.c4,
        }
    if cfg.df_mode == 2:
        return {
            "shear": 0.5 / (df.betapi * T),
            "bulk0": df.F / (T * T * df.betabulk) * bulkPi,
            "bulk1": df.G / df.betabulk * bulkPi,
            "bulk2": bulkPi / (3.0 * T * df.betabulk),
            "diff0": cells.baryon_enthalpy_ratio / df.betaV,
            "diff1": 1.0 / df.betaV,
        }
    raise ValueError("df12_cell_coefficients requires df_mode 1 or 2")


def _momentum_tensors(c: CellArrays, grid: MomentumGridDevice,
                      species: SpeciesArrays, dimension: int):
    """Kinematics for one cell block: pt[c,s,p,y,e], pn[c,s,p,y,e],
    px[p,f], py[p,f].  2+1d: y = 0, eta from the table; 3+1d: y from the
    table, eta the cell's own (one node)."""
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)  # (s,p)
    px = grid.pT[:, None] * grid.cos_phi[None, :]                        # (p,f)
    py = grid.pT[:, None] * grid.sin_phi[None, :]
    if dimension == 2:
        delta = -grid.eta[None, None, :]                                 # (c=1,y=1,e)
    else:
        delta = grid.y[None, :, None] - c.eta[:, None, None]             # (c,y,e=1)
    sinh_d = torch.sinh(delta)
    cosh_d = torch.sqrt(1.0 + sinh_d * sinh_d)
    pt = mT[None, :, :, None, None] * cosh_d[:, None, None, :, :]
    pn = (mT[None, :, :, None, None] / c.tau[:, None, None, None, None]
          * sinh_d[:, None, None, :, :])
    return pt, pn, px, py


def df12_weighted_value(c: CellArrays, coeffs: dict, species: SpeciesArrays,
                        grid: MomentumGridDevice, cfg: Config):
    """eta_weight * (p.dsigma) * f on axes (c,s,p,f,y,e) for df modes 1/2
    (the hot loop of MomentumSpectra.cpp:250-377), in f64."""
    pt5, pn5, px2, py2 = _momentum_tensors(c, grid, species, cfg.dimension)

    def C(a):  # cell scalar -> (c,1,1,1,1,1)
        return a[:, None, None, None, None, None]

    def S(a):  # species scalar -> (1,s,1,1,1,1)
        return a[None, :, None, None, None, None]

    pt = pt5[:, :, :, None, :, :]
    pn = pn5[:, :, :, None, :, :]
    px = px2[None, None, :, :, None, None]
    py = py2[None, None, :, :, None, None]
    tau2 = c.tau * c.tau

    # p.dsigma (momentum contravariant, dsigma covariant)
    pdd = pt * C(c.dat) + px * C(c.dax) + py * C(c.day) + pn * C(c.dan)
    # u.p (LRF energy)
    E_lrf = pt * C(c.ut) - px * C(c.ux) - py * C(c.uy) - pn * C(tau2 * c.un)

    chem = S(species.baryon) * C(c.alphaB)
    sgn = S(species.sign)
    feq = 1.0 / (torch.exp(E_lrf / C(c.T) - chem) + sgn)
    feqbar = 1.0 - sgn * feq

    # pi^munu p_mu p_nu (MomentumSpectra.cpp:323-324)
    pimunu_pp = (C(c.pitt) * pt * pt + C(c.pixx) * px * px + C(c.piyy) * py * py
                 + C(tau2 * tau2 * c.pinn) * pn * pn
                 + 2.0 * (-(C(c.pitx) * px + C(c.pity) * py) * pt
                          + C(c.pixy) * px * py
                          + C(tau2) * pn * (C(c.pixn) * px + C(c.piyn) * py
                                            - C(c.pitn) * pt)))
    # V^mu p_mu
    V_pp = pt * C(c.Vt) - px * C(c.Vx) - py * C(c.Vy) - pn * C(tau2 * c.Vn)

    mass2 = S(species.mass ** 2)
    b_s = S(species.baryon)
    k = coeffs
    if cfg.df_mode == 1:
        df_shear = C(k["shear"]) * pimunu_pp
        df_bulk = C(k["bulk0"]) * mass2 \
            + (C(k["bulk1"]) * b_s + C(k["bulk2"]) * E_lrf) * E_lrf
        df_diff = (C(k["diff0"]) * b_s + C(k["diff1"]) * E_lrf) * V_pp
    elif cfg.df_mode == 2:
        df_shear = C(k["shear"]) * pimunu_pp / E_lrf
        df_bulk = C(k["bulk0"]) * E_lrf + C(k["bulk1"]) * b_s \
            + C(k["bulk2"]) * (E_lrf - mass2 / E_lrf)
        df_diff = (C(k["diff0"]) - C(k["diff1"]) * b_s / E_lrf) * V_pp
    else:
        raise ValueError("df12 engine supports df_mode 1/2 only")

    df = feqbar * (df_shear + df_bulk + df_diff)
    if cfg.regulate_deltaf:
        df = torch.clamp(df, -1.0, 1.0)
    f = feq * (1.0 + df)
    if cfg.outflow:
        pdd = torch.where(pdd > 0.0, pdd, 0.0)
    w_eta = grid.eta_weight[None, None, None, None, None, :]
    return w_eta * pdd * f


def spectra_df12(cells: CellArrays, coeffs: dict, species: SpeciesArrays,
                 grid: MomentumGridDevice, cfg: Config) -> torch.Tensor:
    """The torch f64 engine: (S, NpT, Nphi, Ny) spectra, summed over cell
    blocks of at most _F64_BLOCK_ELEMENTS integrand points."""
    S = species.mass.shape[0]
    shape = (S, grid.pT.shape[0], grid.cos_phi.shape[0], grid.y.shape[0])
    per_cell = math.prod(shape) * grid.eta.shape[0]
    C = cells.n_padded
    blk = max(1, min(C, _F64_BLOCK_ELEMENTS // per_cell))
    acc = torch.zeros(shape, dtype=f64, device=cells.tau.device)
    for i in range(0, C, blk):
        cb = CellArrays(**{f.name: getattr(cells, f.name)[i:i + blk]
                           for f in dataclasses.fields(cells)})
        kb = {k: v[i:i + blk] for k, v in coeffs.items()}
        value = df12_weighted_value(cb, kb, species, grid, cfg)
        w_cell = cb.mask[:, None, None, None, None, None]
        acc += torch.sum(w_cell * value, dim=(0, 5))
    return PREFACTOR * species.degeneracy[:, None, None, None] * acc


def engine_inputs(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                  grids: MomentumGrids, cfg: Config, device, report=None):
    """Per-cell tensors, species and grid on ``device``.  ``report`` (a
    report.RunReport) collects the skipped-cell count, counted on the
    host."""
    with span("prepare_cells"):
        cells = prepare_cells(surf, cfg, device)
        if report is not None:
            report.n_cells = surf.n_cells
            report.skipped_cells = surf.n_cells - len(cells.host.live)
        return (cells,
                SpeciesArrays.from_table(species_table, chosen_idx, device),
                MomentumGridDevice.from_grids(grids, cfg.dimension, device))


def df12_state(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
               grids: MomentumGrids, df_data: DeltafData, cfg: Config,
               device, report=None):
    """Cells, coefficient columns, species and grid on ``device``:
    everything the df 1/2 engines take."""
    cells, species, grid = engine_inputs(surf, species_table, chosen_idx,
                                         grids, cfg, device, report)
    with span("cell_physics"):
        coeffs = df12_cell_coefficients(cells, df_data, cfg)
    return cells, coeffs, species, grid


def uses_feqmod_kernel(cfg: Config) -> bool:
    """df 3/4/5 through kernel B3 (where is3d2_tpu/core/spectra.py:428-442
    and :449-465 choose its Pallas kernel or XLA fast path): f32/f32c
    whatever use_pallas says (B3 and its 3+1d mode stand in for the JAX
    XLA programs _feqmod_fast_jit and _feqmod_fast_3d_jit); f64 with
    use_pallas = 1 in 2+1d (the JAX Pallas kernel is 2+1d only: in 3+1d
    f64 runs the f64 engine)."""
    if cfg.compute_dtype in ("f32", "f32c"):
        return True
    return cfg.use_pallas == 1 and cfg.dimension == 2


def compute_spectra(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                    grids: MomentumGrids, df_data: DeltafData, cfg: Config,
                    device, laguerre=None, report=None,
                    mesh=None) -> np.ndarray:
    """Continuous spectra dN/(pT dpT dphi dy), shape (S, NpT, Nphi, Ny):
    spectra_on_device's result (under ``mesh`` if given), brought to the
    host.

    With cfg.group_particles, species within particle_diff_tolerance in
    mass (same sign, and baryon number with baryons on) share one spectra
    evaluation on every route, rescaled by degeneracy
    (SpeciesTable.group_species; is3d2_tpu/core/spectra.py:310-321).
    """
    cfg.validate_slice()
    if cfg.group_particles and len(chosen_idx) > 1:
        chosen_idx = np.asarray(chosen_idx)
        rep_pos, group_of = species_table.group_species(
            chosen_idx, cfg.particle_diff_tolerance, bool(cfg.include_baryon))
        if len(rep_pos) < len(chosen_idx):
            rep_out = compute_spectra(
                surf, species_table, chosen_idx[rep_pos], grids, df_data,
                dataclasses.replace(cfg, group_particles=0), device,
                laguerre, report, mesh)
            deg = species_table.gspin[chosen_idx]
            scale = deg / deg[rep_pos][group_of]
            return rep_out[group_of] * scale[:, None, None, None]
    out = spectra_on_device(surf, species_table, chosen_idx, grids, df_data,
                            cfg, device, laguerre, report, mesh)
    with span("copy_back"):
        return out.cpu().numpy()


def spectra_on_device(surf, species_table: SpeciesTable,
                      chosen_idx: np.ndarray, grids: MomentumGrids,
                      df_data: DeltafData, cfg: Config, device,
                      laguerre=None, report=None,
                      mesh=None) -> torch.Tensor:
    """The spectra of the chosen species, one evaluation each (no
    grouping), as an (S, NpT, Nphi, Ny) f64 tensor on ``device``.

    df 1/2, routed as the JAX package routes one device
    (is3d2_tpu/core/spectra.py:354-420): "f32" and "f32c" run the
    compensated kernel B1 (in 3+1d its 3+1d mode) whatever use_pallas
    says; "f64" runs the plain-f32 kernel B2 with use_pallas = 1 in 2+1d
    and the torch f64 engine otherwise.  df 3/4 (``laguerre`` needed): the
    feqmod prep, then kernel B3 (in 3+1d its 3+1d mode; see
    uses_feqmod_kernel) or the torch f64 feqmod engine.
    df 5: the famod prep (the VAH reconstruction, or a mode-2/3 surface's
    own variables), then kernel B3's famod mode (the same routes) or the
    torch f64 famod engine.  A kernel runs as CUDA on a GPU device and as
    its plain version on the CPU.

    On a GPU, df 1-4 (2+1d and 3+1d) queue their work without waiting for
    the device: the uploads are asynchronous and the gates, counts and live
    cells come from the host columns (cells.HostFacts), so the host can
    prepare the next surface while this one computes (core/ensemble.py).
    df 5's reconstruction reads its Newton's convergence back, and waits.

    Under ``mesh`` (the driver's, parallel/sharding.py::auto_mesh of
    cfg.use_mesh; None: one device) the state is prepared once on
    ``device`` and the route runs cut over the mesh's devices, as the JAX
    package routes (is3d2_tpu/core/spectra.py:349-472);
    where the JAX package keeps a route on one device under a mesh, so does
    the port: df 1/2 with use_pallas = 1 in 2+1d and not f32c, df 3-5 with
    use_pallas = 1 in 2+1d, and 3+1d df 3-5 with f32/f32c.
    """
    from ..parallel import sharding
    if cfg.df_mode in (3, 4, 5):
        if cfg.df_mode == 5:
            from ..ops.cooper_frye_feqmod import (
                compute_spectra_famod_kernel as kernel)
            from .spectra_famod import famod_state
            from .spectra_famod import spectra_famod as engine
            state = famod_state(surf, species_table, chosen_idx, grids, cfg,
                                device, report)
        else:
            from ..ops.cooper_frye_feqmod import (
                compute_spectra_feqmod_kernel as kernel)
            from .spectra_feqmod import feqmod_state
            from .spectra_feqmod import spectra_feqmod as engine
            state = feqmod_state(surf, species_table, chosen_idx, grids,
                                 df_data, cfg, device, laguerre, report)
        if uses_feqmod_kernel(cfg):
            if (mesh is not None and cfg.dimension == 2
                    and cfg.use_pallas != 1):
                return sharding.sharded_spectra_feqmod_fast(*state, cfg, mesh)
            return kernel(*state, cfg)
        with span("launch"):
            if mesh is not None:
                return sharding.sharded_spectra_mod_f64(*state, cfg, mesh)
            return engine(*state, cfg)
    state = df12_state(surf, species_table, chosen_idx, grids, df_data, cfg,
                       device, report)
    # f32 and f32c run B1 whatever use_pallas says, on any device (on the
    # CPU its plain version): where the JAX package runs its XLA fast paths
    # (use_pallas = 0, or -1 on the CPU backend: _block_fast_comp,
    # _block_fast; in 3+1d _block_fast_3d(_comp)), B1 and its 3+1d mode
    # stand in for them.  f64 runs B2 with use_pallas = 1 in 2+1d (B2 is
    # 2+1d only, as the JAX package's _kernel is), else the f64 engine
    if cfg.compute_dtype in ("f32", "f32c"):
        from ..ops.spectra_fast_common import compute_spectra_comp
        if mesh is not None and cfg.dimension == 3:
            return sharding.sharded_spectra_fast_3d(*state, cfg, mesh)
        if mesh is not None and (cfg.compute_dtype == "f32c"
                                 or cfg.use_pallas != 1):
            return sharding.sharded_spectra_fast(*state, cfg, mesh)
        return compute_spectra_comp(*state, cfg)
    if cfg.use_pallas == 1 and cfg.dimension == 2:
        from ..ops.spectra_fast_common import compute_spectra_f32
        return compute_spectra_f32(*state, cfg)
    with span("launch"):
        if mesh is not None:
            return sharding.sharded_spectra(*state, cfg, mesh)
        return spectra_df12(*state, cfg)
