"""Monte-Carlo particle sampler (operation 2), df modes 1-5, 2+1d.

Counterpart of is3d2_tpu/core/sampler.py (the reference's
ParticleSampler.cpp:25-1134) in eager torch on the run's device.  One event
chunk runs as a chain of phase functions, each a few whole-tensor ops:

  1. ``draw_counts``: one Poisson draw per CELL from the per-cell total
     rate, run-length decoded onto a flat hadron axis sized exactly (the
     drawn total is read back once);
  2. ``draw_species``: the Walker alias draw from (cell, species) tables
     built once per campaign on the host (io/fastio.build_alias_tables);
  3. ``gather_hadrons``: the per-cell and per-species columns at hadron
     width;
  4. ``draw_momentum``: the Scott-Pratt light/heavy rejection draws
     (ParticleSampler.cpp:243-405) in blocks of rounds between checks, then
     the stragglers compacted and drawn to completion; for df 1/2 the
     direction is redrawn from the tilted flux envelope;
  5. ``keep_hadrons``: the feqmod rescale (df 3/4) or the famod rescale
     p = B p' (df 5, core/sampler_famod.py), the viscous weight and the
     flux keep;
  6. ``finalize``: compaction to the kept rows (sized exactly by a second
     read-back), either lean (LRF momenta and packed ids for the host
     export) or full (the lab boost and the rapidity draw on the device,
     for the histogram binner).

Every per-hadron array is f32; the Poisson means and the rates stay f64.
Each chunk draws from its own torch.Generator seeded from (seed, chunk
index), so a seed repeats its bits on one device; parity with jax.random
is statistical.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import Config
from ..constants import two_pi, two_pi2_hbarC3
from ..io.fastio import build_alias_tables
from ..io.pdg import SpeciesTable
from ..io.tables import GaussLaguerre
from ..physics import lrf, thermal
from ..physics.deltaf import DeltafData
from .cells import CellArrays, prepare_cells
from .feqmod import FeqmodCellData, prepare_feqmod
from .spectra import SpeciesArrays

f32 = torch.float32
f64 = torch.float64

# (cells x species x Gauss-Laguerre points) elements of one exact-rate
# block: bounds its ~10 live intermediates to ~32 MB each
_RATE_BLOCK_ELEMENTS = 1 << 22

# rejection rounds between two reads of the unaccepted count (each read is
# a device -> host sync)
ROUND_BLOCK = 4


# ----------------------------------------------------------------------
# mean particle numbers
# ----------------------------------------------------------------------

def pion_thermal_weight_max(x):
    """Rational fit of the max pion thermal weight (ParticleSampler.cpp:41-70)."""
    x2 = x * x
    x3 = x2 * x
    x4 = x3 * x
    num = (143206.88623164667 - 95956.76008684626 * x - 21341.937407169076 * x2
           + 14388.446116867359 * x3 - 6083.775788504437 * x4)
    den = (-0.3541350577684533 + 143218.69233952634 * x - 24516.803600065778 * x2
           - 115811.59391199696 * x3 + 35814.36403387459 * x4)
    return 1.00001 * num / den


@dataclasses.dataclass
class SamplerSetup:
    """Everything the hadron pipeline gathers per cell (f64, (C,) unless
    noted)."""

    cells: CellArrays
    fq: FeqmodCellData | None       # feqmod data (df 3/4)
    rates: torch.Tensor             # (C, S) mean counts per unit volume
    # LRF surface element
    dst: torch.Tensor
    dsx: torch.Tensor
    dsy: torch.Tensor
    dsz: torch.Tensor
    ds_max: torch.Tensor
    # LRF shear / diffusion
    pixx: torch.Tensor
    pixy: torch.Tensor
    pixz: torch.Tensor
    piyy: torch.Tensor
    piyz: torch.Tensor
    pizz: torch.Tensor
    Vx: torch.Tensor
    Vy: torch.Tensor
    Vz: torch.Tensor
    # df coefficient columns for w_visc
    df_cols: dict
    # feqmod transforms
    shear_mod: torch.Tensor
    isotropic_scale: torch.Tensor
    diff_mod: torch.Tensor
    T_mod: torch.Tensor
    alphaB_mod: torch.Tensor
    breaks_down: torch.Tensor       # bool


def _fast_rates(cells, species_table, chosen_idx, fq, cfg):
    """dn[c,s] in fast mode (fast_max_particle_number,
    ParticleSampler.cpp:122-161)."""
    def d(a):
        return torch.as_tensor(a[chosen_idx], dtype=f64,
                               device=cells.T.device)[None, :]

    neq = d(species_table.equilibrium_density)
    dnb = d(species_table.bulk_density)
    if cfg.df_mode in (1, 2):
        return (2.0 * neq).expand(cells.n_padded, neq.shape[1])
    bulkPi = fq.bulkPi[:, None]
    breaks = fq.breaks_down[:, None]
    if cfg.df_mode == 3:
        return torch.where(breaks, 2.0 * neq, neq + bulkPi * dnb)
    if cfg.df_mode == 4:
        return torch.where(breaks, 2.0 * neq, fq.z[:, None] * neq)
    raise ValueError("fast rates support df_mode 1-4")


def _exact_rates(T, alphaB, species: SpeciesArrays, breaks_down, bulkPi, z,
                 G, F, betabulk, cfg, r1, w1, r2, w2):
    """dn[c,s] in exact mode (max_particle_number,
    ParticleSampler.cpp:164-239), in the dtype of its arguments."""
    T = T[:, None]
    mbar = species.mass[None, :] / T
    aB = alphaB[:, None]
    b = species.baryon[None, :]
    sgn = species.sign[None, :]
    g = species.degeneracy[None, :]
    neq_fact = T**3 / two_pi2_hbarC3
    neq = neq_fact * g * thermal.neq_integral(r1, w1, mbar, aB, b, sgn)

    if cfg.df_mode in (1, 2):
        return 2.0 * neq

    breaks = breaks_down[:, None]
    if cfg.df_mode == 3:
        J20_fact = T * neq_fact
        J10 = torch.zeros_like(neq)
        if cfg.include_baryon:
            J10 = neq_fact * g * thermal.J10_integral(r1, w1, mbar, aB, b, sgn)
        J20 = J20_fact * g * thermal.J20_integral(r2, w2, mbar, aB, b, sgn)
        bulk_density = (neq + b * J10 * G[:, None]
                        + J20 * F[:, None] / T / T) / betabulk[:, None]
        return torch.where(breaks, 2.0 * neq,
                           bulkPi[:, None] * bulk_density + neq)
    if cfg.df_mode == 4:
        neq0 = neq_fact * g * thermal.neq_integral(
            r1, w1, mbar, torch.zeros_like(aB), torch.zeros_like(b), sgn)
        return torch.where(breaks, 2.0 * neq, z[:, None] * neq0)
    raise ValueError("exact rates support df_mode 1-4")


def exact_rates(setup: SamplerSetup, species: SpeciesArrays, cfg: Config,
                laguerre: GaussLaguerre) -> torch.Tensor:
    """The exact-mode rates, blocked over cells: in f64 with
    compute_dtype f64, in f32 with f32/f32c (as the JAX package computes
    them on the device there), masked and clipped at 0; returned as f64."""
    c = setup.cells
    dtype = f64 if cfg.compute_dtype == "f64" else f32
    cols = [c.T, c.alphaB, setup.breaks_down, setup.df_cols["bulkPi"],
            setup.fq.z if setup.fq is not None else torch.zeros_like(c.T),
            setup.df_cols["G"], setup.df_cols["F"],
            setup.df_cols["betabulk"]]
    cols = [a if a.dtype == torch.bool else a.to(dtype) for a in cols]
    sp = SpeciesArrays(**{f.name: getattr(species, f.name).to(dtype)
                          for f in dataclasses.fields(SpeciesArrays)})
    quad = [torch.as_tensor(a, dtype=dtype, device=c.T.device)
            for a in (laguerre.roots[1], laguerre.weights[1],
                      laguerre.roots[2], laguerre.weights[2])]
    S = species.mass.shape[0]
    blk = max(1, _RATE_BLOCK_ELEMENTS // (S * quad[0].shape[0]))
    out = []
    for i in range(0, c.n_padded, blk):
        r = _exact_rates(*(a[i:i + blk] for a in cols[:2]), sp,
                         *(a[i:i + blk] for a in cols[2:]), cfg, *quad)
        out.append(torch.clamp(r, min=0.0).to(f64)
                   * c.mask[i:i + blk, None])
    return torch.cat(out)


def prepare_sampler(surf, species_table: SpeciesTable, chosen_idx: np.ndarray,
                    df_data: DeltafData, cfg: Config, laguerre: GaussLaguerre,
                    device, block: int | None = None
                    ) -> tuple[SamplerSetup, SpeciesArrays]:
    """The per-cell sampler state in f64 on ``device``, with the fast
    (cached-density) or exact rates."""
    cells = prepare_cells(surf, cfg, device, block=block or cfg.cell_block)
    species = SpeciesArrays.from_table(species_table, chosen_idx, device)
    c = cells

    basis = lrf.milne_basis(c.tau, c.ux, c.uy, c.un)
    ds = lrf.boost_dsigma(basis, c.tau, c.ux, c.uy, c.un,
                          c.dat, c.dax, c.day, c.dan)
    pi = lrf.boost_shear(basis, c.tau, c.pitt, c.pitx, c.pity, c.pitn,
                         c.pixx, c.pixy, c.pixn, c.piyy, c.piyn, c.pinn)
    Vx_l, Vy_l, Vz_l = lrf.boost_diffusion(basis, c.tau, c.Vt, c.Vx, c.Vy,
                                           c.Vn)

    fq = None
    bulkPi = c.bulkPi
    if cfg.df_mode in (3, 4):
        fq = prepare_feqmod(cells, species, df_data, cfg, laguerre)
        bulkPi = fq.bulkPi

    df = df_data.evaluate(c.T, c.muB, c.E, c.P, bulkPi)
    zeros = torch.zeros_like(c.T)

    # df coefficient columns for w_visc (ParticleSampler.cpp:780-809)
    df_cols = {
        "c0_minus_c2": df.c0 - df.c2,
        "c1": df.c1,
        "fourc2_minus_c0": 4.0 * df.c2 - df.c0,
        "c3": df.c3,
        "c4": df.c4,
        "shear14": df.shear14,
        "two_betapi_T": 2.0 * df.betapi * c.T,
        "three_T": 3.0 * c.T,
        "F_over_T2": df.F / (c.T * c.T),
        "G": df.G,
        "betaV": df.betaV,
        "bulkPi_over_betabulk": bulkPi / torch.where(df.betabulk != 0,
                                                     df.betabulk, 1.0),
        "bulkPi": bulkPi,
        "delta_z_m3dl": df.delta_z - 3.0 * df.delta_lambda,
        "dl_over_T": df.delta_lambda / c.T,
        # raw columns for the exact-rate integrals
        "F": df.F,
        "betabulk": df.betabulk,
    }

    if cfg.df_mode == 3:
        T_mod, alphaB_mod = fq.T_mod, fq.alphaB_mod
        shear_mod = 0.5 / df.betapi
        bulk_mod = bulkPi / (3.0 * df.betabulk)
        diff_mod = c.T / df.betaV
    elif cfg.df_mode == 4:
        T_mod, alphaB_mod = c.T, zeros
        shear_mod = 0.5 / df.betapi
        bulk_mod = df.lam
        diff_mod = zeros
    else:
        T_mod, alphaB_mod = c.T, c.alphaB
        shear_mod = bulk_mod = diff_mod = zeros

    setup = SamplerSetup(
        cells=cells, fq=fq, rates=None,
        dst=ds.t, dsx=ds.x, dsy=ds.y, dsz=ds.z, ds_max=ds.magnitude,
        pixx=pi.xx, pixy=pi.xy, pixz=pi.xz, piyy=pi.yy, piyz=pi.yz, pizz=pi.zz,
        Vx=Vx_l, Vy=Vy_l, Vz=Vz_l, df_cols=df_cols,
        shear_mod=shear_mod, isotropic_scale=1.0 + bulk_mod,
        diff_mod=diff_mod, T_mod=T_mod, alphaB_mod=alphaB_mod,
        breaks_down=(fq.breaks_down if fq is not None
                     else torch.zeros(cells.n_padded, dtype=torch.bool,
                                      device=c.T.device)))
    if cfg.fast:
        rates = _fast_rates(cells, species_table, chosen_idx, fq, cfg)
        setup.rates = torch.clamp(rates, min=0.0) * cells.mask[:, None]
    else:
        setup.rates = exact_rates(setup, species, cfg, laguerre)
    return setup, species


# ----------------------------------------------------------------------
# total yield & event count
# ----------------------------------------------------------------------

def compute_total_yield(surf, species_table: SpeciesTable, chosen_idx,
                        df_data: DeltafData, cfg: Config,
                        laguerre: GaussLaguerre, device) -> float:
    """Mean total yield (calculate_total_yield, ParticleSampler.cpp:447-636)
    from the cached per-species densities at the surface-averaged (T, muB)
    (the reference's estimate_mean_particle_number), in f64 on ``device``."""
    c = prepare_cells(surf, cfg, device, block=cfg.cell_block)

    def d(a):
        return torch.as_tensor(a[chosen_idx], dtype=f64, device=device)

    neq = d(species_table.equilibrium_density)
    basis = lrf.milne_basis(c.tau, c.ux, c.uy, c.un)
    ds = lrf.boost_dsigma(basis, c.tau, c.ux, c.uy, c.un,
                          c.dat, c.dax, c.day, c.dan)
    if cfg.df_mode in (1, 2, 3, 5):
        dnb = d(species_table.bulk_density)
        dnd = d(species_table.diff_density)
        Vdsigma = c.Vt * c.dat + c.Vx * c.dax + c.Vy * c.day + c.Vn * c.dan
        per_cell = (ds.t[:, None] * (neq[None, :] + c.bulkPi[:, None] * dnb[None, :])
                    - ds.space[:, None] * Vdsigma[:, None] * dnd[None, :])
    else:  # PTB (ParticleSampler.cpp:91-104)
        species = SpeciesArrays.from_table(species_table, chosen_idx, device)
        fq = prepare_feqmod(c, species, df_data, cfg, laguerre)
        z_eff = torch.where(fq.breaks_down, 1.0 + fq.delta_z, fq.z)
        per_cell = ds.t[:, None] * z_eff[:, None] * neq[None, :]

    total = torch.sum(per_cell * c.mask[:, None])
    if cfg.dimension == 2:
        total = total * 2.0 * cfg.y_cut
    return float(total)


def number_of_events(Ntot: float, cfg: Config) -> int:
    if not cfg.oversample:
        return 1
    return int(min(np.ceil(cfg.min_num_hadrons / max(Ntot, 1e-300)),
                   cfg.max_num_samples))


# ----------------------------------------------------------------------
# the campaign's device state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ParticleList:
    """Sampled-particle arrays (host numpy); rows with valid=False are not
    particles."""

    valid: np.ndarray
    event: np.ndarray
    mcid: np.ndarray
    tau: np.ndarray
    x: np.ndarray
    y: np.ndarray
    eta: np.ndarray
    t: np.ndarray
    z: np.ndarray
    E: np.ndarray
    px: np.ndarray
    py: np.ndarray
    pz: np.ndarray
    mass: np.ndarray

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


# per-cell columns each mode's hadron pipeline reads (w_visc,
# ParticleSampler.cpp:780-809, and the feqmod rescale)
_DF_COLS_USED = {
    1: ("c0_minus_c2", "c1", "fourc2_minus_c0", "c3", "c4", "shear14",
        "bulkPi"),
    2: ("two_betapi_T", "three_T", "F_over_T2", "G", "betaV",
        "bulkPi_over_betabulk"),
    3: ("two_betapi_T", "three_T", "F_over_T2", "G", "betaV",
        "bulkPi_over_betabulk"),
    4: ("two_betapi_T", "delta_z_m3dl", "dl_over_T"),
    5: ("Bxx", "Bxy", "Bxz", "Byy", "Byz", "Bzz"),   # the famod rescale
}


def _cell_columns(setup: SamplerSetup, cfg: Config) -> dict:
    """The f64 per-cell columns THIS df mode's pipeline gathers per hadron."""
    c = setup.cells
    cols = {"dst": setup.dst, "dsx": setup.dsx, "dsy": setup.dsy,
            "dsz": setup.dsz, "ds_max": setup.ds_max}
    if cfg.df_mode == 5:   # samples at (lambda, b upsilonB); no viscous weight
        cols.update(T_mod=setup.T_mod, alphaB_mod=setup.alphaB_mod)
    else:
        cols.update(T=c.T, pixx=setup.pixx, pixy=setup.pixy,
                    pixz=setup.pixz, piyy=setup.piyy, piyz=setup.piyz,
                    pizz=setup.pizz)
    if cfg.df_mode in (1, 2, 3):   # V.p diffusion terms + baryon chem
        cols.update(alphaB=c.alphaB, Vx=setup.Vx, Vy=setup.Vy, Vz=setup.Vz)
    if cfg.df_mode in (2, 3):
        cols["ratio"] = c.baryon_enthalpy_ratio
    if cfg.df_mode in (3, 4):
        cols.update(breaks=setup.breaks_down.to(f64),
                    shear_mod=setup.shear_mod, iso=setup.isotropic_scale)
    if cfg.df_mode == 3:
        cols.update(diff_mod=setup.diff_mod, alphaB_mod=setup.alphaB_mod,
                    T_mod=setup.T_mod)
    for name in _DF_COLS_USED[cfg.df_mode]:
        cols["df:" + name] = setup.df_cols[name]
    return cols


def envelope_tilt_cells(setup: SamplerSetup, cfg: Config):
    """Per-cell mean of the tilted flux envelope, c = (dst + ds/4)/ds_max
    (f64), or None where the tilt does not apply.

    The flux keep w_flux = max(0, E dst - p.ds_vec)/(E ds_max) is bounded
    pointwise by w_hi(mu) = (dst + ds max(0, mu))/ds_max with
    mu = -phat.dshat.  Drawing the hadron count from lam * c and the
    direction from q(mu) = w_hi(mu)/c, then keeping with w/w_hi, reproduces
    the original kept process exactly (Poisson thinning) while never drawing
    the lanes destined for certain flux rejection.  c ranges from 1
    (timelike-only dsigma) down to 1/4 (spacelike-only).

    df 1/2 only: the df 3/4 momentum rescale mixes directions after the
    draw, so a pre-rescale mu cannot bound the post-rescale flux."""
    if cfg.df_mode not in (1, 2):
        return None
    ds = torch.sqrt(setup.dsx * setup.dsx + setup.dsy * setup.dsy
                    + setup.dsz * setup.dsz)
    return torch.where(setup.ds_max > 0.0,
                       (setup.dst + 0.25 * ds)
                       / torch.clamp(setup.ds_max, min=1e-30), 1.0)


@dataclasses.dataclass
class Campaign:
    """What every chunk of one campaign reads: the per-cell and per-species
    columns in f32, the alias tables and the per-event Poisson means."""

    cfg: Config
    setup: SamplerSetup            # f64
    cols: dict                     # name -> (C,) f32
    mass: torch.Tensor             # (S,) f32
    sign: torch.Tensor
    baryon: torch.Tensor
    mcid: torch.Tensor             # (S,) int64
    prob: torch.Tensor             # (C*S,) f32 alias acceptance
    alias: torch.Tensor            # (C*S,) int32 alias species
    lam_1ev: torch.Tensor          # (C,) f64 drawn hadrons per event
    n_species: int

    @property
    def mean_1ev(self) -> float:
        return float(self.lam_1ev.sum())


def species_alias(rates: torch.Tensor):
    """Walker alias tables of the per-cell species categorical, built once
    per campaign on the host by the native builder and uploaded: (prob
    (C*S,) f32, alias (C*S,) int32), on the rates' device."""
    prob, alias = build_alias_tables(rates.cpu().numpy())
    dev = rates.device
    return (torch.from_numpy(prob.reshape(-1)).to(dev),
            torch.from_numpy(alias.reshape(-1)).to(dev))


def prepare_campaign(setup: SamplerSetup, species: SpeciesArrays, mcid,
                     cfg: Config) -> Campaign:
    device = setup.rates.device
    prob, alias = species_alias(setup.rates)
    y_max = cfg.y_cut if cfg.dimension == 2 else 0.5
    lam_1ev = setup.rates.sum(dim=1) * (2.0 * y_max * setup.ds_max)
    tilt = envelope_tilt_cells(setup, cfg)
    if tilt is not None:
        lam_1ev = lam_1ev * tilt
    return Campaign(
        cfg=cfg, setup=setup,
        cols={k: v.to(f32) for k, v in _cell_columns(setup, cfg).items()},
        mass=species.mass.to(f32), sign=species.sign.to(f32),
        baryon=species.baryon.to(f32),
        mcid=torch.as_tensor(np.asarray(mcid), dtype=torch.int64,
                             device=device),
        prob=prob, alias=alias, lam_1ev=lam_1ev,
        n_species=int(species.mass.shape[0]))


# ----------------------------------------------------------------------
# ids packed into one 32-bit lane
# ----------------------------------------------------------------------

def pack_bits(n_cells: int, n_species: int, events_per_chunk: int):
    """(cell_bits, sp_bits, ev_bits) when the three id ranges fit 32 bits
    together, else None."""
    bits = tuple(max(n - 1, 1).bit_length()
                 for n in (n_cells, n_species, events_per_chunk))
    return bits if sum(bits) <= 32 else None


def pack_ids(cell_idx, sp_idx, event, pack: tuple) -> torch.Tensor:
    """(cell, species, chunk-relative event) -> one int32 lane holding the
    u32 (cell | sp << cell_bits | event << cell_bits+sp_bits)."""
    cb, sb, eb = pack
    u = (cell_idx.to(torch.int64)
         | (sp_idx.to(torch.int64) << cb)
         | (event.to(torch.int64) << (cb + sb)))
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def unpack_ids(packed, pack: tuple, ev0: int = 0):
    """Host (numpy) inverse of pack_ids; adds the chunk's ``ev0`` to the
    relative event ids.  Returns int64 (cell_idx, sp_idx, event)."""
    cb, sb, eb = pack
    p = np.asarray(packed).view(np.uint32)
    cell = (p & np.uint32((1 << cb) - 1)).astype(np.int64)
    sp = ((p >> np.uint32(cb)) & np.uint32((1 << sb) - 1)).astype(np.int64)
    ev = ((p >> np.uint32(cb + sb)) & np.uint32((1 << eb) - 1)).astype(
        np.int64) + int(ev0)
    return cell, sp, ev


# ----------------------------------------------------------------------
# the hadron pipeline, one phase function each
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ChunkStats:
    """Per-campaign counters the pipeline accumulates: device tensors for
    the sums (read once at the end), host ints for the syncs."""

    syncs: int = 0
    chunks: int = 0
    prep_seconds: float = 0.0       # setup, alias tables (host clock)
    drawn: int = 0
    kept: int = 0
    largest_chunk: int = 0
    mom_proposals: torch.Tensor | int = 0
    mom_acceptances: torch.Tensor | int = 0
    dropped: torch.Tensor | int = 0

    def read(self, t) -> int:
        """One device -> host read of a scalar, counted."""
        self.syncs += 1
        return int(t)


def chunk_generator(seed: int, chunk: int, device) -> torch.Generator:
    """The generator of one chunk, seeded from (campaign seed, chunk)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0x7FFFFFFF) * 1_000_003 + chunk)
                  & 0x7FFFFFFFFFFFFFFF)
    return g


def draw_counts(camp: Campaign, n_ev: int, gen, stats: ChunkStats):
    """Poisson hadron count per cell for ``n_ev`` events (f64 means), run-
    length decoded: (cell_idx (n,) int64, n).  By Poisson splitting this is
    the reference's event-by-event Poisson(dn_tot) + categorical species
    pick, with events assigned uniformly per hadron."""
    lam = camp.lam_1ev * float(n_ev)
    counts = torch.poisson(lam, generator=gen).to(torch.int64)
    n = stats.read(counts.sum())
    cells = torch.arange(counts.shape[0], device=counts.device)
    return torch.repeat_interleave(cells, counts, output_size=n), n


def draw_species(camp: Campaign, cell_idx, gen) -> torch.Tensor:
    """Walker alias draw of each hadron's species from its cell's table:
    two gathers per hadron."""
    S = camp.n_species
    u = torch.rand((2, cell_idx.shape[0]), generator=gen, dtype=f32,
                   device=cell_idx.device)
    # u*S rounding can hit S at u -> 1-ulp: clamp
    j = torch.clamp((u[0] * S).to(torch.int64), max=S - 1)
    pidx = cell_idx * S + j
    return torch.where(u[1] < camp.prob[pidx], j, camp.alias[pidx].to(torch.int64))


def gather_hadrons(camp: Campaign, cell_idx, sp_idx) -> dict:
    """The per-cell columns and the species' mass, sign and baryon number
    at hadron width (f32)."""
    h = {k: v[cell_idx] for k, v in camp.cols.items()}
    h.update(mass=camp.mass[sp_idx], sign=camp.sign[sp_idx],
             baryon=camp.baryon[sp_idx])
    return h


def _rejection_rounds(gen, mbar, mbar2, sign, chem, light, weq_max,
                      max_rounds: int, stop_count: int, stats: ChunkStats):
    """All-lanes rejection rounds until fewer than ``stop_count`` lanes are
    unaccepted (read every ROUND_BLOCK rounds) or ``max_rounds`` ran.
    Returns dimensionless (accepted, pbar, Ebar, phi2pi, costh, feq,
    proposals per lane)."""
    n = mbar.shape[0]
    dev = mbar.device
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    pbar = torch.zeros(n, dtype=f32, device=dev)
    Ebar = torch.ones(n, dtype=f32, device=dev)
    phi2pi = torch.zeros(n, dtype=f32, device=dev)
    costh = torch.zeros(n, dtype=f32, device=dev)
    feq = torch.zeros(n, dtype=f32, device=dev)
    prop = torch.zeros(n, dtype=torch.int32, device=dev)
    wsum = mbar2 + 2.0 * mbar + 2.0
    rnd = 0
    while rnd < max_rounds:
        for _ in range(min(ROUND_BLOCK, max_rounds - rnd)):
            u = torch.rand((7, n), generator=gen, dtype=f32, device=dev)
            l1, l2, l3 = torch.log(1.0 - u[0]), torch.log(1.0 - u[1]), \
                torch.log(1.0 - u[2])

            # light branch (p^2 exp(-p) proposal)
            pbar_l = -(l1 + l2 + l3)
            Ebar_l = torch.sqrt(pbar_l * pbar_l + mbar2)
            # overflow-safe: feq = exp(-E)/(1+s exp(-E)); 1/(r1 r2 r3) = exp(p)
            den_l = 1.0 + sign * torch.exp(-Ebar_l)
            feq_l = torch.exp(-Ebar_l) / den_l
            w_l = torch.exp(pbar_l - Ebar_l) / den_l / weq_max
            phi_l = (l1 + l2) ** 2 / (pbar_l * pbar_l)
            cos_l = (l1 - l2) / (l1 + l2)

            # heavy branch (k = E - m decomposition), distribution chosen
            # with weights (mbar^2, 2 mbar, 2)
            usel = u[3] * wsum
            case0 = usel < mbar2
            case1 = ~case0 & (usel < mbar2 + 2.0 * mbar)
            kbar1 = -(l1 + l2)
            kbar = torch.where(case0, -l1, torch.where(case1, kbar1, pbar_l))
            phi1 = -l1 / torch.where(kbar1 != 0.0, kbar1, 1.0)
            phi2 = (l1 + l2) ** 2 / torch.where(pbar_l != 0.0,
                                                pbar_l * pbar_l, 1.0)
            phi_h = torch.where(case0, u[4], torch.where(case1, phi1, phi2))
            cos_h = torch.where(case0 | case1, 2.0 * u[5] - 1.0, cos_l)
            Ebar_h = kbar + mbar
            pbar_h = torch.sqrt(torch.clamp(Ebar_h * Ebar_h - mbar2, min=0.0))
            # overflow-safe: boltz*feq = 1/(1+s exp(-(E-chem)))
            t_h = Ebar_h - chem
            den_h = 1.0 + sign * torch.exp(-t_h)
            feq_h = torch.exp(-t_h) / den_h
            w_h = pbar_h / torch.where(Ebar_h != 0.0, Ebar_h, 1.0) / den_h

            acc_now = (u[6] < torch.where(light, w_l, w_h)) & ~accepted
            prop += (~accepted).to(torch.int32)
            pbar = torch.where(acc_now, torch.where(light, pbar_l, pbar_h), pbar)
            Ebar = torch.where(acc_now, torch.where(light, Ebar_l, Ebar_h), Ebar)
            phi2pi = torch.where(acc_now, torch.where(light, phi_l, phi_h),
                                 phi2pi)
            costh = torch.where(acc_now, torch.where(light, cos_l, cos_h), costh)
            feq = torch.where(acc_now, torch.where(light, feq_l, feq_h), feq)
            accepted |= acc_now
            rnd += 1
        if stats.read((~accepted).sum()) <= stop_count:
            break
    return accepted, pbar, Ebar, phi2pi, costh, feq, prop


def sample_momentum(mass, sign, T, chem, gen, stats: ChunkStats,
                    rounds_phase1: int = 30, rounds_phase2: int = 200,
                    straggler_frac: int = 16):
    """Rejection sampling of the LRF momentum (sample_momentum,
    ParticleSampler.cpp:243-405), f32.

    An all-lanes loop is tail-dominated: the last low-acceptance lanes
    force many extra full-width rounds.  So full-width rounds run only
    until the unaccepted lanes number at most n/straggler_frac; then those
    lanes (all of them: their count is known exactly) are compacted and
    drawn to completion.  Lanes still unaccepted after rounds_phase2 rounds
    are dropped (the caller counts them).  Returns (E, px, py, pz, feq,
    accepted, proposals, acceptances) in GeV; the last two are device
    scalars."""
    mbar = (mass / T).to(f32)
    mbar2 = mbar * mbar
    sign = sign.to(f32)
    chem = chem.to(f32)
    n = mbar.shape[0]
    light = mbar < 1.008
    use_pion_rescale = (mbar < 0.8554) & (sign == -1.0)
    weq_max = torch.where(use_pion_rescale, pion_thermal_weight_max(mbar),
                          1.0).to(f32)

    m = max(1024, n // straggler_frac)
    # small chunks skip the compaction phase: one loop to the phase-2 budget
    two_phase = m < n
    accepted, pbar, Ebar, phi2pi, costh, feq, prop = _rejection_rounds(
        gen, mbar, mbar2, sign, chem, light, weq_max,
        rounds_phase1 if two_phase else rounds_phase2,
        m if two_phase else 0, stats)

    if two_phase:
        idx = torch.nonzero(~accepted).squeeze(1)
        stats.syncs += 1
        if idx.numel():
            acc2, pbar2, Ebar2, phi2, cos2, feq2, prop2 = _rejection_rounds(
                gen, mbar[idx], mbar2[idx], sign[idx], chem[idx], light[idx],
                weq_max[idx], rounds_phase2, 0, stats)
            pbar[idx], Ebar[idx], phi2pi[idx] = pbar2, Ebar2, phi2
            costh[idx], feq[idx] = cos2, feq2
            accepted[idx] = acc2
            prop[idx] += prop2

    n_prop = prop.sum(dtype=torch.int64)
    n_acc = accepted.sum(dtype=torch.int64)
    p = pbar * T
    phi = phi2pi * two_pi
    sinth = torch.sqrt(torch.clamp(1.0 - costh * costh, min=0.0))
    E = Ebar * T
    px = p * sinth * torch.cos(phi)
    py = p * sinth * torch.sin(phi)
    pz = p * costh
    return E, px, py, pz, feq, accepted, n_prop, n_acc


def draw_momentum(camp: Campaign, h: dict, gen, stats: ChunkStats) -> dict:
    """The LRF momentum of every hadron, at its mode's sampling temperature
    and chemical potential; for df 1/2 the direction is then redrawn from
    the tilted flux envelope (see envelope_tilt_cells), and ``w_hi`` is the
    bound the keep divides by."""
    cfg = camp.cfg
    baryon = h["baryon"]
    if cfg.df_mode in (1, 2):
        T_s, chem_s = h["T"], baryon * h["alphaB"]
    elif cfg.df_mode == 3:
        # breakdown cells fall back to CE sampling at (T, chem)
        breaks = h["breaks"] > 0.5
        T_s = torch.where(breaks, h["T"], h["T_mod"])
        chem_s = baryon * torch.where(breaks, h["alphaB"], h["alphaB_mod"])
    elif cfg.df_mode == 5:
        # famod samples at (lambda, b upsilonB) (ParticleSampler.cpp:1537)
        T_s, chem_s = h["T_mod"], baryon * h["alphaB_mod"]
    else:
        # PTB samples at (T, 0) always (ParticleSampler.cpp:1018)
        T_s, chem_s = h["T"], torch.zeros_like(h["T"])

    E0, px0, py0, pz0, feq, mom_ok, n_prop, n_acc = sample_momentum(
        h["mass"], h["sign"], T_s, chem_s, gen, stats)
    stats.mom_proposals = stats.mom_proposals + n_prop
    stats.mom_acceptances = stats.mom_acceptances + n_acc
    mom = {"E0": E0, "feq": feq, "ok": mom_ok, "w_hi": None}

    if cfg.df_mode in (1, 2):
        # mu = phat.a, a = -dshat, from q(mu) ~ dst + ds max(0, mu);
        # azimuth uniform about a
        dst, dsx, dsy, dsz = h["dst"], h["dsx"], h["dsy"], h["dsz"]
        ds = torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz)
        inv_ds = 1.0 / torch.clamp(ds, min=1e-30)
        # ds -> 0 (timelike-only dsigma): q is uniform; any axis serves
        tiny = ds < 1e-12
        ax = torch.where(tiny, 0.0, -dsx * inv_ds)
        ay = torch.where(tiny, 0.0, -dsy * inv_ds)
        az = torch.where(tiny, 1.0, -dsz * inv_ds)
        u = torch.rand((2, E0.shape[0]), generator=gen, dtype=f32,
                       device=E0.device)
        # CDF inversion of q: linear branch for mu < 0, quadratic for
        # mu >= 0 by the cancellation-stable (Citardauq) root
        t = u[0] * (2.0 * dst + 0.5 * ds)
        mu_neg = t / torch.clamp(dst, min=1e-30) - 1.0
        tp = t - dst
        disc = dst * dst + 2.0 * ds * tp
        mu_pos = 2.0 * tp / (dst + torch.sqrt(torch.clamp(disc, min=0.0)))
        mu = torch.clamp(torch.where(t <= dst, mu_neg, mu_pos), -1.0, 1.0)
        # branchless orthonormal frame about a (Duff et al. 2017)
        sz = torch.where(az >= 0.0, 1.0, -1.0)
        aa = -1.0 / (sz + az)
        bb = ax * ay * aa
        e1x, e1y, e1z = 1.0 + sz * ax * ax * aa, sz * bb, -sz * ax
        e2x, e2y, e2z = bb, sz + ay * ay * aa, -ay
        psi = float(np.float32(2.0 * np.pi)) * u[1]
        cpsi, spsi = torch.cos(psi), torch.sin(psi)
        st = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
        pmag = torch.sqrt(px0 * px0 + py0 * py0 + pz0 * pz0)
        px0 = pmag * (mu * ax + st * (cpsi * e1x + spsi * e2x))
        py0 = pmag * (mu * ay + st * (cpsi * e1y + spsi * e2y))
        pz0 = pmag * (mu * az + st * (cpsi * e1z + spsi * e2z))
        mom["w_hi"] = (dst + ds * torch.clamp(mu, min=0.0)) \
            / torch.clamp(h["ds_max"], min=1e-30)
    mom.update(px0=px0, py0=py0, pz0=pz0)
    return mom


def keep_hadrons(camp: Campaign, h: dict, mom: dict, gen) -> dict:
    """The feqmod momentum rescale (df 3/4; rescale_momentum,
    ParticleSampler.cpp:407-426) or the famod one (df 5), the viscous
    weight (ParticleSampler.cpp:947-1047; famod keeps by the flux weight
    alone, :1546-1551) and the flux keep.  Returns the LRF momentum (E, px,
    py, pz) and the keep mask."""
    df_mode = camp.cfg.df_mode
    E0, px0, py0, pz0 = mom["E0"], mom["px0"], mom["py0"], mom["pz0"]
    mass, sign, baryon = h["mass"], h["sign"], h["baryon"]
    mass2 = mass * mass

    def gd(name):
        return h["df:" + name]

    if df_mode == 5:
        # p = B p' (rescale_momentum_famod, ParticleSampler.cpp:428-444);
        # B is the identity on breakdown cells
        px = gd("Bxx") * px0 + gd("Bxy") * py0 + gd("Bxz") * pz0
        py = gd("Bxy") * px0 + gd("Byy") * py0 + gd("Byz") * pz0
        pz = gd("Bxz") * px0 + gd("Byz") * py0 + gd("Bzz") * pz0
        E = torch.sqrt(mass2 + px * px + py * py + pz * pz)
        return _flux_keep(h, mom, E, px, py, pz, 1.0, gen)

    pixx, pixy, pixz = h["pixx"], h["pixy"], h["pixz"]
    piyy, piyz, pizz = h["piyy"], h["piyz"], h["pizz"]
    if df_mode in (3, 4):
        breaks = h["breaks"] > 0.5
        shear_mod, iso = h["shear_mod"], h["iso"]
        rx = iso * px0 + shear_mod * (pixx * px0 + pixy * py0 + pixz * pz0)
        ry = iso * py0 + shear_mod * (pixy * px0 + piyy * py0 + piyz * pz0)
        rz = iso * pz0 + shear_mod * (pixz * px0 + piyz * py0 + pizz * pz0)
        if df_mode == 3:   # PTB has no diffusion rescale term
            dmod = h["diff_mod"] * (E0 * h["ratio"] + baryon)
            rx = rx + dmod * h["Vx"]
            ry = ry + dmod * h["Vy"]
            rz = rz + dmod * h["Vz"]
        rE = torch.sqrt(mass2 + rx * rx + ry * ry + rz * rz)
        px = torch.where(breaks, px0, rx)
        py = torch.where(breaks, py0, ry)
        pz = torch.where(breaks, pz0, rz)
        E = torch.where(breaks, E0, rE)
    else:
        px, py, pz, E = px0, py0, pz0, E0

    feqbar = 1.0 - sign * mom["feq"]
    pimunu_pp = (px0 * px0 * pixx + py0 * py0 * piyy + pz0 * pz0 * pizz
                 + 2.0 * (px0 * py0 * pixy + px0 * pz0 * pixz
                          + py0 * pz0 * piyz))
    if df_mode in (1, 2, 3):
        Vmu_pmu = -(px0 * h["Vx"] + py0 * h["Vy"] + pz0 * h["Vz"])
    if df_mode == 1:
        df_shear = pimunu_pp / gd("shear14")
        df_bulk = (gd("c0_minus_c2") * mass2
                   + (baryon * gd("c1") + gd("fourc2_minus_c0") * E0) * E0) \
            * gd("bulkPi")
        df_diff = (baryon * gd("c3") + gd("c4") * E0) * Vmu_pmu
        w_visc = (1.0 + torch.clamp(feqbar * (df_shear + df_bulk + df_diff),
                                    -1.0, 1.0)) / 2.0
    elif df_mode in (2, 3):
        df_shear = pimunu_pp / (gd("two_betapi_T") * E0)
        df_bulk = (baryon * gd("G") + gd("F_over_T2") * E0
                   + (E0 - mass2 / E0) / gd("three_T")) \
            * gd("bulkPi_over_betabulk")
        df_diff = (h["ratio"] - baryon / E0) * Vmu_pmu / gd("betaV")
        w_visc = (1.0 + torch.clamp(feqbar * (df_shear + df_bulk + df_diff),
                                    -1.0, 1.0)) / 2.0
        if df_mode == 3:   # CE fallback weight on breakdown cells, else 1
            w_visc = torch.where(breaks, w_visc, 1.0)
    else:
        df_shear = feqbar * pimunu_pp / (gd("two_betapi_T") * E0)
        df_bulk = gd("delta_z_m3dl") \
            + feqbar * gd("dl_over_T") * (E0 - mass2 / E0)
        w_j = (1.0 + torch.clamp(df_shear + df_bulk, -1.0, 1.0)) / 2.0
        w_visc = torch.where(breaks, w_j, 1.0)
    return _flux_keep(h, mom, E, px, py, pz, w_visc, gen)


def _flux_keep(h: dict, mom: dict, E, px, py, pz, w_visc, gen) -> dict:
    """The flux weight and the keep draw against w_flux * w_visc."""
    w_flux = torch.clamp(E * h["dst"] - px * h["dsx"] - py * h["dsy"]
                         - pz * h["dsz"], min=0.0) / (E * h["ds_max"])
    u_keep = torch.rand(E.shape[0], generator=gen, dtype=f32, device=E.device)
    if mom["w_hi"] is not None:
        # tilted envelope: acceptance w / w_hi(mu) (w <= w_hi pointwise)
        u_keep = u_keep * mom["w_hi"]
    keep = mom["ok"] & (u_keep < w_flux * w_visc)
    return {"E": E, "px": px, "py": py, "pz": pz, "keep": keep}


def rap_seed(seed: int, ev0: int) -> int:
    """Seed of the host rapidity stream of the lean chunk starting at event
    ``ev0`` (the JAX package's _rap_meta)."""
    return (int(seed) & 0x7FFFFFFF) * 1_000_003 + int(ev0)


def finalize(camp: Campaign, h: dict, kin: dict, cell_idx, sp_idx, gen,
             n_ev: int, ev0: int, stats: ChunkStats, lean: bool,
             pack: tuple | None, seed: int) -> dict:
    """Compact to the kept rows (their count is read back once) and draw
    each kept hadron's event.

    Lean: the LRF momenta and the ids (packed into one 32-bit column when
    ``pack`` is given, chunk-relative events) plus the (C,) cell tables; the
    lab boost and the rapidity draw are the host collector's
    (ChunkCollector).  Full: the lab-frame Milne kinematics on the device
    (Momentum.cpp:14-31 and the 2+1d rapidity draw,
    ParticleSampler.cpp:1059-1104), which the histogram binner needs."""
    cfg = camp.cfg
    idx = torch.nonzero(kin["keep"]).squeeze(1)
    stats.syncs += 1
    kept = idx.numel()
    event = torch.randint(0, n_ev, (kept,), generator=gen,
                          device=idx.device)
    ci, sp = cell_idx[idx], sp_idx[idx]
    px, py, pz = kin["px"][idx], kin["py"][idx], kin["pz"][idx]
    c = camp.setup.cells
    out = {"ev0": ev0, "n_ev": n_ev, "kept": kept, "mcid": camp.mcid,
           "mass_tab": camp.mass}
    if lean:
        if pack is not None:
            out["ids_packed"] = pack_ids(ci, sp, event, pack)
            out["pack_bits"] = pack
        else:
            out.update(event=(event + ev0).to(torch.int32),
                       sp_idx=sp.to(torch.int32), cell_idx=ci.to(torch.int32))
        out.update(px=px, py=py, pz=pz, dimension=cfg.dimension,
                   y_max=cfg.y_cut, rap_seed=rap_seed(seed, ev0),
                   **{f"cell_{k}": getattr(c, a).to(f32) for k, a in (
                       ("tau", "tau"), ("x", "x"), ("y", "y_pos"),
                       ("eta", "eta"), ("ux", "ux"), ("uy", "uy"),
                       ("un", "un"))})
        return out

    rap_u = torch.rand(kept, generator=gen, dtype=f32, device=idx.device) \
        if cfg.dimension == 2 else None
    E, mass = kin["E"][idx], h["mass"][idx]
    tau_h, ux_h, uy_h, un_h, eta_cell, x_h, y_h = (
        getattr(c, a).to(f32)[ci]
        for a in ("tau", "ux", "uy", "un", "eta", "x", "y_pos"))
    basis = lrf.milne_basis(tau_h, ux_h, uy_h, un_h)
    ptau, plab_x, plab_y, pn = lrf.boost_momentum_to_lab(
        basis, tau_h, ux_h, uy_h, un_h, E, px, py, pz)
    if cfg.dimension == 2:
        rap = cfg.y_cut * (2.0 * rap_u - 1.0)
        sinhy = torch.sinh(rap)
        coshy = torch.sqrt(1.0 + sinhy * sinhy)
        tau_pn = tau_h * pn
        mT = torch.sqrt(torch.clamp(ptau * ptau - tau_pn * tau_pn, min=1e-30))
        eta_p = torch.asinh((ptau * sinhy - tau_pn * coshy) / mT)
        pz_lab = mT * sinhy
        E_lab = mT * coshy
    else:
        sinheta = torch.sinh(eta_cell)
        cosheta = torch.sqrt(1.0 + sinheta * sinheta)
        pz_lab = tau_h * pn * cosheta + ptau * sinheta
        E_lab = torch.sqrt(mass * mass + plab_x**2 + plab_y**2 + pz_lab**2)
        rap = 0.5 * torch.log((E_lab + pz_lab) / (E_lab - pz_lab))
        eta_p = eta_cell
    out.update(event=event + ev0, sp_idx=sp, cell_idx=ci, eta=eta_p,
               px=plab_x, py=plab_y, pz=pz_lab, mass=mass, tau=tau_h, x=x_h,
               y=y_h, t=tau_h * torch.cosh(eta_p), z=tau_h * torch.sinh(eta_p),
               E=E_lab, rapidity=rap)
    return out


def sample_chunk(camp: Campaign, n_ev: int, ev0: int, gen,
                 stats: ChunkStats, lean: bool = False,
                 pack: tuple | None = None, seed: int = 0,
                 mark=None) -> dict:
    """One event chunk through the six phases; ``mark(phase)``, when
    given, is called after each (chip_smoke.py records a CUDA event
    there)."""
    def done(phase):
        if mark is not None:
            mark(phase)

    cell_idx, n = draw_counts(camp, n_ev, gen, stats)
    done("counts")
    sp_idx = draw_species(camp, cell_idx, gen)
    done("species")
    h = gather_hadrons(camp, cell_idx, sp_idx)
    done("gathers")
    mom = draw_momentum(camp, h, gen, stats)
    done("momentum")
    kin = keep_hadrons(camp, h, mom, gen)
    done("weights")
    out = finalize(camp, h, kin, cell_idx, sp_idx, gen, n_ev, ev0, stats,
                   lean, pack, seed)
    done("finalize")
    stats.chunks += 1
    stats.drawn += n
    stats.kept += out["kept"]
    stats.largest_chunk = max(stats.largest_chunk, n)
    stats.dropped = stats.dropped + (~mom["ok"]).sum(dtype=torch.int64)
    return out


def prepare_setup(surf, species_table: SpeciesTable, chosen_idx,
                  df_data: DeltafData, cfg: Config, laguerre: GaussLaguerre,
                  device):
    """The df mode's sampler state: (setup, species, the famod prep's
    Reconstruction for df 5 or None)."""
    if cfg.df_mode != 5:
        return (*prepare_sampler(surf, species_table, chosen_idx, df_data,
                                 cfg, laguerre, device), None)
    from .sampler_famod import prepare_sampler_famod
    from .spectra_famod import Reconstruction
    recon = Reconstruction()
    return (*prepare_sampler_famod(surf, species_table, chosen_idx, cfg,
                                   device, recon), recon)


def chunk_plan(mean_1ev: float, n_events: int, cfg: Config) -> int:
    """Events per chunk: a campaign whose drawn hadrons exceed
    sampler_chunk_hadrons is split into event chunks of at most that many
    drawn hadrons on average."""
    if mean_1ev * n_events > cfg.sampler_chunk_hadrons and n_events > 1:
        return max(1, int(cfg.sampler_chunk_hadrons / max(mean_1ev, 1.0)))
    return n_events


def campaign_seed(cfg: Config, seed: int | None) -> int:
    if seed is not None:
        return int(seed)
    if cfg.sampler_seed >= 0:
        return cfg.sampler_seed
    return int(np.random.SeedSequence().entropy) & 0x7FFFFFFF


def sample_particles(surf, species_table: SpeciesTable, chosen_idx,
                     df_data: DeltafData, cfg: Config,
                     laguerre: GaussLaguerre, n_events: int, device,
                     seed: int | None = None, report=None,
                     chunk_consumer=None, lean: bool = False):
    """Run the sampler over ``n_events`` events.

    With ``chunk_consumer`` each finalized chunk goes to it as it is made
    (the histogram binner, the event-file writer, the collector), and the
    summed diagnostics come back; without, the full-form chunks are
    concatenated and returned (tests, small campaigns)."""
    stats = ChunkStats()
    t0 = time.perf_counter()
    setup, species, recon = prepare_setup(surf, species_table, chosen_idx,
                                          df_data, cfg, laguerre, device)
    camp = prepare_campaign(setup, species, species_table.mc_id[chosen_idx],
                            cfg)
    stats.prep_seconds = time.perf_counter() - t0
    seed = campaign_seed(cfg, seed)
    per_chunk = chunk_plan(camp.mean_1ev, n_events, cfg)
    n_chunks = -(-n_events // per_chunk)
    pack = pack_bits(setup.cells.n_padded, camp.n_species, per_chunk) \
        if lean else None

    chunks = []
    for c in range(n_chunks):
        ev0 = c * per_chunk
        ch = sample_chunk(camp, min(per_chunk, n_events - ev0), ev0,
                          chunk_generator(seed, c, device), stats, lean,
                          pack, seed)
        if chunk_consumer is not None:
            chunk_consumer(ch)
        else:
            chunks.append(ch)
    diags = {"drawn": stats.drawn, "kept": stats.kept,
             "mom_proposals": int(stats.mom_proposals),
             "mom_acceptances": int(stats.mom_acceptances),
             "dropped": int(stats.dropped), "syncs": stats.syncs,
             "chunks": stats.chunks, "largest_chunk": stats.largest_chunk,
             "prep_seconds": stats.prep_seconds,
             "events_per_chunk": per_chunk}
    if report is not None:
        report.n_cells = surf.n_cells
        report.mom_proposals = diags["mom_proposals"]
        report.mom_acceptances = diags["mom_acceptances"]
        report.hadrons_drawn = diags["drawn"]
        report.hadrons_kept = diags["kept"]
        report.dropped_lanes = diags["dropped"]
        report.sampler_chunks = stats.chunks
        report.sampler_syncs = stats.syncs
        report.largest_chunk = stats.largest_chunk
        report.sampler_prep_seconds = stats.prep_seconds
        if cfg.df_mode in (3, 4, 5):
            report.record_breakdown(setup.breaks_down, setup.cells.tau,
                                    setup.cells.mask)
        if recon is not None:
            report.reconstruction = recon
    if chunk_consumer is not None:
        return diags
    out = {k: (torch.cat([ch[k] for ch in chunks])
               if k not in ("mcid", "mass_tab") else chunks[0][k])
           for k in chunks[0] if isinstance(chunks[0][k], torch.Tensor)}
    out.update(diags)
    return out


def _to_host(t, pinned: bool):
    """Start the copy of ``t`` to host memory: pinned and asynchronous from
    a CUDA tensor, else as it is."""
    if t.device.type != "cuda" or not pinned:
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class ChunkCollector:
    """Chunk consumer for the particle-list paths (lean chunks): brings
    each chunk to host numpy, rebuilds the columns that need not cross the
    link -- mass = mass_tab[sp_idx], tau/x/y = cell_table[cell_idx],
    t/z = tau cosh/sinh(eta), E = sqrt(m^2 + p^2) -- and boosts the LRF
    momenta to the lab frame on the host (_boost_lrf_to_lab).  16 B cross
    per kept hadron with packed ids (px, py, pz, ids), 24 without.

    ``stage(ch)`` starts the chunk's device -> host copies into pinned
    memory and records a CUDA event after them (main thread); ``collect``
    waits for that event and does the host work, so a writer thread can
    collect chunk i while the device computes chunk i+1.  Calling the
    collector does both."""

    _CELL = ("cell_tau", "cell_x", "cell_y", "cell_eta", "cell_ux",
             "cell_uy", "cell_un")
    _FIELDS = ("event", "sp_idx", "tau", "x", "y", "eta", "px", "py", "pz",
               "mass", "t", "z", "E")

    def __init__(self):
        self._parts = []
        self._mcid_table = None
        self._mass_table = None
        self._cell_tables = None

    def stage(self, ch: dict) -> dict:
        pack = ch.get("pack_bits")
        ids = ("ids_packed",) if pack is not None else ("event", "sp_idx",
                                                        "cell_idx")
        staged = {f: _to_host(ch[f], True) for f in ids + ("px", "py", "pz")}
        if self._cell_tables is None:
            self._cell_tables = {n: np.asarray(_to_host(ch[n], False))
                                 for n in self._CELL}
            self._mcid_table = np.asarray(_to_host(ch["mcid"], False))
            self._mass_table = np.asarray(_to_host(ch["mass_tab"], False))
        meta = {k: ch[k] for k in ("pack_bits", "ev0", "n_ev", "dimension",
                                   "y_max", "rap_seed") if k in ch}
        event = None
        if any(isinstance(v, torch.Tensor) and v.is_pinned()
               for v in staged.values()):
            event = torch.cuda.Event()
            event.record()
        return {"host": staged, "meta": meta, "done": event}

    def collect(self, staged: dict) -> dict:
        if staged["done"] is not None:
            staged["done"].synchronize()
        part = {f: np.asarray(v) for f, v in staged["host"].items()}
        meta = staged["meta"]
        pack = meta.get("pack_bits")
        if pack is not None:
            ci, sp, ev = unpack_ids(part.pop("ids_packed"), pack,
                                    ev0=int(meta.get("ev0", 0)))
            part["cell_idx"] = ci.astype(np.int32)
            part["sp_idx"] = sp.astype(np.uint16)
            part["event"] = ev.astype(np.int32)
        ct = self._cell_tables
        dtype = part["px"].dtype
        ci = part.pop("cell_idx")
        part["tau"] = ct["cell_tau"].astype(dtype)[ci]
        part["x"] = ct["cell_x"].astype(dtype)[ci]
        part["y"] = ct["cell_y"].astype(dtype)[ci]
        part["mass"] = self._mass_table.astype(dtype)[part["sp_idx"]]
        self._boost_lrf_to_lab(part, ct, ci, meta, dtype)
        part["t"] = part["tau"] * np.cosh(part["eta"])
        part["z"] = part["tau"] * np.sinh(part["eta"])
        part["E"] = np.sqrt(part["mass"] ** 2 + part["px"] ** 2
                            + part["py"] ** 2 + part["pz"] ** 2)
        self._parts.append(part)
        return part

    def __call__(self, ch: dict) -> None:
        self.collect(self.stage(ch))

    @staticmethod
    def _boost_lrf_to_lab(part, ct, ci, meta, dtype):
        """Lab kinematics from the LRF momenta and the cell flow on the
        host (numpy): the Milne-basis boost of finalize / Momentum.cpp:14-31
        and the 2+1d rapidity draw from np.random.default_rng(rap_seed),
        with the JAX package's operations in its order, so the same inputs
        give the same bits."""
        tau = part["tau"]
        ux = ct["cell_ux"].astype(dtype)[ci]
        uy = ct["cell_uy"].astype(dtype)[ci]
        un = ct["cell_un"].astype(dtype)[ci]
        eta_c = ct["cell_eta"].astype(dtype)[ci]
        E = np.sqrt(part["mass"] ** 2 + part["px"] ** 2 + part["py"] ** 2
                    + part["pz"] ** 2)
        px, py, pz = part["px"], part["py"], part["pz"]
        # Milne tetrad (physics/lrf.milne_basis, numpy form)
        tun = tau * un
        ut = np.sqrt(1.0 + ux * ux + uy * uy + tun * tun)
        uperp = np.sqrt(ux * ux + uy * uy)
        utperp = np.sqrt(1.0 + ux * ux + uy * uy)
        sinhL = tun / utperp
        coshL = ut / utperp
        safe = uperp > 1.0e-5
        inv_up = np.where(safe, 1.0 / np.where(safe, uperp, 1.0), 0.0)
        Xt = uperp * coshL
        Xx = np.where(safe, utperp * ux * inv_up, 1.0)
        Xy = np.where(safe, utperp * uy * inv_up, 0.0)
        Xn = uperp * sinhL / tau
        Yx = np.where(safe, -uy * inv_up, 0.0)
        Yy = np.where(safe, ux * inv_up, 1.0)
        Zt = sinhL
        Zn = coshL / tau
        ptau = E * ut + px * Xt + pz * Zt
        plx = E * ux + px * Xx + py * Yx
        ply = E * uy + px * Xy + py * Yy
        pn = E * un + px * Xn + pz * Zn

        if int(meta.get("dimension", 2)) == 2:
            y_max = float(meta.get("y_max", 5.0))
            rng = np.random.default_rng(int(meta.get("rap_seed", 0)))
            rap = (y_max * (2.0 * rng.random(len(ptau), dtype=np.float32)
                            - 1.0)).astype(dtype)
            sinhy = np.sinh(rap)
            coshy = np.sqrt(1.0 + sinhy * sinhy)
            tau_pn = tau * pn
            mT = np.sqrt(np.maximum(ptau * ptau - tau_pn * tau_pn, 1e-30))
            part["eta"] = np.arcsinh((ptau * sinhy - tau_pn * coshy) / mT)
            part["pz"] = mT * sinhy
        else:
            sinheta = np.sinh(eta_c)
            cosheta = np.sqrt(1.0 + sinheta * sinheta)
            part["pz"] = tau * pn * cosheta + ptau * sinheta
            part["eta"] = eta_c
        part["px"], part["py"] = plx, ply

    def particle_list(self) -> ParticleList:
        cat = {f: np.concatenate([p[f] for p in self._parts])
               for f in self._FIELDS}
        n = cat["event"].shape[0]
        return ParticleList(
            valid=np.ones(n, dtype=bool), event=cat["event"],
            mcid=self._mcid_table[cat["sp_idx"]],
            tau=cat["tau"], x=cat["x"], y=cat["y"], eta=cat["eta"],
            t=cat["t"], z=cat["z"], E=cat["E"],
            px=cat["px"], py=cat["py"], pz=cat["pz"], mass=cat["mass"])


def to_particle_list(out: dict) -> ParticleList:
    """A full-form sampler output (every row kept) as host numpy."""
    def h(k):
        return out[k].cpu().numpy()

    mcid = h("mcid")[h("sp_idx")]
    return ParticleList(
        valid=np.ones(mcid.shape[0], dtype=bool), event=h("event"),
        mcid=mcid, tau=h("tau"), x=h("x"), y=h("y"), eta=h("eta"), t=h("t"),
        z=h("z"), E=h("E"), px=h("px"), py=h("py"), pz=h("pz"),
        mass=h("mass"))
