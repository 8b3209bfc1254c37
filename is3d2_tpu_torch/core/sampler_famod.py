"""famod (df 5) sampler preparation.

Counterpart of is3d2_tpu/core/sampler_famod.py (the per-cell preamble of
sample_dN_pTdpTdphidy_famod, ParticleSampler.cpp:1138-1513): the famod
prep of core/spectra_famod.py (the anisotropic reconstruction), the
rescale matrix B (the identity on breakdown cells) and the anisotropic
densities n_a = g Lambda^3 detA I_100 / (2 pi^2 hbar^3), in f64 on the
run's device.  The sampler (core/sampler.py) then draws at (Lambda,
b upsilonB), rescales p = B p' and keeps by the flux weight alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..constants import two_pi2_hbarC3
from ..io.pdg import SpeciesTable
from ..physics import lrf
from ..physics.aniso import PBAR_PTS, aniso_density_integral
from .sampler import SamplerSetup
from .spectra import SpeciesArrays
from .spectra_famod import (Reconstruction, famod_cells, prepare_famod,
                            vah_from_surface)

# (cells x species x quadrature points) f64 elements of one density block
_DENSITY_BLOCK_ELEMENTS = 1 << 24


def anisotropic_rates(fm, species: SpeciesArrays, mask) -> torch.Tensor:
    """(C, S) mean counts per unit volume n_a (ParticleSampler.cpp:
    1464-1499), clipped at 0 and masked; cell-blocked.  Failed cells keep
    (lambda = T, aT = aL = 1), the equilibrium density."""
    detA = fm.aT * fm.aT * fm.aL
    na_fact = fm.lam ** 3 * detA / two_pi2_hbarC3
    S = species.mass.shape[0]
    blk = max(1, _DENSITY_BLOCK_ELEMENTS // (S * PBAR_PTS))
    out = []
    for i in range(0, fm.lam.shape[0], blk):
        chem = species.baryon[None, :] * fm.upsilonB[i:i + blk, None]
        I100 = aniso_density_integral(fm.lam[i:i + blk], species.mass,
                                      species.sign, chem)
        rates = species.degeneracy[None, :] * na_fact[i:i + blk, None] * I100
        out.append(torch.clamp(rates, min=0.0) * mask[i:i + blk, None])
    return torch.cat(out)


def prepare_sampler_famod(surf, species_table: SpeciesTable, chosen_idx,
                          cfg: Config, device,
                          stats: Reconstruction | None = None
                          ) -> tuple[SamplerSetup, SpeciesArrays]:
    """The per-cell sampler state of df 5 in f64 on ``device``; ``stats``
    collects the reconstruction's seconds and iterations."""
    cells = famod_cells(surf, cfg, device)
    species = SpeciesArrays.from_table(species_table, np.asarray(chosen_idx),
                                       device)
    c = cells

    basis = lrf.milne_basis(c.tau, c.ux, c.uy, c.un)
    ds = lrf.boost_dsigma(basis, c.tau, c.ux, c.uy, c.un,
                          c.dat, c.dax, c.day, c.dan)
    fm = prepare_famod(cells, species_table, cfg,
                       vah_from_surface(surf, cells.n_padded, device), stats)
    breaks = fm.breaks_down

    one = torch.ones_like(fm.Bxx)
    zero = torch.zeros_like(fm.Bxx)
    df_cols = {
        "Bxx": torch.where(breaks, one, fm.Bxx),
        "Bxy": torch.where(breaks, zero, fm.Bxy),
        "Bxz": torch.where(breaks, zero, fm.Bxz),
        "Byy": torch.where(breaks, one, fm.Byy),
        "Byz": torch.where(breaks, zero, fm.Byz),
        "Bzz": torch.where(breaks, one, fm.Bzz),
    }
    zeros = torch.zeros_like(c.T)
    setup = SamplerSetup(
        cells=cells, fq=None, rates=anisotropic_rates(fm, species, c.mask),
        dst=ds.t, dsx=ds.x, dsy=ds.y, dsz=ds.z, ds_max=ds.magnitude,
        pixx=zeros, pixy=zeros, pixz=zeros, piyy=zeros, piyz=zeros,
        pizz=zeros, Vx=zeros, Vy=zeros, Vz=zeros, df_cols=df_cols,
        shear_mod=zeros, isotropic_scale=torch.ones_like(zeros),
        diff_mod=zeros, T_mod=fm.lam, alphaB_mod=fm.upsilonB,
        breaks_down=breaks)
    return setup, species
