"""Shared state for the parity tests of the PyTorch port (tests/test_torch_*).

Builds one small synthetic working directory with the port's builder, reads
it with both packages, and hands the same per-cell state to both engines:
the JAX objects are converted with ``np.asarray`` and fed to the port through
``is3d2_tpu_torch.interop``.  Small shape: 512 cells, 8 species, 16 pT x 8
phi, 24 eta nodes (12 after the fold).

The feqmod cases (df 3/4) use a surface with large viscous corrections
(FEQMOD_SHEAR, FEQMOD_BULK), so that some cells take the breakdown branch;
the famod cases (df 5) an EOS-consistent surface (eos_surface: FAMOD_SHEAR,
FAMOD_BULK) and the JAX package's own f64 famod prep.
Against the JAX kernel in interpret mode they use a milder surface
(MILD_SHEAR) with breakdown forced on every FORCE_EVERY-th cell: on the
large-viscosity surface the JAX kernel's own f32 error is ~1e-4 (ROADMAP
C4), so it cannot hold the port to 1e-5 there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
from pathlib import Path

import numpy as np

from is3d2_tpu.config import Config as JConfig
from is3d2_tpu.core.cells import prepare_cells as j_prepare_cells
from is3d2_tpu.core.spectra import MomentumGridDevice as JGrid
from is3d2_tpu.core.spectra import SpeciesArrays as JSpecies
from is3d2_tpu.core.spectra import df12_cell_coefficients as j_coefficients
from is3d2_tpu.core.feqmod import prepare_feqmod as j_prepare_feqmod
from is3d2_tpu.io.deltaf_tables import DeltafTables as JTables
from is3d2_tpu.io.pdg import read_pdg as j_read_pdg
from is3d2_tpu.io.tables import GaussLaguerre as JLaguerre
from is3d2_tpu.io.tables import MomentumGrids as JGrids
from is3d2_tpu.io.tables import load_table as j_load_table
from is3d2_tpu.physics.deltaf import DeltafData as JDeltafData

from is3d2_tpu_torch import interop
from is3d2_tpu_torch.io.pdg import read_pdg
from is3d2_tpu_torch.io.tables import GaussLaguerre
from is3d2_tpu_torch.tools.synthetic import (make_eos_consistent,
                                             make_surface, write_workdir)

CHOSEN = (211, -211, 111, 321, -321, 2212, -2212, 3122)
N_CELLS = 512
BLOCK = 128
FEQMOD_SHEAR = 0.2
FEQMOD_BULK = 0.1
MILD_SHEAR = 0.05
FORCE_EVERY = 5

# the df 1/2 cases: name -> (df_mode, include_baryon, shear_scale, extra cfg)
DF12_CASES = {
    "df1": (1, False, 0.02, {}),
    "df2": (2, False, 0.02, {}),
    "df1-regulate": (1, False, 0.03, {"regulate_deltaf": 1}),
    "df2-regulate-outflow": (2, False, 0.03, {"regulate_deltaf": 1, "outflow": 1}),
    "df1-outflow": (1, False, 0.02, {"outflow": 1}),
    "df1-baryon-diffusion": (1, True, 0.02, {}),
    "df2-baryon-diffusion": (2, True, 0.02, {}),
}


def build_workdir(root: Path, params: dict | None = None,
                  include_baryon: bool = False, n_eta: int = 24,
                  **surface_kw) -> Path:
    """The small workdir; delta-f tables on a coarse (T, muB) grid.
    ``surface_kw`` (shear_scale, bulk_scale) go to make_surface."""
    return write_workdir(root, n_cells=N_CELLS, seed=3, chosen_mcids=CHOSEN,
                         n_pT=16, n_phi=8, n_eta=n_eta, params=params,
                         include_baryon=include_baryon, n_T=21, n_muB=9,
                         **surface_kw)


def jax_config(df_mode: int, include_baryon: bool = False, **kw) -> JConfig:
    return JConfig(operation=1, df_mode=df_mode, hrg_eos=3,
                   include_baryon=int(include_baryon),
                   include_baryondiff_deltaf=int(include_baryon),
                   include_shear_deltaf=1, include_bulk_deltaf=1,
                   cell_block=BLOCK, **kw)


@dataclasses.dataclass
class CaseState:
    """One case: JAX engine state and the same state as port tensors."""

    cfg: JConfig
    j_cells: object
    j_coeffs: dict
    j_species: object
    j_grid: object
    cells: object        # port CellArrays (cpu)
    coeffs: dict
    species: object
    grid: object


def numpy_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def case_state(workdir: Path, df_mode: int, include_baryon: bool = False,
               shear_scale: float = 0.02, dimension: int = 2,
               **cfg_kw) -> CaseState:
    """``dimension`` 3 takes a make_surface(dimension=3) surface and the
    workdir's y table."""
    cfg = jax_config(df_mode, include_baryon, dimension=dimension, **cfg_kw)
    species_t = j_read_pdg(3, workdir / "PDG")
    chosen = species_t.chosen_indices(
        j_load_table(workdir / "PDG/chosen_particles.dat")[:, 0].astype(int))
    grids = JGrids.from_dir(workdir / "tables")
    tables = JTables.load(3, include_baryon, workdir / "deltaf_coefficients/vh")
    df_data = JDeltafData(tables, df_mode, include_baryon)
    surf = make_surface(N_CELLS, seed=3, dimension=dimension,
                        include_baryon=include_baryon, shear_scale=shear_scale)
    j_cells = j_prepare_cells(surf, cfg, block=BLOCK)
    j_coeffs = j_coefficients(j_cells, df_data, cfg)
    j_species = JSpecies.from_table(species_t, chosen)
    j_grid = JGrid.from_grids(grids, dimension)
    return CaseState(
        cfg=cfg, j_cells=j_cells, j_coeffs=j_coeffs, j_species=j_species,
        j_grid=j_grid,
        cells=interop.cells_from_numpy(numpy_fields(j_cells)),
        coeffs=interop.coeffs_from_numpy(
            {k: np.asarray(v) for k, v in j_coeffs.items()}),
        species=interop.species_from_numpy(numpy_fields(j_species)),
        grid=interop.grid_from_numpy(numpy_fields(j_grid)))


def port_config(cfg: JConfig):
    """The port's Config with the same field values."""
    from is3d2_tpu_torch.config import Config
    return Config(**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(Config)})


def max_rel_err(out: np.ndarray, ref: np.ndarray, floor: float = 1e-4) -> float:
    """Max relative error over the bins that reach ``floor`` of their
    species' peak (axis 0 is the species)."""
    out = np.asarray(out).reshape(ref.shape[0], -1)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    peak = np.abs(ref).max(axis=1, keepdims=True)
    sig = np.abs(ref) >= floor * peak
    return float((np.abs(out - ref)[sig] / np.abs(ref)[sig]).max())


def scale_err(out, ref) -> float:
    """Max |out - ref| over max |ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300))


def chi2_p(a, b, min_count=10):
    """Two-sample chi^2 p-value of two histograms drawn for the same
    number of events (bins with fewer than min_count entries together are
    merged into one): (p, chi2, degrees of freedom)."""
    from scipy import stats
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    big = a + b >= min_count
    aa = np.append(a[big], a[~big].sum())
    bb = np.append(b[big], b[~big].sum())
    keep = aa + bb > 0
    aa, bb = aa[keep], bb[keep]
    chi2 = float(((aa - bb) ** 2 / (aa + bb)).sum())
    return float(stats.chi2.sf(chi2, aa.shape[0])), chi2, aa.shape[0]


@dataclasses.dataclass
class FeqmodState:
    """One df 3/4 case: the JAX feqmod state and the same state as port
    tensors (the port's prep is fed the JAX prep's output)."""

    cfg: JConfig
    plasma: object       # the surface's ThermoAverages (Jonah splines)
    j_df_data: object
    j_laguerre: object
    j_cells: object
    j_fq: object
    j_species: object
    j_grid: object
    cells: object        # port CellArrays (cpu)
    fq: object           # port FeqmodCellData (cpu)
    species: object
    grid: object


def feqmod_state(workdir: Path, df_mode: int, include_baryon: bool = False,
                 shear_scale: float = FEQMOD_SHEAR, force_breaks: bool = False,
                 dimension: int = 2, bulk_scale: float = FEQMOD_BULK,
                 surf=None, **cfg_kw) -> FeqmodState:
    """The JAX package's df 3/4 prep on a make_surface(N_CELLS, seed=3)
    surface (large viscosity by default; ``dimension`` 3 a 3+1d one and
    the workdir's y table), or on ``surf``, in f64, and the same state as
    port tensors.  ``force_breaks`` sends every FORCE_EVERY-th cell to the
    breakdown branch as well."""
    cfg = jax_config(df_mode, include_baryon, dimension=dimension, **cfg_kw)
    species_t = j_read_pdg(3, workdir / "PDG")
    chosen = species_t.chosen_indices(
        j_load_table(workdir / "PDG/chosen_particles.dat")[:, 0].astype(int))
    grids = JGrids.from_dir(workdir / "tables")
    laguerre = JLaguerre.from_file(workdir / "tables/gauss/gla_roots_weights.txt")
    tables = JTables.load(3, include_baryon, workdir / "deltaf_coefficients/vh")
    df_data = JDeltafData(tables, df_mode, include_baryon)
    if surf is None:
        surf = make_surface(N_CELLS, seed=3, include_baryon=include_baryon,
                            shear_scale=shear_scale, bulk_scale=bulk_scale,
                            dimension=dimension)
    plasma = surf.thermo_averages()
    if not include_baryon:   # as the driver does
        df_data.compute_jonah_coefficients(species_t, laguerre, plasma)
    j_cells = j_prepare_cells(surf, cfg, block=BLOCK)
    j_species = JSpecies.from_table(species_t, chosen)
    j_grid = JGrid.from_grids(grids, dimension)
    j_fq = j_prepare_feqmod(j_cells, j_species, df_data, cfg, laguerre)
    if force_breaks:
        every = np.arange(j_cells.n_padded) % FORCE_EVERY == 0
        j_fq = dataclasses.replace(
            j_fq, breaks_down=np.asarray(j_fq.breaks_down) | every)
    return FeqmodState(
        cfg=cfg, plasma=plasma, j_df_data=df_data, j_laguerre=laguerre,
        j_cells=j_cells,
        j_fq=j_fq, j_species=j_species, j_grid=j_grid,
        cells=interop.cells_from_numpy(numpy_fields(j_cells)),
        fq=interop.feqmod_from_numpy(numpy_fields(j_fq)),
        species=interop.species_from_numpy(numpy_fields(j_species)),
        grid=interop.grid_from_numpy(numpy_fields(j_grid)))


# ----------------------------------------------------------------------
# famod (df 5)
# ----------------------------------------------------------------------

# viscous corrections of the famod cases: ~1 % of the cells break down
FAMOD_SHEAR = 0.1
FAMOD_BULK = 0.05


def eos_surface(workdir: Path, n_cells: int = N_CELLS, seed: int = 3,
                shear_scale: float = FAMOD_SHEAR,
                bulk_scale: float = FAMOD_BULK, **kw):
    """make_surface with the HRG (E, P) of the workdir's species list (the
    port's make_eos_consistent), so that the VAH solver can reconstruct
    (E, pl, pt)."""
    surf = make_surface(n_cells, seed=seed, shear_scale=shear_scale,
                        bulk_scale=bulk_scale, **kw)
    return make_eos_consistent(
        surf, read_pdg(3, workdir / "PDG"),
        GaussLaguerre.from_file(workdir / "tables/gauss/gla_roots_weights.txt"))


@dataclasses.dataclass
class FamodState:
    """One df-5 case: the JAX famod state (its f64 prep) and the same state
    as port tensors (the port's prep is fed the JAX prep's output)."""

    cfg: JConfig
    surf: object
    j_species_table: object
    j_cells: object
    j_fm: object
    j_species: object
    j_grid: object
    cells: object        # port CellArrays (cpu)
    fm: object           # port FamodCellData (cpu)
    species: object
    grid: object


def famod_state(workdir: Path, shear_scale: float = FAMOD_SHEAR,
                force_breaks: bool = False, n_cells: int = N_CELLS,
                dimension: int = 2, **cfg_kw) -> FamodState:
    """The JAX package's f64 famod prep (_prepare_famod_host) on
    eos_surface(workdir, n_cells) (``dimension`` 3: a 3+1d one and the
    workdir's y table), and the same state as port tensors.
    ``force_breaks`` sends every FORCE_EVERY-th cell to the breakdown
    branch as well."""
    from is3d2_tpu.core.spectra_famod import prepare_famod as j_prepare_famod
    cfg = jax_config(5, dimension=dimension, **cfg_kw)
    species_t = j_read_pdg(3, workdir / "PDG")
    chosen = species_t.chosen_indices(
        j_load_table(workdir / "PDG/chosen_particles.dat")[:, 0].astype(int))
    grids = JGrids.from_dir(workdir / "tables")
    surf = eos_surface(workdir, n_cells, shear_scale=shear_scale,
                       dimension=dimension)
    j_cells = j_prepare_cells(surf, cfg, block=BLOCK)
    j_fm = j_prepare_famod(j_cells, species_t, cfg)
    if force_breaks:
        every = np.arange(j_cells.n_padded) % FORCE_EVERY == 0
        j_fm = dataclasses.replace(
            j_fm, breaks_down=np.asarray(j_fm.breaks_down) | every)
    j_species = JSpecies.from_table(species_t, chosen)
    j_grid = JGrid.from_grids(grids, dimension)
    return FamodState(
        cfg=cfg, surf=surf, j_species_table=species_t, j_cells=j_cells,
        j_fm=j_fm, j_species=j_species, j_grid=j_grid,
        cells=interop.cells_from_numpy(numpy_fields(j_cells)),
        fm=interop.famod_from_numpy(numpy_fields(j_fm)),
        species=interop.species_from_numpy(numpy_fields(j_species)),
        grid=interop.grid_from_numpy(numpy_fields(j_grid)))


def set_params(wd: Path, params: dict) -> None:
    """Update entries of a workdir's iS3D_parameters.dat."""
    p = wd / "iS3D_parameters.dat"
    kv = dict(line.split(" = ", 1) for line in p.read_text().splitlines())
    kv.update({k: str(v) for k, v in params.items()})
    p.write_text("".join(f"{k} = {v}\n" for k, v in kv.items()))


def polarization_file_errors(jax_wd: Path, port_wd: Path, snorm) -> float:
    """max |P_port - P_jax| / max |P_jax| over the four polarization files,
    on the bins whose (JAX) Snorm (S, NpT, Nphi, Ny) is >= POLZN_P_FLOOR of
    its max; the key columns (y, phi, pT) equal and every value finite."""
    from is3d2_tpu_torch.io import output
    from is3d2_tpu_torch.tools import kernel_check as kc
    good = (snorm > kc.POLZN_P_FLOOR * snorm.max()).transpose(0, 3, 2, 1)
    err = 0.0
    for name in output.POLARIZATION_FILES:
        ref = np.loadtxt(jax_wd / "results" / f"{name}.dat")
        out = np.loadtxt(port_wd / "results" / f"{name}.dat")
        assert out.shape == ref.shape == (good.size, 4), name
        np.testing.assert_array_equal(out[:, :3], ref[:, :3])
        assert np.isfinite(out).all(), name
        sel = good.reshape(-1)
        err = max(err, np.abs(out[sel, 3] - ref[sel, 3]).max()
                  / np.abs(ref[sel, 3]).max())
    return err


def run_drivers(workdir: Path, **fields):
    """The JAX driver's f64 route and the port's driver (on the CPU), in
    memory (write=False) on one workdir whose parameters ``fields``
    update (a ``compute_dtype`` among them the port's only); their logs
    are swallowed.  Returns (JAX run, port run)."""
    from is3d2_tpu.driver import IS3D as JIS3D

    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.driver import IS3D
    path = workdir / "iS3D_parameters.dat"
    jcfg = dataclasses.replace(JConfig.from_file(path), **{
        **fields, "compute_dtype": "f64"})
    cfg = dataclasses.replace(Config.from_file(path), **fields)
    with contextlib.redirect_stdout(io.StringIO()):
        ref = JIS3D(workdir, cfg=jcfg)
        ref.run_particlization(write=False)
        ours = IS3D(workdir, cfg=cfg, device="cpu")
        ours.run_particlization(write=False)
    return ref, ours


def tiny_workdir(root: Path, df_mode: int, compute_dtype: str,
                 **params) -> Path:
    """A 128-cell, 3-species, 8 pT x 4 phi x 8 eta workdir for route
    checks (an EOS-consistent surface for df 5; shear 0.1, bulk 0.05 for
    df 3-5, so that cells break down); ``params`` update its parameters."""
    feqmod = df_mode in (3, 4, 5)
    return write_workdir(
        root, n_cells=128, chosen_mcids=PIKP, n_pT=8, n_phi=4, n_eta=8,
        n_T=21, eos_consistent=df_mode == 5,
        shear_scale=FAMOD_SHEAR if feqmod else 0.02,
        bulk_scale=FAMOD_BULK if feqmod else 0.01,
        params={"cell_block": 128, "df_mode": df_mode,
                "compute_dtype": compute_dtype, **params})


def port_spectra_by_use_pallas(workdir: Path, values=(0, -1), **fields):
    """The port's operation-1 spectra on the CPU (in memory, logs
    swallowed) for each ``use_pallas`` of ``values``, the workdir's
    parameters updated by ``fields``."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.driver import IS3D
    base = dataclasses.replace(
        Config.from_file(workdir / "iS3D_parameters.dat"), **fields)
    out = []
    for value in values:
        cfg = dataclasses.replace(base, use_pallas=value)
        with contextlib.redirect_stdout(io.StringIO()):
            run = IS3D(workdir, cfg=cfg, device="cpu")
            run.run_particlization(write=False)
        out.append(run.spectra)
    return out


# ----------------------------------------------------------------------
# the sampler (operation 2)
# ----------------------------------------------------------------------

PIKP = (211, 321, 2212)
SAMPLER_CELLS = 60


def build_sampler_workdir(root: Path, chosen=PIKP, **kw) -> Path:
    """The sampler tests' workdir: 60 cells of make_surface(seed=3, shear
    0.03, bulk 0.01), pi+ K+ p, a 32 pT x 48 phi grid fine enough for the
    closures against the op-1 spectra."""
    args = dict(n_cells=SAMPLER_CELLS, seed=3, chosen_mcids=chosen, n_pT=32,
                n_phi=48, n_T=21, shear_scale=0.03, bulk_scale=0.01)
    args.update(kw)
    return write_workdir(root, **args)


@dataclasses.dataclass
class SamplerInputs:
    """What sample_particles takes, read from a workdir by one package."""

    surf: object
    species: object
    chosen: np.ndarray
    df_data: object
    laguerre: object
    grids: object


def sampler_inputs(workdir: Path, df_mode: int, jax_side: bool,
                   include_baryon: bool = False,
                   dimension: int = 2) -> SamplerInputs:
    """Read ``workdir`` with the JAX package or the port, build the df
    interpolators (with the Jonah splines when muB = 0) and cache the
    per-species densities on the species table, as each driver does."""
    if jax_side:
        from is3d2_tpu.io.surface import read_surface
        from is3d2_tpu.physics.deltaf import compute_particle_densities
        pdg, tabs, Lag, Grids, Tables, DD = (
            j_read_pdg, j_load_table, JLaguerre, JGrids, JTables, JDeltafData)
    else:
        from is3d2_tpu_torch.io.deltaf_tables import DeltafTables as Tables
        from is3d2_tpu_torch.io.pdg import read_pdg as pdg
        from is3d2_tpu_torch.io.surface import read_surface
        from is3d2_tpu_torch.io.tables import GaussLaguerre as Lag
        from is3d2_tpu_torch.io.tables import MomentumGrids as Grids
        from is3d2_tpu_torch.io.tables import load_table as tabs
        from is3d2_tpu_torch.physics.deltaf import DeltafData as DD
        from is3d2_tpu_torch.physics.deltaf import compute_particle_densities
    species = pdg(3, workdir / "PDG")
    chosen = species.chosen_indices(
        tabs(workdir / "PDG/chosen_particles.dat")[:, 0].astype(int))
    laguerre = Lag.from_file(workdir / "tables/gauss/gla_roots_weights.txt")
    surf = read_surface(workdir / "input/surface.dat", 1, dimension,
                        include_baryon)
    plasma = surf.thermo_averages()
    df_data = DD(Tables.load(3, include_baryon,
                             workdir / "deltaf_coefficients/vh"),
                 df_mode, include_baryon)
    if not include_baryon:
        df_data.compute_jonah_coefficients(species, laguerre, plasma)
    compute_particle_densities(species, df_data, laguerre, plasma)
    return SamplerInputs(surf=surf, species=species, chosen=chosen,
                         df_data=df_data, laguerre=laguerre,
                         grids=Grids.from_dir(workdir / "tables"))
