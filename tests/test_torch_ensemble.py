"""The port's multi-surface ensemble (is3d2_tpu_torch/core/ensemble.py)
against the JAX package's (is3d2_tpu/core/ensemble.py) and against the
port's own single-surface runs, on the CPU.

Every case of tests/test_ensemble.py reads the absent reference directory;
these rebuild them on torch_parity.build_workdir (8 species, 16 pT x 8 phi,
24 eta) and synthetic surfaces of ragged sizes (16, 333 and 512 cells;
cell_block 128, so the JAX ensemble pads them to one count; smaller
surfaces and blocks for df 3-5, whose f64 engines and VAH Newton are slow
on the CPU).

  * spectra, one case per route, held to the JAX compute_spectra_ensemble
    at the bar that route's single-surface parity test uses (quoted at
    SPECTRA_CASES), relative on bins >= 1e-4 of each species' peak;
  * each surface equal to the port's single-surface compute_spectra bit
    for bit, on every route;
  * surface_chunk None, 1 and 2 (a ragged last chunk): equal bits;
    group_particles = 1 gives the ungrouped result;
  * the fold gate and the skipped count from the host columns decide as
    the device read did;
  * the sampler: histograms and particle lists of surface i bit for bit
    those of sample_particles with surface_seed(seed, i); independent of
    surface_chunk; file and row counts; dN/dy per species against the JAX
    sample_ensemble_histograms by a two-sample chi^2 (p > 1e-3), as the
    port's op-2 parity tests hold the JAX sampler; the caller's species
    table left as it was; device=None raises where torch sees no GPU.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (BLOCK, CHOSEN, FAMOD_BULK,  # noqa: E402
                          FAMOD_SHEAR, FEQMOD_BULK, FEQMOD_SHEAR,
                          build_workdir, chi2_p, jax_config, max_rel_err,
                          port_config)

from is3d2_tpu.core import ensemble as j_ens  # noqa: E402
from is3d2_tpu.io.deltaf_tables import DeltafTables as JTables  # noqa: E402
from is3d2_tpu.io.pdg import read_pdg as j_read_pdg  # noqa: E402
from is3d2_tpu.io.tables import GaussLaguerre as JLaguerre  # noqa: E402
from is3d2_tpu.io.tables import MomentumGrids as JGrids  # noqa: E402
from is3d2_tpu.physics.deltaf import DeltafData as JDeltafData  # noqa: E402

from is3d2_tpu_torch.core import ensemble as ens  # noqa: E402
from is3d2_tpu_torch.core.cells import prepare_cells  # noqa: E402
from is3d2_tpu_torch.core.sampler import (sample_particles,  # noqa: E402
                                          surface_seed)
from is3d2_tpu_torch.core.sampler_hist import ChunkBinner  # noqa: E402
from is3d2_tpu_torch.core.spectra import (MomentumGridDevice,  # noqa: E402
                                          compute_spectra, engine_inputs)
from is3d2_tpu_torch.core.spectra_fast import \
    fold_eta_quadrature  # noqa: E402
from is3d2_tpu_torch.io.deltaf_tables import DeltafTables  # noqa: E402
from is3d2_tpu_torch.io.output import StreamingEventWriter  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import (GaussLaguerre,  # noqa: E402
                                       MomentumGrids)
from is3d2_tpu_torch.ops.spectra_fast_common import \
    pack_inputs_comp_3d  # noqa: E402
from is3d2_tpu_torch.physics.deltaf import (DeltafData,  # noqa: E402
                                            compute_particle_densities)
from is3d2_tpu_torch.report import RunReport  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import (make_ensemble,  # noqa: E402
                                             make_eos_consistent,
                                             make_surface)

torch.set_num_threads(1)

SIZES = (16, 333, 512)      # ragged: 128, 384 and 512 padded cells
FEQMOD_SIZES = (16, 100, 120)   # the f64 feqmod and famod engines and the
FAMOD_SIZES = (16, 32, 48)      # VAH Newton are slow on the CPU
FEQMOD_BLOCK = 64
FAMOD_BLOCK = 16    # padding cells take the Newton's 24 iterations
# the 3+1d global measure on surfaces of at least this many cells (below)
GLOBAL_3D_MIN_CELLS = 200
N_Y = 9

# name -> (config fields, surfaces, bar).  The bars are those of each
# route's single-surface parity test against the JAX f64 engine, which is
# what the JAX ensemble runs on every route but 2+1d f32:
#   f64 engines: tests/test_torch_kernel.py (df 1/2, 1e-12),
#     tests/test_torch_feqmod.py and tests/test_torch_famod.py (1e-10);
#   B1 (f32c): tests/test_torch_kernel.py, 1e-6;
#   B2 (f64, use_pallas 1): tests/test_torch_f32_kernel.py, 1e-5;
#   B3 and its famod mode (f32): tests/test_torch_feqmod.py and
#     tests/test_torch_famod.py, 1e-4;
#   2+1d f32: the JAX ensemble runs _spectra_fast_jit (plain f32, ~4.6e-6
#     from f64) and the port B1: the f32 route's bar of
#     tests/test_torch_f32_kernel.py, 1e-5;
#   3+1d f32c: B1's 3+1d mode against the JAX f64 engine, the JAX
#     package's 3+1d budget (tests/test_spectra_golden_3d.py:56-79, as
#     tests/test_torch_3d.py holds the f32c route to the JAX f64 route with
#     baryons): 1e-6 on the bins >= 1e-4 of the largest bin of all
#     species, and 2.5e-7 of each species' peak on every bin (per species
#     the error reaches ~1e-5 where 1 + delta-f cancels, ROADMAP C11).
#     The first holds on surfaces of GLOBAL_3D_MIN_CELLS cells or more:
#     with few cells to average the cancelling bins, a single run of the
#     port is 1.3e-6 off by it on a 16-cell surface and 1.2e-6 on a
#     64-cell one (the second bound holds there at 1.4e-7).
SPECTRA_CASES = {
    "df1-f64": ({"df_mode": 1, "compute_dtype": "f64"}, "mild", 1e-12),
    "df2-f64": ({"df_mode": 2, "compute_dtype": "f64"}, "mild", 1e-12),
    "df2-f64-use_pallas": ({"df_mode": 2, "compute_dtype": "f64",
                            "use_pallas": 1}, "mild", 1e-5),
    "df1-f32c": ({"df_mode": 1, "compute_dtype": "f32c"}, "mild", 1e-6),
    "df1-f32": ({"df_mode": 1, "compute_dtype": "f32"}, "mild", 1e-5),
    "df3-f32": ({"df_mode": 3, "compute_dtype": "f32",
                 "cell_block": FEQMOD_BLOCK}, "feqmod", 1e-4),
    "df4-f32": ({"df_mode": 4, "compute_dtype": "f32",
                 "cell_block": FEQMOD_BLOCK}, "feqmod", 1e-4),
    "df3-f64": ({"df_mode": 3, "compute_dtype": "f64",
                 "cell_block": FEQMOD_BLOCK}, "feqmod", 1e-10),
    "df4-f64": ({"df_mode": 4, "compute_dtype": "f64",
                 "cell_block": FEQMOD_BLOCK}, "feqmod", 1e-10),
    "df5-f32": ({"df_mode": 5, "compute_dtype": "f32",
                 "cell_block": FAMOD_BLOCK}, "eos", 1e-4),
    "df5-f64": ({"df_mode": 5, "compute_dtype": "f64",
                 "cell_block": FAMOD_BLOCK}, "eos", 1e-10),
    "3d-df1-f32c": ({"df_mode": 1, "compute_dtype": "f32c",
                     "dimension": 3}, "3d", 1e-6),
    # 3+1d df 4 / df 5 f32: B3's 3+1d mode (its plain version here), held
    # to the JAX ensemble's f64 engines at B3's bar,
    # tests/test_torch_feqmod_3d.py
    "3d-df4-f32": ({"df_mode": 4, "compute_dtype": "f32", "dimension": 3,
                    "cell_block": FEQMOD_BLOCK}, "3d-feqmod", 1e-4),
    "3d-df5-f32": ({"df_mode": 5, "compute_dtype": "f32", "dimension": 3,
                    "cell_block": FAMOD_BLOCK}, "3d-eos", 1e-4),
}


@dataclasses.dataclass
class Inputs:
    """One workdir read by both packages."""

    species: object
    chosen: np.ndarray
    grids: object
    laguerre: object
    tables: object
    j_species: object
    j_grids: object
    j_laguerre: object
    j_tables: object

    def df_data(self, df_mode: int, plasma=None):
        """Both packages' DeltafData (with the Jonah splines at ``plasma``
        for df 4)."""
        ours = DeltafData(self.tables, df_mode, False)
        ref = JDeltafData(self.j_tables, df_mode, False)
        if df_mode == 4:
            ours.compute_jonah_coefficients(self.species, self.laguerre,
                                            plasma)
            ref.compute_jonah_coefficients(self.j_species, self.j_laguerre,
                                           plasma)
        return ours, ref


def _inputs(wd: Path) -> Inputs:
    species = read_pdg(3, wd / "PDG")
    j_species = j_read_pdg(3, wd / "PDG")
    lag = wd / "tables/gauss/gla_roots_weights.txt"
    return Inputs(
        species=species, chosen=species.chosen_indices(CHOSEN),
        grids=MomentumGrids.from_dir(wd / "tables"),
        laguerre=GaussLaguerre.from_file(lag),
        tables=DeltafTables.load(3, False, wd / "deltaf_coefficients/vh"),
        j_species=j_species, j_grids=JGrids.from_dir(wd / "tables"),
        j_laguerre=JLaguerre.from_file(lag),
        j_tables=JTables.load(3, False, wd / "deltaf_coefficients/vh"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(build_workdir(tmp_path_factory.mktemp("ensemble")))


@pytest.fixture(scope="module")
def inputs_3d(tmp_path_factory):
    return _inputs(build_workdir(tmp_path_factory.mktemp("ensemble_3d"),
                                 dimension=3, n_y=N_Y))


def _surfaces(kind: str, inp: Inputs) -> list:
    if kind == "mild":
        return [make_surface(n, seed=100 + i, shear_scale=0.03,
                             bulk_scale=0.015) for i, n in enumerate(SIZES)]
    if kind == "feqmod":
        return [make_surface(n, seed=200 + i, shear_scale=FEQMOD_SHEAR,
                             bulk_scale=FEQMOD_BULK)
                for i, n in enumerate(FEQMOD_SIZES)]
    if kind == "eos":
        return [make_eos_consistent(
            make_surface(n, seed=300 + i, shear_scale=FAMOD_SHEAR,
                         bulk_scale=FAMOD_BULK), inp.species, inp.laguerre)
            for i, n in enumerate(FAMOD_SIZES)]
    if kind == "3d-feqmod":
        return [make_surface(n, seed=500 + i, dimension=3,
                             shear_scale=FEQMOD_SHEAR, bulk_scale=FEQMOD_BULK)
                for i, n in enumerate(FEQMOD_SIZES)]
    if kind == "3d-eos":
        return [make_eos_consistent(
            make_surface(n, seed=600 + i, dimension=3,
                         shear_scale=FAMOD_SHEAR, bulk_scale=FAMOD_BULK),
            inp.species, inp.laguerre) for i, n in enumerate(FAMOD_SIZES)]
    return [make_surface(n, seed=400 + i, dimension=3)
            for i, n in enumerate(SIZES)]


@dataclasses.dataclass
class SpectraRun:
    cfg: object          # the port's Config
    surfs: list
    df_data: object      # the port's DeltafData
    ours: np.ndarray     # the port's ensemble
    ref: np.ndarray      # the JAX ensemble


@pytest.fixture(scope="module")
def runs(inputs, inputs_3d):
    """Each SPECTRA_CASES case's ensembles, computed once on first use."""
    cache = {}

    def get(case: str) -> SpectraRun:
        if case not in cache:
            fields, kind, _ = SPECTRA_CASES[case]
            inp = inputs_3d if kind.startswith("3d") else inputs
            surfs = _surfaces(kind, inp)
            fields = dict(fields)
            block = fields.pop("cell_block", BLOCK)
            jcfg = dataclasses.replace(jax_config(**fields), cell_block=block)
            cfg = port_config(jcfg)
            df_data, j_df_data = inp.df_data(fields["df_mode"],
                                             surfs[0].thermo_averages())
            ours = ens.compute_spectra_ensemble(
                surfs, inp.species, inp.chosen, inp.grids, df_data, cfg,
                inp.laguerre, device="cpu")
            ref = j_ens.compute_spectra_ensemble(
                surfs, inp.j_species, inp.chosen, inp.j_grids, j_df_data,
                jcfg, inp.j_laguerre)
            cache[case] = SpectraRun(cfg, surfs, df_data, ours,
                                     np.asarray(ref))
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(SPECTRA_CASES))
def test_ensemble_spectra_match_the_jax_ensemble(runs, case):
    r = runs(case)
    bar = SPECTRA_CASES[case][2]
    assert r.ours.shape == r.ref.shape
    assert r.ours.shape[:2] == (len(r.surfs), len(CHOSEN))
    assert np.isfinite(r.ours).all()
    for i in range(len(r.surfs)):
        if r.cfg.dimension == 3 and r.cfg.df_mode in (1, 2):
            assert kc.peak_err(r.ours[i], r.ref[i]) <= kc.ABS_TOL_3D
            if r.surfs[i].n_cells < GLOBAL_3D_MIN_CELLS:
                continue
            err = kc.global_rel_err(r.ours[i], r.ref[i])
        else:
            err = max_rel_err(r.ours[i], r.ref[i])
        assert err <= bar, f"{case}, surface {i}: {err:.3e}"


@pytest.mark.parametrize("case", list(SPECTRA_CASES))
def test_each_surface_equals_its_single_run(runs, inputs, inputs_3d, case):
    r = runs(case)
    inp = inputs_3d if r.cfg.dimension == 3 else inputs
    for i, surf in enumerate(r.surfs):
        one = compute_spectra(surf, inp.species, inp.chosen, inp.grids,
                              r.df_data, r.cfg, "cpu", inp.laguerre)
        np.testing.assert_array_equal(r.ours[i], one, err_msg=str(i))


@pytest.mark.parametrize("surface_chunk", [None, 1, 2])
def test_surface_chunk_changes_no_bit(runs, inputs, surface_chunk):
    r = runs("df1-f32c")
    out = ens.compute_spectra_ensemble(
        r.surfs, inputs.species, inputs.chosen, inputs.grids, r.df_data,
        r.cfg, surface_chunk=surface_chunk, device="cpu")
    np.testing.assert_array_equal(out, r.ours)


def test_surface_chunk_must_be_positive(runs, inputs):
    r = runs("df1-f32c")
    with pytest.raises(ValueError, match="surface_chunk"):
        ens.compute_spectra_ensemble(
            r.surfs, inputs.species, inputs.chosen, inputs.grids, r.df_data,
            r.cfg, surface_chunk=0, device="cpu")


def test_cell_block_overrides_the_config(runs, inputs):
    """cell_block reaches the padding (and on a card the cell split): the
    ensemble with cell_block 64 is the single run at cell_block 64."""
    r = runs("df1-f32c")
    out = ens.compute_spectra_ensemble(
        r.surfs[:1], inputs.species, inputs.chosen, inputs.grids,
        r.df_data, r.cfg, cell_block=64, device="cpu")
    one = compute_spectra(r.surfs[0], inputs.species, inputs.chosen,
                          inputs.grids, r.df_data,
                          dataclasses.replace(r.cfg, cell_block=64), "cpu")
    np.testing.assert_array_equal(out[0], one)


def test_the_ensemble_never_groups_species(runs, inputs):
    """As the JAX ensemble builds its species arrays from chosen_idx
    directly: group_particles = 1 gives the ungrouped spectra, where the
    single run groups pi+, pi- and pi0 into one evaluation."""
    r = runs("df1-f32c")
    grouped = dataclasses.replace(r.cfg, group_particles=1)
    out = ens.compute_spectra_ensemble(
        r.surfs, inputs.species, inputs.chosen, inputs.grids, r.df_data,
        grouped, device="cpu")
    np.testing.assert_array_equal(out, r.ours)
    one = compute_spectra(r.surfs[1], inputs.species, inputs.chosen,
                          inputs.grids, r.df_data, grouped, "cpu")
    assert not np.array_equal(one, r.ours[1])


def test_3d_mode5_ensemble_gives_the_mode1_spectra(runs, inputs_3d):
    """3+1d df 4 on mode-5 surfaces (ROADMAP A7d: no longer rejected): the
    ensemble, like the JAX package's, computes no polarization and reads
    no vorticity, so the 3d-df4-f32 case's surfaces with the thermal
    vorticity drawn (make_surface draws it after every other field) give
    its mode-1 spectra bit for bit."""
    r = runs("3d-df4-f32")
    surfs = [make_surface(s.n_cells, seed=500 + i, dimension=3,
                          shear_scale=FEQMOD_SHEAR, bulk_scale=FEQMOD_BULK,
                          vorticity=True) for i, s in enumerate(r.surfs)]
    assert all(np.abs(s.wxy).max() > 0 for s in surfs)
    cfg = dataclasses.replace(r.cfg, mode=5)
    assert (cfg.dimension, cfg.df_mode, cfg.mode) == (3, 4, 5)
    out = ens.compute_spectra_ensemble(
        surfs, inputs_3d.species, inputs_3d.chosen, inputs_3d.grids,
        r.df_data, cfg, inputs_3d.laguerre, device="cpu")
    np.testing.assert_array_equal(out, r.ours)


def test_make_ensemble_draws_make_surface_by_seed():
    surfs = make_ensemble(3, 40, 7, shear_scale=0.03)
    for i, s in enumerate(surfs):
        ref = make_surface(40, seed=7 + i, shear_scale=0.03)
        for f in ("tau", "ux", "pixy", "bulkPi", "T"):
            np.testing.assert_array_equal(getattr(s, f), getattr(ref, f))


# ----------------------------------------------------------------------
# the host columns: fold gate, skipped count, 3+1d live cells
# ----------------------------------------------------------------------

# name -> (cfg fields, surface fields made nonzero, strict gate, folds?),
# the cases of tests/test_torch_physics.py::FOLD_CASES on prepare_cells'
# columns (pitn comes from the shear completion of un, pixn, piyn), and
# the strict gate of the feqmod kernel (tests/test_torch_feqmod.py)
HOST_FOLD_CASES = {
    "default": ({}, (), False, True),
    "eta_fold=0": ({"eta_fold": 0}, (), False, False),
    "un": ({}, ("un",), False, False),
    "dan": ({}, ("dan",), False, True),
    "dan+outflow": ({"outflow": 1}, ("dan",), False, False),
    "odd-shear": ({}, ("pixn", "piyn"), False, True),
    "odd-shear+regulate": ({"regulate_deltaf": 1}, ("piyn",), False, False),
    "dan+odd-shear": ({}, ("dan", "pixn"), False, False),
    "strict": ({}, (), True, True),
    "strict+dan": ({}, ("dan",), True, False),
    "strict+odd-shear": ({}, ("piyn",), True, False),
}


@pytest.mark.parametrize("case", list(HOST_FOLD_CASES))
def test_fold_gate_from_the_host_columns_decides_as_before(inputs, case):
    kw, odd, strict, folds = HOST_FOLD_CASES[case]
    cfg = port_config(jax_config(1, **kw))
    surf = make_surface(300, seed=11, shear_scale=0.03)
    rng = np.random.default_rng(5)
    for f in odd:
        setattr(surf, f, rng.uniform(-0.02, 0.02, surf.n_cells))
    cells = prepare_cells(surf, cfg, "cpu", block=BLOCK)
    device_read = dataclasses.replace(cells)      # no HostFacts
    assert cells.host is not None and device_read.host is None
    mx = [float(getattr(cells, f).abs().max())
          for f in ("un", "dan", "pitn", "pixn", "piyn", "Vn")]
    assert list(cells.host.odd_max) == mx
    grid = MomentumGridDevice.from_grids(inputs.grids, 2, "cpu")
    a_cells, a_grid, a = fold_eta_quadrature(cells, grid, cfg, strict)
    b_cells, b_grid, b = fold_eta_quadrature(device_read, grid, cfg, strict)
    assert a == b == folds
    torch.testing.assert_close(a_grid.eta, b_grid.eta, rtol=0, atol=0)
    torch.testing.assert_close(a_grid.eta_weight, b_grid.eta_weight,
                               rtol=0, atol=0)
    for f in dataclasses.fields(a_cells):
        torch.testing.assert_close(getattr(a_cells, f.name),
                                   getattr(b_cells, f.name), rtol=0, atol=0)


def test_skipped_count_is_counted_on_the_host(inputs):
    surf = make_surface(300, seed=12)
    surf.dat[::7] = -0.3          # u.dsigma <= 0: skipped
    cfg = port_config(jax_config(1))
    report = RunReport()
    cells, _, _ = engine_inputs(surf, inputs.species, inputs.chosen,
                                inputs.grids, cfg, "cpu", report)
    assert report.skipped_cells == surf.n_cells - int(cells.mask.sum())
    assert report.skipped_cells > 0


def test_3d_live_cells_from_the_host_columns(inputs_3d):
    surf = make_surface(300, seed=13, dimension=3)
    surf.dat[::5] = -0.3
    cfg = port_config(jax_config(1, dimension=3))
    cells, species, grid = engine_inputs(surf, inputs_3d.species,
                                         inputs_3d.chosen, inputs_3d.grids,
                                         cfg, "cpu")
    coeffs = {k: torch.zeros_like(cells.tau) for k in
              ("shear", "bulk0", "bulk1", "bulk2", "diff0", "diff1")}
    a = pack_inputs_comp_3d(cells, coeffs, species, grid, cfg)
    b = pack_inputs_comp_3d(dataclasses.replace(cells), coeffs, species,
                            grid, cfg)
    assert a.cell.shape[0] == len(cells.host.live) < surf.n_cells
    torch.testing.assert_close(a.cell, b.cell, rtol=0, atol=0)


# ----------------------------------------------------------------------
# the sampler
# ----------------------------------------------------------------------

SAMPLER_SIZES = (60, 97)


def _sampler_case(inputs, df_mode: int, **kw):
    jcfg = dataclasses.replace(jax_config(df_mode, **kw), operation=2,
                               fast=1, y_bins=20, pT_bins=30)
    surfs = [make_surface(n, seed=500 + i, shear_scale=0.03,
                          bulk_scale=0.01)
             for i, n in enumerate(SAMPLER_SIZES)]
    return jcfg, port_config(jcfg), surfs


def _densities(table):
    return [None if a is None else np.array(a) for a in
            (table.equilibrium_density, table.bulk_density,
             table.diff_density)]


def _single_histograms(inputs, surf, df_data, cfg, n_events, seed):
    table = dataclasses.replace(inputs.species)
    compute_particle_densities(table, df_data, inputs.laguerre,
                               surf.thermo_averages())
    binner = ChunkBinner(len(inputs.chosen), cfg)
    sample_particles(surf, table, inputs.chosen, df_data, cfg,
                     inputs.laguerre, n_events, "cpu", seed=seed,
                     chunk_consumer=binner)
    return binner.result(n_events)


@pytest.mark.parametrize("df_mode", [1, 4])
def test_histograms_equal_single_runs_with_surface_seed(inputs, df_mode):
    _, cfg, surfs = _sampler_case(inputs, df_mode)
    df_data, _ = inputs.df_data(df_mode, surfs[0].thermo_averages())
    before = _densities(inputs.species)
    hists, overflow = ens.sample_ensemble_histograms(
        surfs, inputs.species, inputs.chosen, df_data, cfg, inputs.laguerre,
        events_per_surface=20, capacity=1 << 16, seed=9, device="cpu")
    assert overflow.shape == (len(surfs),) and not overflow.any()
    for i, surf in enumerate(surfs):
        one = _single_histograms(inputs, surf, df_data, cfg, 20,
                                 surface_seed(9, i))
        for k, v in hists.items():
            np.testing.assert_array_equal(v[i], getattr(one, k), err_msg=k)
    assert hists["dN_dy"].sum() > 0
    # the caller's table keeps its densities (the JAX ensemble overwrites
    # them with the last surface's)
    for a, b in zip(before, _densities(inputs.species)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("surface_chunk", [1, 2])
def test_histograms_do_not_depend_on_surface_chunk(inputs, surface_chunk):
    _, cfg, surfs = _sampler_case(inputs, 1)
    df_data, _ = inputs.df_data(1)
    args = (surfs, inputs.species, inputs.chosen, df_data, cfg,
            inputs.laguerre)
    kw = dict(events_per_surface=10, capacity=1, seed=3, device="cpu")
    ref, _ = ens.sample_ensemble_histograms(*args, **kw)
    out, _ = ens.sample_ensemble_histograms(*args, surface_chunk=surface_chunk,
                                            **kw)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_surface_seed_is_keyed_by_seed_and_index():
    seeds = [surface_seed(5, i) for i in range(64)]
    assert len(set(seeds)) == 64
    assert all(0 <= s < 2**31 for s in seeds)
    assert seeds == [surface_seed(5, i) for i in range(64)]
    assert surface_seed(6, 0) != seeds[0]


def test_port_and_jax_ensemble_samplers_agree(inputs):
    """dN/dy per species and surface against the JAX
    sample_ensemble_histograms: a two-sample chi^2 at p > 1e-3 (the JAX
    streams are fold_in'd keys, the port's torch generators); the dict's
    keys and shapes are the JAX ones."""
    jcfg, cfg, surfs = _sampler_case(inputs, 1)
    df_data, j_df_data = inputs.df_data(1)
    n_events = 300
    ours, _ = ens.sample_ensemble_histograms(
        surfs, inputs.species, inputs.chosen, df_data, cfg, inputs.laguerre,
        n_events, capacity=1 << 18, seed=21, device="cpu")
    ref, overflow = j_ens.sample_ensemble_histograms(
        surfs, inputs.j_species, inputs.chosen, j_df_data, jcfg,
        inputs.j_laguerre, events_per_surface=n_events, capacity=1 << 18,
        seed=21)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == np.shape(ref[k]), k
    for i in range(len(surfs)):
        for s in range(len(CHOSEN)):
            a, b = ours["dN_dy"][i, s], np.asarray(ref["dN_dy"])[i, s]
            assert a.sum() > 50, (i, s)
            p, chi2, dof = chi2_p(a, b)
            assert p > 1e-3, (i, s, chi2, dof)


def _event_files(d: Path, prefix: str) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob(prefix + "*"))}


def test_particle_lists_equal_single_runs(inputs, tmp_path):
    _, cfg, surfs = _sampler_case(inputs, 1)
    df_data, _ = inputs.df_data(1)
    n_events = 6
    stats = ens.sample_ensemble_particle_lists(
        surfs, inputs.species, inputs.chosen, df_data, cfg, inputs.laguerre,
        n_events, capacity=1, results_root=tmp_path / "ens", seed=4,
        csv=True, device="cpu")
    assert len(stats) == len(surfs)
    for i, (surf, st) in enumerate(zip(surfs, stats)):
        d = tmp_path / "ens" / f"surface_{i}"
        assert st["dir"] == str(d)
        osc = _event_files(d, "particle_list_osc_")
        assert len(osc) == n_events == st["events_written"]
        rows = sum(b.partition(b"\n")[2].count(b"\n") for b in osc.values())
        assert rows == st["kept"] > 0
        assert st["rows_written"] == 2 * st["kept"]   # OSCAR and CSV
        # the single run with the surface's seed writes the same bytes
        table = dataclasses.replace(inputs.species)
        compute_particle_densities(table, df_data, inputs.laguerre,
                                   surf.thermo_averages())
        writer = StreamingEventWriter(tmp_path / f"one_{i}", csv=True)
        sample_particles(surf, table, inputs.chosen, df_data, cfg,
                         inputs.laguerre, n_events, "cpu",
                         seed=surface_seed(4, i), chunk_consumer=writer,
                         lean=True)
        writer.close()
        assert osc == _event_files(tmp_path / f"one_{i}",
                                   "particle_list_osc_")
        assert _event_files(d, "particle_list_") == _event_files(
            tmp_path / f"one_{i}", "particle_list_")


def test_particle_lists_without_oscar(inputs, tmp_path):
    _, cfg, surfs = _sampler_case(inputs, 1)
    df_data, _ = inputs.df_data(1)
    stats = ens.sample_ensemble_particle_lists(
        surfs[:1], inputs.species, inputs.chosen, df_data, cfg,
        inputs.laguerre, 3, capacity=1, results_root=tmp_path, oscar=False,
        csv=True, device="cpu")
    d = tmp_path / "surface_0"
    assert not list(d.glob("particle_list_osc_*"))
    assert len(list(d.glob("particle_list_*.dat"))) == 3
    assert stats[0]["rows_written"] == stats[0]["kept"] > 0


def test_prepare_sampler_ensemble_takes_each_surfaces_densities(inputs):
    _, cfg, surfs = _sampler_case(inputs, 1)
    df_data, _ = inputs.df_data(1)
    prepped = ens.prepare_sampler_ensemble(
        surfs, inputs.species, inputs.chosen, df_data, cfg, inputs.laguerre,
        device="cpu")
    assert len(prepped) == len(surfs)
    rates = [setup.rates for setup, _ in prepped]
    assert rates[0].shape[1] == len(CHOSEN)
    # fast df 1: 2 neq at each surface's own average temperature
    n0 = rates[0][rates[0][:, 0] > 0][0]
    n1 = rates[1][rates[1][:, 0] > 0][0]
    assert not torch.equal(n0, n1)


def test_device_none_raises_without_a_gpu(inputs, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, surfs = _sampler_case(inputs, 1)
    df_data, _ = inputs.df_data(1)
    args = (surfs, inputs.species, inputs.chosen)
    calls = [
        lambda: ens.compute_spectra_ensemble(*args, inputs.grids, df_data,
                                             cfg),
        lambda: ens.prepare_sampler_ensemble(*args, df_data, cfg,
                                             inputs.laguerre),
        lambda: ens.sample_ensemble_histograms(*args, df_data, cfg,
                                               inputs.laguerre, 1, 1),
        lambda: ens.sample_ensemble_particle_lists(
            *args, df_data, cfg, inputs.laguerre, 1, 1, tmp_path)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
