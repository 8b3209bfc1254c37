"""Surface mode 5 and the spin polarization: the port against the JAX
package on the CPU.

The JAX side runs in process (CPU backend, no Pallas: its polarization
routes are an f64 broadcast engine and an XLA f32 program).  Bars, as the
JAX package holds its own f32 route (tests/test_f32_paths.py:59-97): Snorm
relative on bins >= 1e-6 of its max, and P^mu = S^mu / Snorm absolute in
units of max |P| on bins whose Snorm is >= 1e-3 of its max
(kernel_check.polarization_errors).  The port's f64 engine meets the JAX
f64 engine to 1e-12 on both; kernel P1's plain version (f32, f32c) meets
the JAX f64 and f32 routes to 2e-5 (Snorm) and 1e-5 (P).  Result files
carry 9 significant digits: the f64 route's files are held to 1e-8 of
max |P| and its in-memory sums to 1e-12.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (BLOCK, CHOSEN, N_CELLS, build_workdir,  # noqa: E402
                          max_rel_err, numpy_fields,
                          polarization_file_errors, run_drivers, set_params)

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core.cells import prepare_cells as j_prepare_cells  # noqa: E402
from is3d2_tpu.core.polarization import (  # noqa: E402
    compute_polarization as j_compute_polarization)
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402
from is3d2_tpu.io import output as j_output  # noqa: E402
from is3d2_tpu.io import surface as j_surface  # noqa: E402
from is3d2_tpu.io.pdg import read_pdg as j_read_pdg  # noqa: E402
from is3d2_tpu.io.tables import MomentumGrids as JGrids  # noqa: E402

from is3d2_tpu_torch import cli, interop  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core.cells import prepare_cells  # noqa: E402
from is3d2_tpu_torch.core.polarization import (  # noqa: E402
    compute_polarization, delta_eta, fold_polarization_eta, polarization_f64,
    polarization_state)
from is3d2_tpu_torch.core.spectra import df12_state, spectra_df12  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import output, surface  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import MomentumGrids  # noqa: E402
from is3d2_tpu_torch.ops import polarization_f32 as pz  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import (  # noqa: E402
    compute_spectra_comp)
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
VORTICITY = ("wtx", "wty", "wtn", "wxy", "wxn", "wyn")
F64_TOL = 1e-12
FILE_TOL = 1e-8      # the f64 route's files: 9 significant digits


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("polzn"), surface_mode=5)


def _surface(n=N_CELLS, seed=3):
    return synthetic.make_surface(n, seed=seed, vorticity=True)


def _jax(workdir, surf, dtype, **kw):
    cfg = JConfig(operation=1, mode=5, df_mode=1, hrg_eos=3,
                  cell_block=BLOCK, compute_dtype=dtype, **kw)
    species = j_read_pdg(3, workdir / "PDG")
    chosen = species.chosen_indices(CHOSEN)
    grids = JGrids.from_dir(workdir / "tables")
    return np.stack(j_compute_polarization(surf, species, chosen, grids,
                                           surf.thermo_averages(), cfg))


def _port(workdir, surf, dtype):
    cfg = Config(operation=1, mode=5, df_mode=1, cell_block=BLOCK,
                 compute_dtype=dtype)
    species = read_pdg(3, workdir / "PDG")
    chosen = species.chosen_indices(CHOSEN)
    grids = MomentumGrids.from_dir(workdir / "tables")
    return np.stack(compute_polarization(surf, species, chosen, grids,
                                         surf.thermo_averages(), cfg, "cpu"))


# ----------------------------------------------------------------------
# reader and cells
# ----------------------------------------------------------------------

@pytest.mark.parametrize("include_baryon", [False, True])
def test_mode5_reader_matches_jax(tmp_path, include_baryon):
    """Mode 1 plus the six vorticity columns, with and without the baryon
    columns: every field equal to the JAX reader's, bit for bit."""
    path = tmp_path / "surface.dat"
    s = synthetic.make_surface(64, seed=5, include_baryon=include_baryon,
                               vorticity=True)
    synthetic.write_mode1(s, path, include_baryon=include_baryon,
                          vorticity=True)
    ours = surface.read_surface(path, 5, 2, include_baryon)
    ref = j_surface.read_surface(path, 5, 2, include_baryon)
    for f in surface._FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f),
                                      err_msg=f)
    for f in VORTICITY:
        np.testing.assert_array_equal(getattr(ours, f), getattr(s, f))
    assert vars(ours.thermo_averages()) == vars(ref.thermo_averages())


def test_cells_pad_mask_and_vorticity_match_jax():
    """pad_mask and the vorticity fields of prepare_cells equal the JAX
    package's; the surface holds real cells with u.dsigma <= 0, which
    pad_mask keeps and mask drops, and interop takes the JAX cells whole."""
    n = N_CELLS - 12      # so that the last block holds padding cells
    surf = _surface(n)
    cfg = JConfig(operation=1, mode=5, df_mode=1, hrg_eos=3,
                  cell_block=BLOCK)
    j_cells = j_prepare_cells(surf, cfg, block=BLOCK)
    cells = prepare_cells(surf, Config(mode=5, cell_block=BLOCK), "cpu")
    for f in ("mask", "pad_mask", *VORTICITY):
        np.testing.assert_array_equal(getattr(cells, f).numpy(),
                                      np.asarray(getattr(j_cells, f)),
                                      err_msg=f)
    real = np.arange(cells.n_padded) < n
    assert cells.n_padded == N_CELLS
    assert (cells.pad_mask.numpy() == real).all()
    assert ((cells.mask.numpy() == 0) & real).sum() > 0
    via = interop.cells_from_numpy(numpy_fields(j_cells))
    for f in ("mask", "pad_mask", *VORTICITY):
        torch.testing.assert_close(getattr(via, f), getattr(cells, f),
                                   rtol=0, atol=0)


def test_cells_with_u_dsigma_below_zero_count(workdir):
    """The u.dsigma <= 0 cells move the polarization: with ``mask`` in
    place of ``pad_mask`` Snorm changes."""
    cfg = Config(mode=5, cell_block=BLOCK)
    species = read_pdg(3, workdir / "PDG")
    grids = MomentumGrids.from_dir(workdir / "tables")
    surf = _surface(N_CELLS - 12)
    state = polarization_state(surf, species, species.chosen_indices(CHOSEN),
                               grids, cfg, "cpu")
    assert ((state[0].mask == 0) & (state[0].pad_mask == 1)).sum() > 0
    T = surf.thermo_averages().temperature
    full = polarization_f64(*state, T, delta_eta(grids)).numpy()
    cells = dataclasses.replace(state[0], pad_mask=state[0].mask)
    skipped = polarization_f64(cells, *state[1:], T, delta_eta(grids)).numpy()
    assert np.abs(full[4] - skipped[4]).max() > 1e-6 * np.abs(full[4]).max()


def test_spectra_do_not_read_pad_mask_or_vorticity(workdir):
    """The spectra (f64 engine and kernel B1's route) keep their bits when
    pad_mask and the vorticity are zeroed."""
    cfg = Config(df_mode=1, compute_dtype="f32c", cell_block=BLOCK)
    run = IS3D(workdir, cfg=cfg, device="cpu")
    run.surface = _surface()
    run._setup()
    state = df12_state(run.surface, run.species, run.chosen_idx, run.grids,
                       run.df_data, cfg, "cpu")
    zero = {f: torch.zeros_like(state[0].tau) for f in ("pad_mask",
                                                        *VORTICITY)}
    blank = (dataclasses.replace(state[0], **zero), *state[1:])
    for fn in (spectra_df12, compute_spectra_comp):
        assert torch.equal(fn(*state, cfg), fn(*blank, cfg))


# ----------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------

def test_f64_engine_matches_jax_f64(workdir):
    a = _port(workdir, _surface(), "f64")
    b = _jax(workdir, _surface(), "f64")
    norm, p = kc.polarization_errors(a, b)
    assert norm <= F64_TOL and p <= F64_TOL, (norm, p)


@pytest.mark.parametrize("dtype", ["f32c", "f32"])
@pytest.mark.parametrize("jax_dtype", ["f64", "f32"])
def test_p1_plain_matches_jax_routes(workdir, dtype, jax_dtype):
    """Kernel P1's plain version (the port's f32 and f32c route on the
    CPU) against the JAX package's f64 engine and its XLA f32 route."""
    a = _port(workdir, _surface(), dtype)
    b = _jax(workdir, _surface(), jax_dtype)
    norm, p = kc.polarization_errors(a, b)
    assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


def test_p1_plain_on_80_eta_nodes(tmp_path):
    """80 nodes, three chunks of at most 32: the plain version chunks as
    the kernel launches, and meets the JAX f64 engine at its bars."""
    wd = build_workdir(tmp_path / "wd", n_eta=80, surface_mode=5)
    a = _port(wd, _surface(), "f32c")
    b = _jax(wd, _surface(), "f64")
    norm, p = kc.polarization_errors(a, b)
    assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


# ----------------------------------------------------------------------
# kernel P1's eta fold and its operands
# ----------------------------------------------------------------------

def _state(workdir, surf, **cfg_fields):
    """(cfg, host grids, the polarization's engine state) of the f32c
    route on the CPU."""
    cfg = Config(mode=5, cell_block=BLOCK, compute_dtype="f32c",
                 **cfg_fields)
    species = read_pdg(3, workdir / "PDG")
    grids = MomentumGrids.from_dir(workdir / "tables")
    state = polarization_state(surf, species, species.chosen_indices(CHOSEN),
                               grids, cfg, "cpu")
    return cfg, grids, (*state, surf.thermo_averages().temperature,
                        delta_eta(grids))


def _bars(out, ref):
    norm, p = kc.polarization_errors(out, ref)
    assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


# name -> (odd sources of the surface, config fields, eta table, folds)
FOLD_GATE = {
    "boost-invariant": ({}, {}, None, True),
    "un": ({"un_scale": 0.05}, {}, None, False),
    "dsigma_eta": ({"dan_scale": 0.05}, {}, None, False),
    "asymmetric table": ({}, {}, "shifted", False),
    "eta_fold 0": ({}, {"eta_fold": 0}, None, False),
    "one node": ({}, {}, 1, False),
}


@pytest.mark.parametrize("case", list(FOLD_GATE))
def test_p1_fold_gate(workdir, tmp_path, case):
    """P1's fold gate folds a 2+1d surface with un = dsigma_eta = 0 on a
    symmetric table and refuses each odd source, an asymmetric table,
    eta_fold = 0 and one node; the instantiation it picks meets the f64
    engine (never folded) at the JAX bars."""
    odd, fields, table, folds = FOLD_GATE[case]
    wd = workdir
    if table is not None:
        wd = shutil.copytree(workdir, tmp_path / "wd")
        if table == 1:
            synthetic.write_quadrature_tables(wd, 16, 8, 1)
        else:
            path = wd / "tables/spacetime_rapidity/eta_table.dat"
            t = np.loadtxt(path)
            t[:, 0] += 0.01
            np.savetxt(path, t, fmt="%.16e")
    cfg, grids, state = _state(wd, kc.polarization_surface(N_CELLS, 3, **odd),
                               **fields)
    grid, folded = fold_polarization_eta(state[0], state[2], cfg)
    assert folded == folds
    if folds:
        assert grid.eta.shape[0] == len(grids.eta) // 2
        assert (grid.eta > 0).all()
        torch.testing.assert_close(grid.eta_weight.sum(),
                                   state[2].eta_weight.sum())
    else:
        assert grid is state[2]
    ops = kc.polarization_operands(state, cfg)
    assert ops.folded == folds
    assert ops.eta.shape[0] == grid.eta.shape[0]
    _bars(pz.polarization_f32(*ops.args()).numpy(),
          polarization_f64(*state).numpy())


def test_p1_fold_keeps_the_zero_node_of_an_odd_table(tmp_path):
    """25 nodes: the zero node pairs with itself and keeps its weight, the
    12 above it take their mirror's; the folded route meets the JAX f64
    engine and the unfolded one at the JAX bars."""
    wd = build_workdir(tmp_path / "wd", n_eta=25, surface_mode=5)
    surf = _surface()
    cfg, grids, state = _state(wd, surf)
    grid, folded = fold_polarization_eta(state[0], state[2], cfg)
    w = state[2].eta_weight
    assert folded and grid.eta.shape[0] == 13
    assert grid.eta[0] == 0.0 and (grid.eta[1:] > 0).all()
    assert grid.eta_weight[0] == w[12]
    torch.testing.assert_close(grid.eta_weight[1:], 2.0 * w[13:], rtol=1e-14,
                               atol=0.0)
    ref = _jax(wd, surf, "f64")
    _bars(_port(wd, surf, "f32c"), ref)
    ops = kc.polarization_operands(state, dataclasses.replace(cfg, eta_fold=0))
    assert not ops.folded and ops.eta.shape[0] == 25
    _bars(pz.polarization_f32_plain(*ops.args()).numpy(), ref.reshape(5, -1))


def test_p1_delta_eta_is_the_unfolded_tables(workdir):
    """The eta weights carry eta[1] - eta[0] of the table as read
    (Polarization.cpp:68), not of the folded half, whose first spacing
    differs: the folded route meets the f64 engine, which the folded
    spacing would miss by its ratio."""
    surf = _surface()
    cfg, grids, state = _state(workdir, surf)
    grid, folded = fold_polarization_eta(state[0], state[2], cfg)
    unfolded = float(grids.eta[1] - grids.eta[0])
    folded_spacing = float(grid.eta[1] - grid.eta[0])
    assert folded and state[4] == delta_eta(grids) == unfolded
    assert abs(folded_spacing / unfolded - 1.0) > 100 * kc.POLZN_TOL_NORM
    _bars(_port(workdir, surf, "f32c"), _port(workdir, surf, "f64"))


@pytest.mark.parametrize("jax_dtype", ["f64", "f32"])
def test_p1_folded_and_general_plain_agree_with_jax(workdir, jax_dtype):
    """Kernel P1's plain version in both instantiations (the default fold,
    eta_fold = 0) against each other and against the JAX package's f64
    engine and its XLA f32 route (which never folds)."""
    surf = _surface()
    out = {}
    for eta_fold in (-1, 0):
        cfg, _, state = _state(workdir, surf, eta_fold=eta_fold)
        ops = kc.polarization_operands(state, cfg)
        out[ops.folded] = pz.polarization_f32_plain(*ops.args()).numpy()
    assert set(out) == {True, False}
    ref = _jax(workdir, surf, jax_dtype).reshape(5, -1)
    for sums in out.values():
        _bars(sums, ref)
    _bars(out[True], out[False])


def test_p1_pack_takes_the_real_cells_only(workdir):
    """pack_inputs hands P1 the pad_mask > 0 rows: no padding, every
    u.dsigma <= 0 cell kept (no mask column); the sums meet the f64
    engine on the padded cells."""
    n = N_CELLS - 12
    cfg, _, state = _state(workdir, _surface(n))
    cells = state[0]
    assert cells.n_padded == N_CELLS
    assert ((cells.mask == 0) & (cells.pad_mask == 1)).sum() > 0
    ops = kc.polarization_operands(state, cfg)
    assert ops.cell.shape == (n, len(pz.CELL_COLS))
    assert "mask" not in pz.CELL_COLS
    np.testing.assert_array_equal(
        ops.cell[:, pz.CELL_COLS.index("qd0")].numpy(),
        cells.dat[:n].to(torch.float32).numpy())
    _bars(pz.polarization_f32(*ops.args()).numpy(),
          polarization_f64(*state).numpy())


# The re-anchor's mode-5 probes (ROADMAP C8): the port's driver against
# the JAX driver's f64 route in memory.  name -> (workdir parameters,
# build_workdir options, bar on the spectra (op 0: the normalized dN/dX),
# bar on the polarization's Snorm and P).  The f32 routes are held to
# their kernels' bars against f64, the f64 route to 1e-12.
MODE5_PROBES = {
    "df3-f32-shear0.2": ({"df_mode": 3, "compute_dtype": "f32"},
                         {"shear_scale": 0.2}, kc.FEQMOD_TOL_F64, None),
    "df2-f32c-baryons-diffusion": (
        {"df_mode": 2, "compute_dtype": "f32c", "include_baryon": 1,
         "include_baryondiff_deltaf": 1}, {"include_baryon": True}, kc.TOL,
        None),
    "one-eta-f64": ({"compute_dtype": "f64"}, {"n_eta": 1}, F64_TOL,
                    F64_TOL),
    "one-eta-f32c": ({"compute_dtype": "f32c"}, {"n_eta": 1}, kc.TOL, None),
    "op0-df4-f32": ({"operation": 0, "df_mode": 4, "compute_dtype": "f32"},
                    {}, kc.FEQMOD_TOL_F64, None),
}


@pytest.mark.parametrize("case", list(MODE5_PROBES))
def test_mode5_probes_match_jax_f64(tmp_path, case):
    params, kw, bar, polzn_bar = MODE5_PROBES[case]
    wd = build_workdir(tmp_path / "wd", params={"cell_block": BLOCK,
                                                **params},
                       surface_mode=5, **kw)
    ref, ours = run_drivers(wd)
    if params.get("operation") == 0:
        pairs = zip(ours.dN_dX.normalized(ours.cfg),
                    ref.dN_dX.normalized(ref.cfg))
        err = max(max_rel_err(a, b) for a, b in pairs)
    else:
        err = max_rel_err(np.asarray(ours.spectra), np.asarray(ref.spectra))
    assert err <= bar, err
    norm, p = kc.polarization_errors(np.stack(ours.polarization),
                                     np.stack(ref.polarization))
    if polzn_bar is None:
        assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)
    else:
        assert norm <= polzn_bar and p <= polzn_bar, (norm, p)


# ----------------------------------------------------------------------
# the writer and the driver
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dimension", [2, 3])
def test_write_polarization_gives_the_jax_bytes(workdir, tmp_path,
                                                dimension):
    grids = MomentumGrids.from_dir(workdir / "tables")
    j_grids = JGrids.from_dir(workdir / "tables")
    Ny = 1 if dimension == 2 else len(grids.y)
    rng = np.random.default_rng(11)
    shape = (3, len(grids.pT), len(grids.phi), Ny)
    arrays = [rng.normal(size=shape) for _ in range(4)]
    arrays.append(rng.uniform(0.5, 2.0, size=shape))   # Snorm > 0
    output.write_polarization(tmp_path / "ours", *arrays, grids, dimension)
    j_output.write_polarization(tmp_path / "ref", *arrays, j_grids,
                                dimension)
    for name in output.POLARIZATION_FILES:
        assert (tmp_path / "ours" / f"{name}.dat").read_bytes() == \
            (tmp_path / "ref" / f"{name}.dat").read_bytes(), name
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == \
        sorted(f"{n}.dat" for n in output.POLARIZATION_FILES)


# (workdir parameters, bar on the files' P): op 1 df 1 in f32c (P1's plain
# version) and in f64, op 0, op 2 into the test histograms, group_particles
# (the polarization stays ungrouped)
DRIVER_CASES = {
    "op1-df1-f32c": ({"compute_dtype": "f32c"}, kc.POLZN_TOL_P),
    "op1-df1-f64": ({"compute_dtype": "f64"}, FILE_TOL),
    "op0-df1-f32c": ({"operation": 0, "compute_dtype": "f32c"},
                     kc.POLZN_TOL_P),
    "op2-df1-hist": ({"operation": 2, "test_sampler": 1,
                      "min_num_hadrons": 2.0e4}, kc.POLZN_TOL_P),
    "op1-grouped-f32c": ({"compute_dtype": "f32c", "group_particles": 1},
                         kc.POLZN_TOL_P),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_port_cli_matches_jax_driver_mode5(tmp_path, case):
    params, tol = DRIVER_CASES[case]
    wd = build_workdir(tmp_path / "jax", surface_mode=5)
    set_params(wd, params)
    shutil.copytree(wd, tmp_path / "port")
    ref = JIS3D(wd)
    ref.run_particlization()
    assert cli.main([str(tmp_path / "port"), "--device", "cpu"]) == 0
    St, Sx, Sy, Sn, Snorm = ref.polarization
    assert St.shape[0] == len(CHOSEN)      # every species, never grouped
    assert polarization_file_errors(wd, tmp_path / "port", Snorm) <= tol


def test_df5_on_a_mode5_surface(tmp_path):
    """df 5 with mode 5 does what the JAX driver does: the famod spectra of
    the surface read as mode 1 (the Newton reconstructs; the vorticity
    columns change no byte of them), then the polarization, which no df
    mode enters: its files meet the JAX package's f32 route on the same
    surface at the bars.  (The JAX driver's df-5 run itself takes minutes
    on the CPU, so the JAX side is its polarization on its own reader's
    surface.)"""
    wd5 = build_workdir(tmp_path / "m5", params={
        "df_mode": 5, "compute_dtype": "f32", "cell_block": BLOCK},
        eos_consistent=True, surface_mode=5, shear_scale=0.05,
        bulk_scale=0.02)
    wd1 = shutil.copytree(wd5, tmp_path / "m1")
    set_params(wd1, {"mode": 1})
    for wd in (wd5, wd1):
        assert cli.main([str(wd), "--device", "cpu"]) == 0
    for f in sorted((wd1 / "results/continuous").iterdir()):
        assert f.read_bytes() == (wd5 / "results/continuous" /
                                  f.name).read_bytes(), f.name
    assert not (wd1 / "results/St.dat").exists()
    jcfg = JConfig.from_file(wd5 / "iS3D_parameters.dat")
    surf = j_surface.read_surface(wd5 / "input/surface.dat", 5, 2, False)
    species = j_read_pdg(3, wd5 / "PDG")
    ref = j_compute_polarization(surf, species, species.chosen_indices(
        CHOSEN), JGrids.from_dir(wd5 / "tables"), surf.thermo_averages(),
        jcfg)
    j_output.write_polarization(tmp_path / "jax" / "results", *ref,
                                JGrids.from_dir(wd5 / "tables"), 2)
    assert polarization_file_errors(tmp_path / "jax", wd5,
                                    ref[4]) <= kc.POLZN_TOL_P


def test_port_driver_f64_polarization_in_memory(workdir):
    """The driver's in-memory sums on the f64 route: 1e-12 of the JAX
    driver's on both metrics, with the polarization in stage_seconds."""
    ref = JIS3D(workdir, cfg=dataclasses.replace(
        JConfig.from_file(workdir / "iS3D_parameters.dat"),
        compute_dtype="f64"))
    ref.run_particlization(write=False)
    ours = IS3D(workdir, cfg=dataclasses.replace(
        Config.from_file(workdir / "iS3D_parameters.dat"),
        compute_dtype="f64"), device="cpu")
    ours.run_particlization(write=False)
    norm, p = kc.polarization_errors(np.stack(ours.polarization),
                                     np.stack(ref.polarization))
    assert norm <= F64_TOL and p <= F64_TOL, (norm, p)
    assert ours.stage_seconds["polarization"] > 0


def test_port_runs_mode5_without_jax(tmp_path):
    """Mode 5 in a fresh process, f32c (kernel P1's plain version, called
    once) and f64 (the f64 engine, no call of it): never imports jax or
    the JAX package; four finite files each."""
    wds = {"f32c": synthetic.write_workdir(
        tmp_path / "f32c", n_cells=BLOCK, chosen_mcids=CHOSEN, n_pT=8,
        n_phi=8, n_eta=8, n_T=21, surface_mode=5,
        params={"cell_block": BLOCK})}
    wds["f64"] = shutil.copytree(wds["f32c"], tmp_path / "f64")
    set_params(wds["f64"], {"compute_dtype": "f64"})
    code = (
        "import sys\n"
        "from is3d2_tpu_torch import cli\n"
        "from is3d2_tpu_torch.ops import polarization_f32 as pz\n"
        "calls = []\n"
        "plain = pz.polarization_f32_plain\n"
        "pz.polarization_f32_plain = lambda *a: calls.append(1) or plain(*a)\n"
        f"cli.main([{str(wds['f32c'])!r}, '--device', 'cpu'])\n"
        "assert calls == [1], calls\n"
        f"cli.main([{str(wds['f64'])!r}, '--device', 'cpu'])\n"
        "assert calls == [1], calls\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'is3d2_tpu' or m.startswith('is3d2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert proc.stdout.count("computing spin polarization") == 2
    for wd in wds.values():
        for name in output.POLARIZATION_FILES:
            v = np.loadtxt(wd / "results" / f"{name}.dat")
            assert v.shape == (len(CHOSEN) * 8 * 8, 4)
            assert np.isfinite(v).all()
