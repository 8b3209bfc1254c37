"""The port's multi-device path (is3d2_tpu_torch/parallel/sharding.py) on
CPU meshes.

The port's meshes here are lists of the one CPU device, [cpu] * 4 as
(4, 1) and (2, 2) (and [cpu] * 8 against the JAX package's 8 virtual
devices of tests/conftest.py, as (8, 1) and (4, 2)); on the CPU every
kernel runs its plain version.  Inputs are torch_parity's 512-cell
surfaces (8 species, 16 pT x 8 phi, 24 eta nodes or the 3+1d y table)
in cell blocks of 128, so a 4-shard cut gives each shard one block and
an 8-shard cut leaves four shards empty.

Bars:
  * each sharded function against the port's single-device route:
    <= 1e-12 relative (bins >= 1e-4 of each species' peak; the
    polarization's sums on bins >= 1e-12 of their max), since every
    plain version and f64 engine sums its cells in f64 and a whole-block
    cut moves only the order of those additions;
  * the f64 routes against the JAX package's sharded functions:
    <= 1e-12;
  * the kernel routes against the JAX package's sharded f64 route, at
    ROADMAP C7's bars: B1 1e-6, B3 and its famod mode 1e-5, P1 the
    polarization bars of tools/kernel_check.py (2e-5 on Snorm, 1e-5 on
    P).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

import torch_parity as tp  # noqa: E402

import jax  # noqa: E402

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core.cells import prepare_cells as j_prepare_cells  # noqa: E402
from is3d2_tpu.core.spectra import MomentumGridDevice as JGrid  # noqa: E402
from is3d2_tpu.core.spectra import SpeciesArrays as JSpecies  # noqa: E402
from is3d2_tpu.io.pdg import read_pdg as j_read_pdg  # noqa: E402
from is3d2_tpu.io.tables import MomentumGrids as JGrids  # noqa: E402
from is3d2_tpu.parallel import sharding as jsh  # noqa: E402

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import polarization as pol  # noqa: E402
from is3d2_tpu_torch.core import spacetime  # noqa: E402
from is3d2_tpu_torch.core.cells import prepare_cells  # noqa: E402
from is3d2_tpu_torch.core.spectra import (  # noqa: E402
    MomentumGridDevice, SpeciesArrays, spectra_df12)
from is3d2_tpu_torch.core.spectra_famod import spectra_famod  # noqa: E402
from is3d2_tpu_torch.core.spectra_feqmod import spectra_feqmod  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import MomentumGrids  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.ops import polarization_f32 as p1  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import (  # noqa: E402
    compute_spectra_comp)
from is3d2_tpu_torch.parallel import make_mesh, sharded_spectra  # noqa: E402
from is3d2_tpu_torch.parallel import sharding as sh  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
JAX_MESHES = {"8x1": (8, 1), "4x2": (4, 2)}
# the functions that cut the cells over the whole mesh see 8 shards in
# either shape: one JAX shape suffices there
JAX_WHOLE = {"8x1": (8, 1)}
TOL = 1e-12


def _mesh(shape, n=4):
    return make_mesh(*shape, [CPU] * n)


def _rel(out, ref, floor=1e-4):
    return tp.max_rel_err(np.asarray(out), np.asarray(ref), floor)


def _sums_err(out, ref):
    """max relative error of raw sums over the bins >= 1e-12 of the max."""
    out, ref = np.asarray(out), np.asarray(ref)
    sig = np.abs(ref) >= 1e-12 * np.abs(ref).max()
    return float((np.abs(out - ref)[sig] / np.abs(ref)[sig]).max())


def _polzn_err(out, ref):
    """The polarization's five sums (S_t, S_x, S_y, S_n, Snorm), each in
    units of its own max |.|: the spin sums cancel between cells, so a
    bin's own relative error says nothing of the order of additions."""
    return max(tp.scale_err(np.asarray(o), np.asarray(r))
               for o, r in zip(out, ref))


@pytest.fixture(scope="module")
def wd(tmp_path_factory):
    # 8 eta nodes (4 after the fold): the f64 feqmod engines dominate
    return tp.build_workdir(tmp_path_factory.mktemp("parallel"), n_eta=8)


@pytest.fixture(scope="module")
def memo():
    """Results computed once for every test of the module that needs
    them (the single-device references, the JAX sharded runs)."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]
    return get


@pytest.fixture(scope="module")
def states(wd):
    """The JAX states (f64 prep) and their port copies, built once."""
    return {"df1": tp.case_state(wd, 1),
            "df1-3d": tp.case_state(wd, 1, dimension=3),
            "df4": tp.feqmod_state(wd, 4),
            "df5": tp.famod_state(wd)}


def _cfg(state, **kw):
    return dataclasses.replace(tp.port_config(state.cfg), **kw)


# ----------------------------------------------------------------------
# the helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n, block, shards", [
    (512, 128, 4), (512, 128, 3), (512, 128, 8), (4096, 512, 4),
    (384, 128, 2), (128, 128, 4)])
def test_cell_shards_cover_every_cell_once_on_whole_blocks(n, block, shards):
    ranges = sh.cell_ranges(n, block, shards)
    assert len(ranges) == shards
    covered = np.concatenate([np.arange(b, e) for b, e in ranges])
    np.testing.assert_array_equal(covered, np.arange(n))
    for b, e in ranges:
        assert b % block == 0 and (e % block == 0 or e == n)
    # the JAX pad_cells_for_mesh unit: ceil(blocks / shards) blocks a shard
    per = -(-(-(-n // block)) // shards) * block
    assert ranges[0][1] - ranges[0][0] == min(per, n)


def test_live_cells_of_the_shards_cover_the_live_cells_once(wd):
    surf = synthetic.make_surface(500, seed=4)
    # every 7th cell with u.dsigma < 0: masked, as the reference skips it
    surf.dat[::7], surf.dax[::7], surf.day[::7] = -1.0, 0.0, 0.0
    cells = prepare_cells(surf, Config(cell_block=128), "cpu")
    live = cells.host.live
    assert len(live) < 500
    cut = [sh.cut_cells(cells, b, e, CPU)
           for b, e in sh.cell_ranges(cells.n_padded, 128, 3)]
    got = np.concatenate([c.host.live + b for c, (b, _) in zip(
        cut, sh.cell_ranges(cells.n_padded, 128, 3))])
    np.testing.assert_array_equal(got, live)
    assert sum(c.host.real for c in cut) == 500
    for c in cut:
        assert c.host.odd_max == cells.host.odd_max
        np.testing.assert_array_equal(
            sh.live_rows(c), np.flatnonzero(c.mask.numpy() > 0))


@pytest.mark.parametrize("S, shards", [(8, 2), (8, 3), (371, 4), (3, 4)])
def test_species_shards_concatenate_to_the_whole_list(S, shards):
    ranges = sh.species_ranges(S, shards)
    got = np.concatenate([np.arange(b, e) for b, e in ranges])
    np.testing.assert_array_equal(got, np.arange(S))


def test_an_empty_shard_gives_zeros_and_runs_nothing(states):
    """512 cells in one block of 512 over 8 shards: seven shards hold no
    cell, run nothing, and the sum is the single-device one; all shards
    empty gives the zeros."""
    st = states["df1"]
    cfg = _cfg(st, compute_dtype="f32c", cell_block=512)
    mesh = _mesh((8, 1), 8)
    ref = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid, cfg)
    out = sh.sharded_spectra_fast(st.cells, st.coeffs, st.species, st.grid,
                                  cfg, mesh)
    assert [s["cells"] for s in sh.last_shards] == [[0, 512]]
    assert _rel(out, ref) <= TOL
    z = sh.sum_in_order([None, None], CPU, lambda: torch.zeros(3))
    assert torch.equal(z, torch.zeros(3))


def _jax_auto_mesh(monkeypatch, use_mesh, n, platform, n_sp):
    """The JAX package's auto_mesh on ``n`` fake devices of ``platform``:
    the (cells, species) shape it picks, or None."""
    class Dev:
        pass
    devs = []
    for _ in range(n):
        d = Dev()
        d.platform = platform
        devs.append(d)
    monkeypatch.setattr(jsh.jax, "devices", lambda: devs)
    monkeypatch.setattr(jsh, "make_mesh", lambda a, b, d: (a, b))
    cfg = JConfig(use_mesh=use_mesh, mesh_species_shards=n_sp)
    return jsh.auto_mesh(cfg)


@pytest.mark.parametrize("use_mesh", [-1, 0, 1])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("kind", ["cpu", "cuda"])
@pytest.mark.parametrize("n_sp", [1, 2, 3])
def test_auto_mesh_follows_the_jax_rules(monkeypatch, use_mesh, n, kind,
                                         n_sp):
    want = _jax_auto_mesh(monkeypatch, use_mesh, n,
                          "cpu" if kind == "cpu" else "gpu", n_sp)
    devices = [torch.device(kind, 0) if kind == "cuda" else CPU] * n
    monkeypatch.setattr(sh, "local_devices", lambda device=None: devices)
    mesh = sh.auto_mesh(Config(use_mesh=use_mesh, mesh_species_shards=n_sp),
                        kind)
    got = None if mesh is None else (mesh.shape["cells"],
                                     mesh.shape["species"])
    assert got == want
    if mesh is not None:
        assert mesh.flat() == devices


def test_local_devices_of_a_cpu_run_is_the_cpu():
    assert sh.local_devices("cpu") == [CPU]
    assert sh.auto_mesh(Config(use_mesh=1), "cpu") is None


@pytest.mark.parametrize("use_mesh", [-1, 0, 1])
def test_validate_slice_accepts_every_use_mesh(use_mesh):
    Config(use_mesh=use_mesh).validate_slice()


def test_make_mesh_rejects_a_shape_that_does_not_fit():
    with pytest.raises(ValueError):
        make_mesh(3, 2, [CPU] * 4)
    assert make_mesh(None, 2, [CPU] * 4).shape == {"cells": 2,
                                                   "species": 2}


def test_move_keeps_the_host_facts(wd):
    surf = synthetic.make_surface(200, seed=4)
    cells = prepare_cells(surf, Config(cell_block=128), "cpu")
    moved = sh.move(cells, CPU)
    assert moved.host is cells.host
    grids = MomentumGrids.from_dir(wd / "tables")
    grid = MomentumGridDevice.from_grids(grids, 2, "cpu")
    assert sh.move(grid, CPU).host_eta is grid.host_eta


# ----------------------------------------------------------------------
# each sharded function against the port's single-device route
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dtype", ["f32c", "f32"])
def test_sharded_spectra_fast_matches_b1(states, mesh, dtype):
    st = states["df1"]
    cfg = _cfg(st, compute_dtype=dtype)
    ref = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid, cfg)
    out = sh.sharded_spectra_fast(st.cells, st.coeffs, st.species, st.grid,
                                  cfg, _mesh(MESHES[mesh]))
    assert out.shape == ref.shape
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_spectra_fast_3d_matches_b1_3d(states, mesh):
    st = states["df1-3d"]
    cfg = _cfg(st, compute_dtype="f32c")
    ref = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid, cfg)
    out = sh.sharded_spectra_fast_3d(st.cells, st.coeffs, st.species,
                                     st.grid, cfg, _mesh(MESHES[mesh]))
    assert out.shape == ref.shape
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["df1", "df1-3d"])
def test_sharded_spectra_matches_the_f64_engine(states, mesh, case):
    st = states[case]
    cfg = _cfg(st)
    ref = spectra_df12(st.cells, st.coeffs, st.species, st.grid, cfg)
    out = sharded_spectra(st.cells, st.coeffs, st.species, st.grid, cfg,
                          _mesh(MESHES[mesh]))
    assert out.shape == ref.shape
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["df4", "df5"])
def test_sharded_spectra_feqmod_fast_matches_b3(states, mesh, case):
    st = states[case]
    cfg = _cfg(st, compute_dtype="f32")
    aux = st.fq if case == "df4" else st.fm
    kernel = (fk.compute_spectra_feqmod_kernel if case == "df4"
              else fk.compute_spectra_famod_kernel)
    ref = kernel(st.cells, aux, st.species, st.grid, cfg)
    out = sh.sharded_spectra_feqmod_fast(st.cells, aux, st.species, st.grid,
                                         cfg, _mesh(MESHES[mesh]))
    assert out.shape == ref.shape
    assert _rel(out, ref) <= TOL
    if MESHES[mesh][1] == 2:   # the renorm columns follow the species cut
        assert sorted({tuple(s["species"]) for s in sh.last_shards}) == [
            (0, 4), (4, 8)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["df4", "df5"])
def test_sharded_spectra_mod_f64_matches_the_f64_engines(states, memo, mesh,
                                                         case):
    st = states[case]
    cfg = _cfg(st)
    aux = st.fq if case == "df4" else st.fm
    engine = spectra_feqmod if case == "df4" else spectra_famod
    ref = memo(("mod_f64", case), lambda: engine(
        st.cells, aux, st.species, st.grid, cfg))
    out = sh.sharded_spectra_mod_f64(st.cells, aux, st.species, st.grid, cfg,
                                     _mesh(MESHES[mesh]))
    assert _rel(out, ref) <= TOL
    # cut over the whole mesh: four shards of one block each
    assert [s["cells"] for s in sh.last_shards] == [
        [0, 128], [128, 256], [256, 384], [384, 512]]


def _dX_state(states, case):
    st = states[case]
    return st, (st.coeffs if case == "df1" else st.fq)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["df1", "df4"])
def test_sharded_dN_dX_matches_the_f64_bins(states, memo, mesh, case):
    st, aux = _dX_state(states, case)
    cfg = _cfg(st, operation=0)
    ref = memo(("f64_bins", case), lambda: spacetime.f64_bins(
        st.cells, aux, st.species, st.grid, cfg))
    out = sh.sharded_dN_dX(st.cells, aux, st.species, st.grid, cfg,
                           _mesh(MESHES[mesh]))
    for a, b in zip(out, ref):
        assert _sums_err(a, b) <= TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["df1", "df4"])
def test_sharded_dN_dX_fast_matches_the_kernel_bins(states, memo, mesh,
                                                    case):
    st, aux = _dX_state(states, case)
    cfg = _cfg(st, operation=0, compute_dtype="f32c")
    ref = memo(("kernel_bins", case), lambda: spacetime.kernel_bins(
        st.cells, spacetime.kernel_operands(st.cells, aux, st.species,
                                            st.grid, cfg),
        st.species, st.grid, cfg))
    out = sh.sharded_dN_dX_fast(st.cells, aux, st.species, st.grid, cfg,
                                _mesh(MESHES[mesh]))
    for a, b in zip(out, ref):
        assert _sums_err(a, b) <= TOL


def _polzn_state(tmp_path_factory, dimension):
    wd = tp.build_workdir(tmp_path_factory.mktemp(f"polzn{dimension}"),
                          surface_mode=5, dimension=dimension, n_eta=8)
    surf = synthetic.make_surface(tp.N_CELLS, seed=3, dimension=dimension,
                                  vorticity=True)
    species = read_pdg(3, wd / "PDG")
    chosen = species.chosen_indices(tp.CHOSEN)
    grids = MomentumGrids.from_dir(wd / "tables")
    cfg = Config(mode=5, dimension=dimension, cell_block=tp.BLOCK)
    cells, sp, grid = pol.polarization_state(surf, species, chosen, grids,
                                             cfg, "cpu")
    return {"wd": wd, "surf": surf, "cfg": cfg, "cells": cells,
            "species": sp, "grid": grid, "grids": grids, "chosen": chosen,
            "T": surf.thermo_averages().temperature,
            "d_eta": pol.delta_eta(grids)}


@pytest.fixture(scope="module")
def polzn(tmp_path_factory):
    return {d: _polzn_state(tmp_path_factory, d) for d in (2, 3)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dimension, block", [(2, 128), (3, 256), (3, 128)])
def test_sharded_polarization_fast_matches_p1(polzn, memo, mesh, dimension,
                                              block):
    """P1 sums a cell's eta terms in f32 and its cells in f64: 1e-12 on
    any whole-block cut.  P1's 3+1d mode sums runs of 256 real cells in
    f32 (ops/polarization_f32.py::RUN_CELLS_3D): 1e-12 on cuts of whole
    256-cell blocks, P1's own bar (POLZN_TOL_PLAIN) on 128-cell ones,
    which split those runs."""
    p = polzn[dimension]
    cfg = dataclasses.replace(p["cfg"], compute_dtype="f32c",
                              cell_block=block)
    cells, species, grid, T = p["cells"], p["species"], p["grid"], p["T"]
    if dimension == 3:
        ref = memo(("p1", 3), lambda: p1.compute_polarization_kernel_3d(
            cells, species, grid, T))
    else:
        g, folded = pol.fold_polarization_eta(cells, grid, cfg)
        assert folded
        ref = memo(("p1", 2), lambda: p1.compute_polarization_kernel(
            cells, species, g, T, p["d_eta"], folded))
    out = sh.sharded_polarization_fast(cells, species, grid, T, cfg,
                                       _mesh(MESHES[mesh]),
                                       delta_eta=p["d_eta"])
    assert out.shape == ref.shape
    if dimension == 3 and block % p1.RUN_CELLS_3D:
        assert max(kc.polarization_errors(out.numpy(), ref.numpy())) <= \
            kc.POLZN_TOL_PLAIN
    else:
        assert _polzn_err(out, ref) <= TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dimension", [2, 3])
def test_sharded_polarization_matches_the_f64_engine(polzn, memo, mesh,
                                                     dimension):
    p = polzn[dimension]
    cells, species, grid, T = p["cells"], p["species"], p["grid"], p["T"]
    ref = memo(("polzn_f64", dimension), lambda: pol.polarization_f64(
        cells, species, grid, T, p["d_eta"], dimension))
    out = sh.sharded_polarization(cells, species, grid, T, p["cfg"],
                                  _mesh(MESHES[mesh]), delta_eta=p["d_eta"])
    assert out.shape == ref.shape
    assert _polzn_err(out, ref) <= TOL


# ----------------------------------------------------------------------
# against the JAX package's sharded functions (8 virtual devices)
# ----------------------------------------------------------------------

def _jax_mesh(shape):
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return jsh.make_mesh(*shape)


@pytest.fixture(scope="module")
def jax_df12(states):
    """The JAX sharded f64 df-1/2 spectra on both JAX meshes."""
    out = {}
    for case in ("df1", "df1-3d"):
        st = states[case]
        for name, shape in JAX_MESHES.items():
            out[case, name] = np.asarray(jsh.sharded_spectra(
                st.j_cells, st.j_coeffs, st.j_species, st.j_grid, st.cfg,
                _jax_mesh(shape), block=tp.BLOCK))
    return out


@pytest.mark.parametrize("mesh", JAX_MESHES)
@pytest.mark.parametrize("case", ["df1", "df1-3d"])
def test_sharded_spectra_matches_jax(states, jax_df12, mesh, case):
    st = states[case]
    out = sharded_spectra(st.cells, st.coeffs, st.species, st.grid, _cfg(st),
                          _mesh(JAX_MESHES[mesh], 8))
    assert _rel(out, jax_df12[case, mesh]) <= TOL


@pytest.mark.parametrize("mesh", JAX_MESHES)
@pytest.mark.parametrize("case", ["df1", "df1-3d"])
def test_sharded_b1_routes_meet_the_jax_f64_route(states, jax_df12, mesh,
                                                  case):
    """ROADMAP C7: the port's B1 routes against the JAX sharded f64 route
    at B1's bar."""
    st = states[case]
    cfg = _cfg(st, compute_dtype="f32c")
    fn = sh.sharded_spectra_fast_3d if case == "df1-3d" \
        else sh.sharded_spectra_fast
    out = fn(st.cells, st.coeffs, st.species, st.grid, cfg,
             _mesh(JAX_MESHES[mesh], 8))
    assert _rel(out, jax_df12[case, mesh]) <= 1e-6


@pytest.mark.parametrize("mesh", JAX_WHOLE)
@pytest.mark.parametrize("case", ["df4", "df5"])
def test_sharded_mod_routes_match_jax(states, mesh, case):
    """The f64 engines to 1e-12, B3 (and its famod mode) at 1e-5, both
    against jsh.sharded_spectra_mod_f64 on the same prep."""
    st = states[case]
    j_aux, aux = (st.j_fq, st.fq) if case == "df4" else (st.j_fm, st.fm)
    ref = np.asarray(jsh.sharded_spectra_mod_f64(
        st.j_cells, j_aux, st.j_species, st.j_grid, st.cfg,
        _jax_mesh(JAX_MESHES[mesh]), block=tp.BLOCK))
    m = _mesh(JAX_MESHES[mesh], 8)
    out = sh.sharded_spectra_mod_f64(st.cells, aux, st.species, st.grid,
                                     _cfg(st), m)
    assert _rel(out, ref) <= TOL
    fast = sh.sharded_spectra_feqmod_fast(st.cells, aux, st.species, st.grid,
                                          _cfg(st, compute_dtype="f32"), m)
    assert _rel(fast, ref) <= 1e-5


@pytest.mark.parametrize("mesh", JAX_WHOLE)
@pytest.mark.parametrize("case", ["df1", "df4"])
def test_sharded_dN_dX_matches_jax(states, mesh, case):
    """The f64 bins to 1e-12, the kernel route at its bar (B1 1e-6, B3
    1e-5), against jsh.sharded_dN_dX."""
    st, aux = _dX_state(states, case)
    j_aux = st.j_coeffs if case == "df1" else st.j_fq
    jcfg = dataclasses.replace(st.cfg, operation=0)
    ref = [np.asarray(a) for a in jsh.sharded_dN_dX(
        st.j_cells, j_aux, st.j_species, st.j_grid, jcfg,
        _jax_mesh(JAX_MESHES[mesh]), block=tp.BLOCK)]
    m = _mesh(JAX_MESHES[mesh], 8)
    cfg = _cfg(st, operation=0)
    out = sh.sharded_dN_dX(st.cells, aux, st.species, st.grid, cfg, m)
    fast = sh.sharded_dN_dX_fast(st.cells, aux, st.species, st.grid,
                                 dataclasses.replace(cfg,
                                                     compute_dtype="f32c"), m)
    bar = 1e-6 if case == "df1" else 1e-5
    for a, f, b in zip(out, fast, ref):
        assert _rel(a, b) <= TOL
        assert _rel(f, b) <= bar


@pytest.mark.parametrize("mesh", JAX_WHOLE)
@pytest.mark.parametrize("dimension", [2, 3])
def test_sharded_polarization_matches_jax(polzn, mesh, dimension):
    """The f64 engine to 1e-12 of the JAX sums, P1 at the polarization
    bars, against jsh.sharded_polarization on the JAX package's cells of
    the same surface."""
    p = polzn[dimension]
    jcfg = JConfig(operation=1, mode=5, df_mode=1, hrg_eos=3,
                   dimension=dimension, cell_block=tp.BLOCK)
    j_species_t = j_read_pdg(3, p["wd"] / "PDG")
    j_chosen = j_species_t.chosen_indices(tp.CHOSEN)
    j_cells = j_prepare_cells(p["surf"], jcfg, block=tp.BLOCK)
    ref = np.asarray(jsh.sharded_polarization(
        j_cells, JSpecies.from_table(j_species_t, j_chosen),
        JGrid.from_grids(JGrids.from_dir(p["wd"] / "tables"), dimension),
        p["T"], jcfg, _jax_mesh(JAX_MESHES[mesh]), block=tp.BLOCK,
        delta_eta=p["d_eta"]))
    m = _mesh(JAX_MESHES[mesh], 8)
    args = (p["cells"], p["species"], p["grid"], p["T"])
    out = sh.sharded_polarization(*args, p["cfg"], m, delta_eta=p["d_eta"])
    assert _polzn_err(out, ref) <= TOL
    fast = sh.sharded_polarization_fast(
        *args, dataclasses.replace(p["cfg"], compute_dtype="f32c"), m,
        delta_eta=p["d_eta"])
    norm, pe = kc.polarization_errors(fast.numpy(), ref)
    assert norm <= kc.POLZN_TOL_NORM and pe <= kc.POLZN_TOL_P, (norm, pe)


def test_species_arrays_cut_keeps_every_field(states):
    st = states["df1"]
    cut = sh.cut_species(st.species, 2, 5, CPU)
    for f in dataclasses.fields(SpeciesArrays):
        assert torch.equal(getattr(cut, f.name),
                           getattr(st.species, f.name)[2:5])
