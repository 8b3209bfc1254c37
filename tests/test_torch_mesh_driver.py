"""``use_mesh`` through the port's entry points on CPU meshes: the driver,
the sampler's event axis (is3d2_tpu_torch/parallel/sampler_shard.py) and
the ensemble's surface axis.

The port's driver runs with ``local_devices`` replaced by [cpu] * 4, so
that ``use_mesh 1`` gives it a (4, 1) mesh (or (2, 2) with
mesh_species_shards 2); the JAX driver runs meshed on the 8 virtual
devices of tests/conftest.py, as torch_parity.run_drivers runs it (its
f64 route).  Workdirs: torch_parity's build_workdir (512 cells, 8
species, 16 pT x 8 phi, 8 eta nodes or the 3+1d y table; cell_block 128)
and build_sampler_workdir (60 cells).

Bars:
  * the port's meshed run against its single-device run: 1e-12 relative
    on bins >= 1e-4 of each species' peak (the polarization: each of the
    five sums in units of its max), every route summing its cells in f64
    on whole-block cuts;
  * the port's meshed run against the JAX meshed f64 route: the bars of
    the single-device parity tests (f64 1e-10; B1 1e-6; B3 and its famod
    mode 1e-4; the polarization's 2e-5 on Snorm and 1e-5 on P);
  * the sampler: meshed histograms and particle lists equal to the
    single-device ones exactly (the same chunks and the same streams);
    against the JAX meshed sampler, which folds each device's index into
    its key, dN/dy and the pT histograms by the two-sample chi^2 of
    tests/test_torch_sampler.py (p > 1e-3);
  * the ensemble with ``mesh``: every surface bit for bit its single run.
"""

import contextlib
import dataclasses
import io
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

import torch_parity as tp  # noqa: E402

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.parallel import sampler_shard as j_shard  # noqa: E402
from is3d2_tpu.parallel import sharding as jsh  # noqa: E402

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import ensemble as ens  # noqa: E402
from is3d2_tpu_torch.core import sampler as ps  # noqa: E402
from is3d2_tpu_torch.core.sampler_hist import (ChunkBinner,  # noqa: E402
                                               bin_histograms)
from is3d2_tpu_torch.core.spectra import compute_spectra  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.parallel import make_mesh  # noqa: E402
from is3d2_tpu_torch.parallel import sampler_shard as shard  # noqa: E402
from is3d2_tpu_torch.parallel import sharding as sh  # noqa: E402
from is3d2_tpu_torch.physics.deltaf import \
    compute_particle_densities  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import (make_eos_consistent,  # noqa: E402
                                             make_surface)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-12


@pytest.fixture
def cpu4(monkeypatch):
    """The port sees four CPU devices: use_mesh 1 meshes over them."""
    monkeypatch.setattr(sh, "local_devices", lambda device=None: [CPU] * 4)


def _port(workdir, **fields):
    cfg = dataclasses.replace(
        Config.from_file(workdir / "iS3D_parameters.dat"), **fields)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        run = IS3D(workdir, cfg=cfg, device="cpu")
        run.run_particlization(write=False)
    run.log = log.getvalue()
    return run


def _rel(out, ref):
    return tp.max_rel_err(np.asarray(out), np.asarray(ref))


def _polzn_err(out, ref):
    return max(tp.scale_err(o, r) for o, r in zip(out, ref))


@pytest.fixture(scope="module")
def wd(tmp_path_factory):
    return tp.build_workdir(tmp_path_factory.mktemp("mesh_op1"), n_eta=8,
                            params={"cell_block": tp.BLOCK})


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """torch_parity's tiny workdirs (128 cells, 3 species, 8 pT x 4 phi x
    8 eta) in blocks of 32, for the df 3-5 cases, whose f64 preps and
    engines are slow on the CPU: four blocks, one a shard."""
    return {df: tp.tiny_workdir(tmp_path_factory.mktemp(f"mesh_tiny{df}"),
                                df, "f64", cell_block=32)
            for df in (3, 4, 5)}


@pytest.fixture(scope="module")
def wd3(tmp_path_factory):
    return tp.build_workdir(tmp_path_factory.mktemp("mesh_3d"),
                            params={"cell_block": tp.BLOCK}, dimension=3)


# ----------------------------------------------------------------------
# the driver, operations 0 and 1
# ----------------------------------------------------------------------

# name -> (workdir, config fields, bar against the JAX f64 route)
OP1_CASES = {
    "df1-f32c": ("wd", {"df_mode": 1, "compute_dtype": "f32c"}, 1e-6),
    "df2-f64": ("wd", {"df_mode": 2, "compute_dtype": "f64"}, 1e-10),
    "df3-f64": (3, {"df_mode": 3, "compute_dtype": "f64"}, 1e-10),
    "df4-f32": (4, {"df_mode": 4, "compute_dtype": "f32"}, 1e-4),
    "df5-f32c": (5, {"df_mode": 5, "compute_dtype": "f32c"}, 1e-4),
    "3d-df1-f32c": ("wd3", {"df_mode": 1, "compute_dtype": "f32c"}, 1e-6),
}


def _workdir(request, name):
    if isinstance(name, int):
        return request.getfixturevalue("tiny")[name]
    return request.getfixturevalue(name)


@pytest.mark.parametrize("case", OP1_CASES)
def test_op1_driver_with_use_mesh(request, cpu4, case):
    name, fields, bar = OP1_CASES[case]
    workdir = _workdir(request, name)
    fields = {"operation": 1, **fields}
    ref, meshed = tp.run_drivers(workdir, use_mesh=1, **fields)
    assert meshed.mesh is not None and meshed.mesh.size == 4
    assert len(sh.last_shards) == 4
    single = _port(workdir, use_mesh=0, **fields)
    assert single.mesh is None
    assert _rel(meshed.spectra, single.spectra) <= TOL
    assert _rel(meshed.spectra, ref.spectra) <= bar


@pytest.mark.parametrize("fields", [
    {"df_mode": 1, "compute_dtype": "f32", "mesh_species_shards": 2},
    {"df_mode": 2, "compute_dtype": "f64", "mesh_species_shards": 2},
    {"df_mode": 2, "compute_dtype": "f64", "dimension": 3}],
    ids=["b1-2x2", "f64-2x2", "3d-f64"])
def test_op1_meshed_equals_single(request, cpu4, fields):
    """More routes of the port alone: the species axis of B1 and of the
    f64 engine, and the 3+1d f64 engine."""
    workdir = _workdir(request, "wd3" if fields.get("dimension") == 3
                       else "wd")
    fields = {"operation": 1, **fields}
    fields.pop("dimension", None)
    meshed = _port(workdir, use_mesh=1, **fields)
    single = _port(workdir, use_mesh=0, **fields)
    assert _rel(meshed.spectra, single.spectra) <= TOL


def test_the_log_names_the_mesh(wd, cpu4):
    run = _port(wd, use_mesh=1, operation=1, df_mode=1, compute_dtype="f32c",
                mesh_species_shards=2)
    assert "mesh: 2 cell x 2 species shards over cpu, cpu, cpu, cpu" \
        in run.log
    assert "mesh:" not in _port(wd, use_mesh=0, operation=1).log


def test_use_mesh_auto_stays_on_one_device_on_the_cpu(wd, cpu4):
    """use_mesh -1 shards only over accelerator devices (the JAX rule)."""
    assert _port(wd, use_mesh=-1, operation=1, df_mode=1,
                 compute_dtype="f32c").mesh is None


@pytest.mark.parametrize("fields", [
    {"df_mode": 1, "compute_dtype": "f64", "use_pallas": 1},
    {"df_mode": 4, "compute_dtype": "f32", "use_pallas": 1},
    {"df_mode": 1, "compute_dtype": "f32", "use_pallas": 1}],
    ids=["b2", "b3-use_pallas", "f32-use_pallas"])
def test_routes_that_stay_on_one_device(wd, cpu4, fields):
    """Where the JAX package keeps a route on one device under a mesh
    (df 1/2 with use_pallas 1 in 2+1d and not f32c; df 3-5 with
    use_pallas 1 in 2+1d), the port runs its single-device route: the same
    bits as use_mesh 0, and no shard recorded."""
    sh.last_shards.clear()
    meshed = _port(wd, use_mesh=1, operation=1, **fields)
    assert meshed.mesh is not None and sh.last_shards == []
    single = _port(wd, use_mesh=0, operation=1, **fields)
    np.testing.assert_array_equal(meshed.spectra, single.spectra)


OP0_CASES = {
    "df1-f32c": ("wd", {"df_mode": 1, "compute_dtype": "f32c"}, 1e-6),
    "df4-f32": (4, {"df_mode": 4, "compute_dtype": "f32"}, 1e-4),
}


@pytest.mark.parametrize("case", OP0_CASES)
def test_op0_driver_with_use_mesh(request, cpu4, case):
    """Operation 0 cut over the whole mesh: the kernel route per bin on
    each shard."""
    name, fields, bar = OP0_CASES[case]
    workdir = _workdir(request, name)
    fields = {"operation": 0, **fields}
    ref, meshed = tp.run_drivers(workdir, use_mesh=1, **fields)
    assert len(sh.last_shards) == 4
    single = _port(workdir, use_mesh=0, **fields)
    cfg = meshed.cfg
    for a, b, r in zip(meshed.dN_dX.normalized(cfg),
                       single.dN_dX.normalized(cfg),
                       ref.dN_dX.normalized(ref.cfg)):
        assert _rel(a, b) <= TOL
        assert _rel(a, r) <= bar


@pytest.mark.parametrize("case, fields", [
    ("wd3", {"df_mode": 1, "compute_dtype": "f32c"}),
    (4, {"df_mode": 4, "compute_dtype": "f64"})], ids=["3d-f32c", "df4-f64"])
def test_op0_meshed_equals_single(request, cpu4, case, fields):
    """3+1d operation 0 runs the meshed f64 engine on every dtype, as in
    JAX; 2+1d f64 the f64 bins over the mesh."""
    workdir = _workdir(request, case)
    fields = {"operation": 0, **fields}
    meshed = _port(workdir, use_mesh=1, **fields)
    single = _port(workdir, use_mesh=0, **fields)
    cfg = meshed.cfg
    for a, b in zip(meshed.dN_dX.normalized(cfg),
                    single.dN_dX.normalized(cfg)):
        assert _rel(a, b) <= TOL


@pytest.fixture(scope="module")
def wd_m5(tmp_path_factory):
    return {d: tp.build_workdir(tmp_path_factory.mktemp(f"mesh_m5_{d}"),
                                n_eta=8, surface_mode=5, dimension=d,
                                params={"cell_block": 256})
            for d in (2, 3)}


@pytest.mark.parametrize("dimension, dtype", [(2, "f32c"), (3, "f32c"),
                                              (2, "f64")])
def test_mode5_polarization_with_use_mesh(wd_m5, cpu4, dimension, dtype):
    """Mode 5 (operation 1, df 1): the polarization under the mesh (P1 or
    P1's 3+1d mode with cells over "cells", 256-cell blocks so that the
    3+1d mode's f32 runs stay whole; the f64 engine over the mesh)."""
    workdir = wd_m5[dimension]
    fields = {"operation": 1, "df_mode": 1, "compute_dtype": dtype}
    ref, meshed = tp.run_drivers(workdir, use_mesh=1, **fields)
    single = _port(workdir, use_mesh=0, **fields)
    assert _polzn_err(np.stack(meshed.polarization),
                      np.stack(single.polarization)) <= TOL
    norm, p = kc.polarization_errors(np.stack(meshed.polarization),
                                     np.stack(ref.polarization))
    if dtype == "f64":
        assert norm <= 1e-10 and p <= 1e-10, (norm, p)
    else:
        assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


# ----------------------------------------------------------------------
# the sampler's event axis
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wd_op2(tmp_path_factory):
    return tp.build_sampler_workdir(tmp_path_factory.mktemp("mesh_op2"),
                                    params={"operation": 2, "df_mode": 1,
                                            "cell_block": 64,
                                            "sampler_seed": 7})


def _chunked(workdir, n_chunks=10, **fields):
    """Fields for a campaign of about ``n_chunks`` chunks."""
    cfg = Config.from_file(workdir / "iS3D_parameters.dat")
    inp = tp.sampler_inputs(workdir, fields.get("df_mode", cfg.df_mode),
                            jax_side=False)
    cfg = dataclasses.replace(cfg, **fields)
    Ntot = ps.compute_total_yield(inp.surf, inp.species, inp.chosen,
                                  inp.df_data, cfg, inp.laguerre, "cpu")
    n_events = ps.number_of_events(Ntot, cfg)
    return {**fields, "sampler_chunk_hadrons": Ntot * n_events / n_chunks}


@pytest.mark.parametrize("df_mode", [1, 4])
def test_meshed_histograms_equal_the_single_device_ones(wd_op2, cpu4,
                                                        df_mode):
    fields = _chunked(wd_op2, test_sampler=1, df_mode=df_mode,
                      min_num_hadrons=2e4)
    meshed = _port(wd_op2, use_mesh=1, **fields)
    single = _port(wd_op2, use_mesh=0, **fields)
    assert meshed.sampler_diags["chunks"] >= 8
    for f in dataclasses.fields(single.histograms):
        np.testing.assert_array_equal(
            getattr(meshed.histograms, f.name),
            getattr(single.histograms, f.name), err_msg=f.name)
    for k in ("drawn", "kept", "mom_proposals", "dropped", "chunks"):
        assert meshed.sampler_diags[k] == single.sampler_diags[k], k


@pytest.mark.parametrize("df_mode", [1, 5])
def test_meshed_particle_lists_equal_the_single_device_ones(
        wd_op2, cpu4, tmp_path, df_mode):
    """Without files (the collector), and for df 1 into OSCAR files (the
    streaming writer): the same rows, event for event."""
    fields = _chunked(wd_op2, test_sampler=0, df_mode=df_mode,
                      min_num_hadrons=5e3)
    meshed = _port(wd_op2, use_mesh=1, **fields)
    single = _port(wd_op2, use_mesh=0, **fields)
    assert meshed.sampler_diags["chunks"] >= 8
    a, b = meshed.final_particles, single.final_particles
    assert a.n_valid == b.n_valid > 0
    for f in ("event", "mcid", "px", "py", "pz", "E", "eta", "t", "x", "y",
              "z", "tau", "mass"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    if df_mode != 1:
        return
    files = {}
    for um in (1, 0):
        wd = tmp_path / f"m{um}"
        shutil.copytree(wd_op2, wd)
        cfg = dataclasses.replace(
            Config.from_file(wd / "iS3D_parameters.dat"), use_mesh=um,
            **fields)
        with contextlib.redirect_stdout(io.StringIO()):
            IS3D(wd, cfg=cfg, device="cpu").run_particlization()
        files[um] = {p.name: p.read_bytes() for p in
                     sorted((wd / "results").glob("particle_list_osc_*"))}
    assert len(files[1]) == meshed.n_events and files[1] == files[0]


def _inputs_and_campaign(wd_op2, df_mode, **fields):
    inp = tp.sampler_inputs(wd_op2, df_mode, jax_side=False)
    cfg = dataclasses.replace(Config.from_file(wd_op2 / "iS3D_parameters.dat"),
                              df_mode=df_mode, **fields)
    return inp, cfg


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_sample_particles_meshed_equals_sample_particles(wd_op2, mesh):
    """The full-form campaign (no consumer), concatenated: every column
    equal to the single-device campaign's."""
    inp, cfg = _inputs_and_campaign(wd_op2, 1, sampler_chunk_hadrons=150.0)
    args = (inp.surf, inp.species, inp.chosen, inp.df_data, cfg,
            inp.laguerre, 60)
    out = shard.sample_particles_meshed(*args, make_mesh(*mesh, [CPU] * 4),
                                        "cpu", seed=3)
    ref = ps.sample_particles(*args, "cpu", seed=3)
    assert out["chunks"] == ref["chunks"] >= 8
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(out[k], v), k


def test_sample_histograms_meshed_equals_the_binned_campaign(wd_op2):
    inp, cfg = _inputs_and_campaign(wd_op2, 4, sampler_chunk_hadrons=150.0)
    args = (inp.surf, inp.species, inp.chosen, inp.df_data, cfg,
            inp.laguerre, 60)
    hist, diags = shard.sample_histograms_meshed(
        *args, make_mesh(4, 1, [CPU] * 4), "cpu", seed=5)
    binner = ChunkBinner(len(inp.chosen), cfg)
    ref = ps.sample_particles(*args, "cpu", seed=5, chunk_consumer=binner)
    assert diags["kept"] == ref["kept"] and diags["chunks"] >= 8
    ref = binner.result(60)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(hist, f.name),
                                      getattr(ref, f.name), err_msg=f.name)


def _per_device_single(inp, cfg, seed, epd, n_dev):
    """The single-device counterpart of the sharded_sampler_* functions:
    device k's chunk of ``epd`` events with the stream chunk_generator
    (seed, k), run one after another on the CPU."""
    setup, species, _ = ps.prepare_setup(inp.surf, inp.species, inp.chosen,
                                         inp.df_data, cfg, inp.laguerre,
                                         "cpu")
    camp = ps.prepare_campaign(setup, species, inp.species.mc_id[inp.chosen],
                               cfg)
    chunks = [ps.sample_chunk(camp, epd, k * epd,
                              ps.chunk_generator(seed, k, "cpu"),
                              ps.ChunkStats()) for k in range(n_dev)]
    return setup, species, chunks


def test_sharded_sampler_counts_and_histograms(wd_op2):
    inp, cfg = _inputs_and_campaign(wd_op2, 1)
    epd, seed = 20, 11
    setup, species, chunks = _per_device_single(inp, cfg, seed, epd, 4)
    mesh = make_mesh(2, 2, [CPU] * 4)
    mcid = inp.species.mc_id[inp.chosen]
    counts, hist = shard.sharded_sampler_counts(setup, species, mcid, seed,
                                                cfg, epd, mesh)
    sp = torch.cat([c["sp_idx"] for c in chunks])
    pT = torch.cat([torch.sqrt(c["px"] ** 2 + c["py"] ** 2) for c in chunks])
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(sp.numpy(), minlength=len(inp.chosen)))
    ib = torch.clamp((pT / 3.0 * 32).to(torch.int64), 0, 31)
    np.testing.assert_array_equal(hist.numpy(),
                                  np.bincount(ib.numpy(), minlength=32))
    hists = shard.sharded_sampler_histograms(setup, species, mcid, seed, cfg,
                                             epd, mesh)
    S = len(inp.chosen)
    ref = None
    for c in chunks:
        h = bin_histograms(c, S, cfg)
        ref = h if ref is None else {k: ref[k] + v if k != "pT_count"
                                     else ref[k] for k, v in h.items()}
    for k in ("dN_dy", "dN_2pipTdpTdy", "dN_taudtaudy", "vn_real"):
        assert torch.equal(hists[k], ref[k]), k


@pytest.mark.parametrize("df_mode", [1])
def test_meshed_sampler_agrees_with_the_jax_meshed_sampler(wd_op2, df_mode):
    """The JAX meshed campaign (8 devices, fold_in'd keys) and the port's
    (4 CPU devices): dN/dy and the pT histograms by the two-sample chi^2
    of tests/test_torch_sampler.py."""
    n_events = 2000
    jcfg = JConfig(operation=2, df_mode=df_mode, hrg_eos=3,
                   include_shear_deltaf=1, include_bulk_deltaf=1,
                   cell_block=64, regulate_deltaf=1, outflow=1, fast=1,
                   pT_bins=30, y_bins=20, sampler_chunk_hadrons=5e3)
    ji = tp.sampler_inputs(wd_op2, df_mode, jax_side=True)
    ref, _ = j_shard.sample_histograms_meshed(
        ji.surf, ji.species, ji.chosen, ji.df_data, jcfg, ji.laguerre,
        n_events, jsh.make_mesh(8, 1), seed=13)
    inp = tp.sampler_inputs(wd_op2, df_mode, jax_side=False)
    ours, diags = shard.sample_histograms_meshed(
        inp.surf, inp.species, inp.chosen, inp.df_data, tp.port_config(jcfg),
        inp.laguerre, n_events, make_mesh(4, 1, [CPU] * 4), "cpu", seed=13)
    assert diags["chunks"] > 4
    for name in ("dN_dy", "dN_2pipTdpTdy"):
        for i in range(len(inp.chosen)):
            p, chi2, dof = tp.chi2_p(getattr(ours, name)[i],
                                     np.asarray(ref[name])[i])
            assert p > 1e-3, (name, i, chi2, dof)


# ----------------------------------------------------------------------
# the ensemble's surface axis
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ens_inputs(wd_op2):
    return {d: tp.sampler_inputs(wd_op2, d, jax_side=False) for d in (1, 4)}


def test_surface_groups_cut_by_mesh_axis_0():
    mesh = make_mesh(2, 2, [CPU] * 4)
    assert ens.surface_groups(5, mesh, CPU) == [(CPU, [0, 1, 2]),
                                                (CPU, [3, 4])]
    assert ens.surface_groups(3, None, CPU) == [(CPU, [0, 1, 2])]
    assert [g for _, g in ens.surface_groups(
        2, make_mesh(4, 1, [CPU] * 4), CPU)] == [[0], [1]]


def test_meshed_spectra_ensemble_equals_single_runs(wd, cpu4):
    from is3d2_tpu_torch.io.pdg import read_pdg
    from is3d2_tpu_torch.io.tables import MomentumGrids
    species = read_pdg(3, wd / "PDG")
    chosen = species.chosen_indices(tp.CHOSEN)
    grids = MomentumGrids.from_dir(wd / "tables")
    inp = tp.sampler_inputs(wd, 1, jax_side=False)
    cfg = Config(operation=1, df_mode=1, compute_dtype="f32c",
                 cell_block=tp.BLOCK, use_mesh=1)
    surfs = [make_surface(n, seed=100 + i, shear_scale=0.03)
             for i, n in enumerate((16, 333, 200, 512, 64))]
    out = ens.compute_spectra_ensemble(
        surfs, species, chosen, grids, inp.df_data, cfg,
        mesh=make_mesh(4, 1, [CPU] * 4), device="cpu")
    for i, s in enumerate(surfs):
        one = compute_spectra(s, species, chosen, grids, inp.df_data,
                              dataclasses.replace(cfg, use_mesh=0), "cpu")
        np.testing.assert_array_equal(out[i], one)


def _ens_surfaces(df_mode, inp):
    surfs = [make_surface(n, seed=700 + i, shear_scale=0.1, bulk_scale=0.05)
             for i, n in enumerate((40, 60, 30))]
    if df_mode == 5:
        surfs = [make_eos_consistent(s, inp.species, inp.laguerre)
                 for s in surfs]
    return surfs


@pytest.mark.parametrize("df_mode", [1, 4, 5])
def test_meshed_particle_lists_ensemble_equals_single_runs(
        wd_op2, tmp_path, df_mode):
    """sample_ensemble_particle_lists with ``mesh``: every surface's files
    the bytes of its single run (sample_particles with its surface seed
    into a StreamingEventWriter), as without a mesh."""
    from is3d2_tpu_torch.io.output import StreamingEventWriter
    inp = tp.sampler_inputs(wd_op2, df_mode, jax_side=False)
    cfg = Config(operation=2, df_mode=df_mode, fast=1, cell_block=16,
                 sampler_chunk_hadrons=300.0)
    surfs = _ens_surfaces(df_mode, inp)
    n_events = 5
    ens.sample_ensemble_particle_lists(
        surfs, inp.species, inp.chosen, inp.df_data, cfg, inp.laguerre,
        n_events, capacity=1, results_root=tmp_path / "ens", seed=4,
        mesh=make_mesh(2, 2, [CPU] * 4), device="cpu")
    for i, surf in enumerate(surfs):
        table = inp.species
        if df_mode != 5:
            table = dataclasses.replace(inp.species)
            compute_particle_densities(table, inp.df_data, inp.laguerre,
                                       surf.thermo_averages())
        writer = StreamingEventWriter(tmp_path / f"one_{i}")
        ps.sample_particles(surf, table, inp.chosen, inp.df_data, cfg,
                            inp.laguerre, n_events, "cpu",
                            seed=ps.surface_seed(4, i),
                            chunk_consumer=writer, lean=True)
        writer.close()
        got = sorted((tmp_path / "ens" / f"surface_{i}").glob("particle_*"))
        want = sorted((tmp_path / f"one_{i}").glob("particle_*"))
        assert [p.name for p in got] == [p.name for p in want]
        assert len(got) == n_events
        assert all(a.read_bytes() == b.read_bytes()
                   for a, b in zip(got, want))


def test_meshed_histogram_ensemble_equals_the_unmeshed_one(wd_op2):
    inp = tp.sampler_inputs(wd_op2, 4, jax_side=False)
    cfg = Config(operation=2, df_mode=4, fast=1, cell_block=16)
    surfs = _ens_surfaces(4, inp)
    args = (surfs, inp.species, inp.chosen, inp.df_data, cfg, inp.laguerre)
    kw = {"events_per_surface": 20, "capacity": 1, "seed": 9,
          "device": "cpu"}
    ref, _ = ens.sample_ensemble_histograms(*args, **kw)
    out, overflow = ens.sample_ensemble_histograms(
        *args, mesh=make_mesh(4, 1, [CPU] * 4), **kw)
    assert not overflow.any()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
