"""Operation 2's host side and entry points against the JAX package.

Tolerances: the ChunkCollector's host boost gives the JAX collector's bits
on one fixed LRF chunk (numpy inputs); binning one fixed particle set gives
equal counts in both packages and v_n (the written |sum e^{ik phi}| / n)
within 1e-6; the OSCAR, CSV and histogram writers give equal bytes on equal
inputs; the streaming writer gives the post-hoc writer's bytes.  The CLI
runs operation 2 on the CPU for df 1-4 (histograms and event files) and
never imports jax.
"""

import dataclasses
import filecmp
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (PIKP, build_sampler_workdir,  # noqa: E402
                          port_config, sampler_inputs)

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core import sampler as js  # noqa: E402
from is3d2_tpu.core import sampler_hist as jh  # noqa: E402
from is3d2_tpu.io import output as j_output  # noqa: E402
from is3d2_tpu.report import RunReport as JRunReport  # noqa: E402

from is3d2_tpu_torch import cli  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import sampler as ps  # noqa: E402
from is3d2_tpu_torch.core import sampler_hist as ph  # noqa: E402
from is3d2_tpu_torch.io import output  # noqa: E402
from is3d2_tpu_torch.report import RunReport  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_sampler_workdir(tmp_path_factory.mktemp("torch_sampler_io"))


def _lrf_chunk(packed: bool, seed: int = 2):
    """One fixed lean chunk as numpy: 3000 kept rows over 64 cells and 3
    species, LRF momenta, ids packed or not."""
    rng = np.random.default_rng(seed)
    C, S, n, ev0, n_ev = 64, 3, 3000, 40, 20
    f32 = np.float32
    cell = {"cell_tau": rng.uniform(1.0, 10.0, C), "cell_x": rng.uniform(-9, 9, C),
            "cell_y": rng.uniform(-9, 9, C), "cell_eta": np.zeros(C),
            "cell_ux": rng.uniform(-1, 1, C), "cell_uy": rng.uniform(-1, 1, C),
            "cell_un": np.zeros(C)}
    cell = {k: v.astype(f32) for k, v in cell.items()}
    cell["cell_ux"][:3] = 0.0          # uperp -> 0 guard of the tetrad
    cell["cell_uy"][:3] = 0.0
    ci = rng.integers(0, C, n)
    sp = rng.integers(0, S, n)
    ev = rng.integers(0, n_ev, n)
    ch = {"px": rng.normal(0, 0.4, n).astype(f32),
          "py": rng.normal(0, 0.4, n).astype(f32),
          "pz": rng.normal(0, 0.4, n).astype(f32),
          "mcid": np.array(PIKP, dtype=np.int64),
          "mass_tab": np.array([0.13957, 0.493677, 0.938272], dtype=f32),
          "lrf": True, "dimension": 2, "y_max": 5.0, "ev0": ev0, "n_ev": n_ev,
          "rap_seed": ps.rap_seed(7, ev0), **cell}
    if packed:
        bits = ps.pack_bits(C, S, n_ev)
        ch["ids_packed"] = ps.pack_ids(torch.from_numpy(ci), torch.from_numpy(sp),
                                       torch.from_numpy(ev), bits).numpy()
        ch["pack_bits"] = bits
    else:
        ch.update(event=(ev + ev0).astype(np.int32),
                  sp_idx=sp.astype(np.int32), cell_idx=ci.astype(np.int32))
    return ch


@pytest.mark.parametrize("packed", [True, False])
def test_chunk_collector_matches_jax_bits(packed):
    ch = _lrf_chunk(packed)
    ours = ps.ChunkCollector()
    ours({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in ch.items()})
    ref = js.ChunkCollector()
    jch = dict(ch, keep=np.ones(3000, dtype=bool))
    if packed:
        jch["ids_packed"] = ch["ids_packed"].view(np.uint32)
    else:
        jch["sp_idx"] = ch["sp_idx"].astype(np.uint16)
    ref(jch)
    a, b = ours.particle_list(), ref.particle_list()
    assert a.n_valid == b.n_valid == 3000
    for f in ("event", "mcid", "tau", "x", "y", "eta", "t", "z", "E", "px",
              "py", "pz", "mass"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype or f in ("event", "mcid"), f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _fixed_particles(n=8000, seed=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"sp_idx": rng.integers(0, 3, n),
            "px": rng.normal(0, 0.8, n).astype(f32),
            "py": rng.normal(0, 0.8, n).astype(f32),
            "x": rng.normal(0, 4.0, n).astype(f32),
            "y": rng.normal(0, 4.0, n).astype(f32),
            "rapidity": rng.uniform(-5.5, 5.5, n).astype(f32),
            "eta": rng.normal(0, 3.0, n).astype(f32),
            "tau": rng.uniform(0.5, 13.0, n).astype(f32)}


def _vn(h):
    cnt = np.asarray(h.pT_count, np.float64)[None]
    return np.where(cnt > 0, np.hypot(np.asarray(h.vn_real),
                                      np.asarray(h.vn_imag))
                    / np.maximum(cnt, 1), 0.0)


def test_binning_matches_jax():
    cfg = JConfig(operation=2)
    parts = _fixed_particles()
    ref = jh.bin_sampled_particles(dict(parts, keep=np.ones(8000, bool)),
                                   3, cfg, 50)
    ours = ph.bin_sampled_particles(
        {k: torch.from_numpy(v) for k, v in parts.items()}, 3,
        port_config(cfg), 50)
    for f in ("dN_dy", "dN_deta", "dN_2pipTdpTdy", "pT_count", "dN_dphipdy",
              "dN_taudtaudy", "dN_2pirdrdy", "dN_dphisdy"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.dN_dy.sum() < 8000         # some rows fall outside |y| < 5
    # the JAX binner sums the cos/sin terms in f32 (its one-hot matmul),
    # the port in f64: ~27 rows a bin keep the difference under the bar
    assert np.abs(_vn(ours) - _vn(ref)).max() <= 1e-6
    # a keep mask selects rows
    keep = np.arange(8000) % 3 == 0
    sub = ph.bin_sampled_particles(
        {k: torch.from_numpy(v[keep]) for k, v in parts.items()}, 3,
        port_config(cfg), 50)
    masked = ph.bin_sampled_particles(
        dict({k: torch.from_numpy(v) for k, v in parts.items()},
             keep=torch.from_numpy(keep)), 3, port_config(cfg), 50)
    np.testing.assert_array_equal(sub.dN_dy, masked.dN_dy)


def test_histogram_writer_bytes(tmp_path):
    cfg = JConfig(operation=2)
    hist = ph.bin_sampled_particles(
        {k: torch.from_numpy(v) for k, v in _fixed_particles().items()}, 3,
        port_config(cfg), 50)
    output.write_sampled_histograms(tmp_path / "ours", PIKP, hist,
                                    port_config(cfg))
    j_output.write_sampled_histograms(tmp_path / "ref", PIKP, hist, cfg)
    ref = sorted(p.relative_to(tmp_path / "ref")
                 for p in (tmp_path / "ref").rglob("*.dat"))
    assert len(ref) == 9 * 3
    assert sorted(p.relative_to(tmp_path / "ours")
                  for p in (tmp_path / "ours").rglob("*.dat")) == ref
    for r in ref:
        assert filecmp.cmp(tmp_path / "ours" / r, tmp_path / "ref" / r,
                           shallow=False), r


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_particle_list_writer_bytes(tmp_path, dtype):
    rng = np.random.default_rng(8)
    n, n_events = 5000, 17
    cols = {f: rng.normal(0, 3, n).astype(dtype)
            for f in ("tau", "x", "y", "eta", "t", "z", "E", "px", "py",
                      "pz", "mass")}
    pl = ps.ParticleList(valid=rng.random(n) > 0.1,
                         event=rng.integers(0, n_events, n),
                         mcid=rng.choice(np.array(PIKP), n), **cols)
    output.write_particle_list_oscar(tmp_path / "ours", pl, n_events)
    output.write_particle_list_csv(tmp_path / "ours", pl, n_events)
    j_output.write_particle_list_oscar(tmp_path / "ref", pl, n_events)
    j_output.write_particle_list_csv(tmp_path / "ref", pl, n_events)
    for e in range(1, n_events + 1):
        for stem in ("particle_list_osc", "particle_list"):
            name = f"{stem}_{e}.dat"
            assert (tmp_path / "ours" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes(), name


def test_streaming_writer_matches_posthoc(workdir, tmp_path):
    inp = sampler_inputs(workdir, 1, jax_side=False)
    n_events = 120
    cfg = dataclasses.replace(port_config(JConfig(operation=2, df_mode=1,
                                                  cell_block=64)),
                              sampler_chunk_hadrons=1500.0)
    args = (inp.surf, inp.species, inp.chosen, inp.df_data, cfg,
            inp.laguerre, n_events, "cpu")
    coll = ps.ChunkCollector()
    d = ps.sample_particles(*args, seed=9, chunk_consumer=coll, lean=True)
    assert d["chunks"] > 2
    output.write_particle_list_oscar(tmp_path / "ref", coll.particle_list(),
                                     n_events)
    output.write_particle_list_csv(tmp_path / "ref", coll.particle_list(),
                                   n_events)
    writer = output.StreamingEventWriter(tmp_path / "stream", csv=True)
    ps.sample_particles(*args, seed=9, chunk_consumer=writer, lean=True)
    writer.close()
    assert writer.events_written == n_events
    assert writer.particle_list().n_valid == coll.particle_list().n_valid
    assert writer.rows_written == 2 * d["kept"]
    assert len(writer.busy) == d["chunks"]
    for e in range(1, n_events + 1):
        for stem in ("particle_list_osc", "particle_list"):
            name = f"{stem}_{e}.dat"
            assert (tmp_path / "stream" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes(), name


def test_streaming_writer_hands_on_its_error(tmp_path):
    import shutil
    writer = output.StreamingEventWriter(tmp_path / "out")
    shutil.rmtree(tmp_path / "out")   # the writer thread cannot open files
    writer({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in _lrf_chunk(True).items()})
    with pytest.raises(OSError, match="particle-list write failed"):
        writer.close()


def test_sampler_report_lines_match_jax():
    ours, ref = RunReport(), JRunReport()
    for r in (ours, ref):
        r.n_cells = 60
        r.mom_proposals, r.mom_acceptances = 1234567, 1000001
        r.hadrons_drawn, r.hadrons_kept, r.dropped_lanes = 90000, 40000, 3
    lines, ref_lines = ours.lines(), ref.lines()
    for line in ref_lines:
        assert line in lines
    ours.sampler_chunks, ours.sampler_syncs, ours.largest_chunk = 3, 24, 31000
    assert "sampler: 3 chunk(s), 8.0 device syncs per chunk, largest chunk " \
        "31000 lanes (buffers sized exactly), campaign prep 0.000 s" \
        in ours.lines()


@pytest.mark.parametrize("kw", [
    {"df_mode": 5, "mode": 5, "dimension": 3},
    {"mode": 5, "dimension": 3},
])
def test_validate_slice_lets_operation2_in_3d_mode5_through(kw):
    """Operation 2 on a 3+1d mode-5 surface: the sampler, then the
    polarization (tests/test_torch_polarization_3d.py)."""
    Config(operation=2, **{"df_mode": 1, **kw}).validate_slice()


@pytest.mark.parametrize("kw,item", [
    ({"use_mesh": 1}, "A12"),
    ({"mode": 6, "df_mode": 4, "dimension": 3, "use_mesh": 1}, "A12"),
    ({"group_particles": 1, "use_mesh": 1}, "A12")])
def test_validate_slice_operation2_names_its_item(kw, item):
    """Operation 2 under a mesh, rejected until ROADMAP ``item`` was
    ported (parallel/sampler_shard.py), validates; the sampler's event
    axis then runs over the mesh (tests/test_torch_mesh_driver.py)."""
    Config(operation=2, **{"df_mode": 1, **kw}).validate_slice()


@pytest.mark.parametrize("kw", [
    {"df_mode": d, "test_sampler": t, "fast": f, "compute_dtype": c}
    for d in (1, 2, 3, 4, 5) for t, f, c in ((1, 1, "f64"), (0, 0, "f32c"))]
    + [{"df_mode": 1, "use_pallas": 0, "compute_dtype": "f32"}]
    + [{"df_mode": 1, "mode": m} for m in (0, 2, 3, 4, 6, 7)]
    + [{"df_mode": 5, "mode": 3}, {"df_mode": 4, "group_particles": 1}])
def test_validate_slice_lets_operation2_through(kw):
    Config(operation=2, **kw).validate_slice()


def _kept(stdout: str) -> int:
    return int(re.search(r"sampled hadrons: (\d+) kept", stdout).group(1))


@pytest.mark.parametrize("df_mode", [1, 2, 3, 4])
def test_cli_runs_operation2(tmp_path, capsys, df_mode):
    """Histograms (test_sampler = 1, exact rates) and OSCAR + CSV event
    files (test_sampler = 0, cached densities) on the CPU."""
    for ts in (1, 0):
        wd = build_sampler_workdir(
            tmp_path / f"ts{ts}", shear_scale=0.2 if df_mode > 2 else 0.03,
            bulk_scale=0.1 if df_mode > 2 else 0.01,
            params={"operation": 2, "df_mode": df_mode, "test_sampler": ts,
                    "fast": 1 - ts, "min_num_hadrons": 3.0e4,
                    "max_num_samples": 1.0e5,
                    "write_csv": 1, "cell_block": 64})
        assert cli.main([str(wd), "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        n_events = int(re.search(r"sampling (\d+) events", out).group(1))
        kept = _kept(out)
        assert n_events > 1 and kept > 2.0e4
        assert "sampling calculation took" in out
        res = wd / "results"
        if ts:
            for m in PIKP:
                h = np.loadtxt(res / f"sampled/dN_dy/dN_dy_{m}_test.dat")
                assert h.shape == (100, 2) and (h[:, 1] >= 0).all()
            assert len(list((res / "sampled").rglob("*.dat"))) == 27
            continue
        osc = sorted(res.glob("particle_list_osc_*.dat"))
        assert len(osc) == n_events
        rows = 0
        for f in osc:
            lines = f.read_text().splitlines()
            assert lines[0] == "n pid px py pz E m x y z t"
            assert all(len(r.split()) == 11 for r in lines[1:3])
            rows += len(lines) - 1
        assert rows == kept
        assert len(list(res.glob("particle_list_[0-9]*.dat"))) == n_events
        assert "particle-list export" in out


def test_operation2_library_path(workdir):
    """Without files the driver keeps the sampled particles."""
    from is3d2_tpu_torch.driver import IS3D
    cfg = Config(operation=2, df_mode=1, test_sampler=0,
                 min_num_hadrons=5.0e3, cell_block=64)
    run = IS3D(workdir, cfg=cfg, device="cpu")
    run.run_particlization(write=False)
    pl = run.final_particles
    assert pl.n_valid == run.sampler_diags["kept"] > 0
    assert set(np.unique(pl.mcid)) <= set(PIKP)
    assert pl.event.max() < run.n_events
    assert not (workdir / "results" / "particle_list_osc_1.dat").exists()


def test_operation2_runs_without_jax(tmp_path):
    """Operation 2 through the CLI in a fresh process never imports jax or
    the JAX package: df 1 into histograms, df 4 into event files."""
    wd1 = build_sampler_workdir(tmp_path / "h", params={
        "operation": 2, "df_mode": 1, "min_num_hadrons": 2.0e4})
    wd4 = build_sampler_workdir(tmp_path / "e", params={
        "operation": 2, "df_mode": 4, "test_sampler": 0,
        "min_num_hadrons": 2.0e4})
    code = (
        "import sys\n"
        "from is3d2_tpu_torch import cli\n"
        f"cli.main([{str(wd1)!r}, '--device', 'cpu'])\n"
        f"cli.main([{str(wd4)!r}, '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'is3d2_tpu' or m.startswith('is3d2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert (wd1 / "results/sampled/dN_dy/dN_dy_211_test.dat").exists()
    assert (wd4 / "results/particle_list_osc_1.dat").exists()
