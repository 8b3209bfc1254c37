"""The port's tools and campaign scripts (ROADMAP A11b-2) against the JAX
package's, on the CPU:

  * tools/sweep.py: ``run_sweep`` of both packages on one 128-cell,
    3-species, EOS-consistent workdir (so that famod runs), the full matrix
    (grad, ce, ptm, ptb x none, shear, bulk, shear_bulk; famod x none,
    shear).  The archive trees hold the same files; at compute_dtype f64
    every value agrees to 1e-12 or to one unit of its last printed digit
    (the files print 9 significant digits, dN_dy 8 decimals); at f32c the
    port's grad / ptb runs (kernels B1 / B3) meet the JAX f64 archive at
    1e-6 / 1e-4 on bins >= 1e-4 of their peak;
  * tools/modified_distribution.py against scripts/run_modified_distribution.py
    (a subprocess, on a copy of the workdir): the same archive at the f64
    bar;
  * tools/oversample.py: batch b is sample_particles with the seed
    base + 1000 b, byte for byte in its OSCAR files; the batches differ;
    against scripts/oversample.py (the JAX sampler, another RNG) the kept
    counts per species within 5 sigma and the pT histograms by chi^2
    (p > 1e-3);
  * tools/analysis.py: compare_sampling_smooth, compute_observables and
    histogram_event of both packages on the port's own result files give
    equal numbers, with matplotlib and without; the shared scripts
    (scripts/histogram_event.py, compute_observables.py,
    compare_sampling_smooth.py) read the same files and exit 0;
  * tools/choose_particles.py: the same chosen_particles.dat bytes as the
    JAX package's for every preset and an explicit list;
  * every new module imports in a fresh interpreter without jax, and the
    entry points that compute refuse to run without a GPU unless asked for
    the CPU.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (PIKP, build_sampler_workdir, chi2_p,  # noqa: E402
                          set_params, tiny_workdir)

from is3d2_tpu.tools import analysis as j_analysis  # noqa: E402
from is3d2_tpu.tools import choose_particles as j_choose  # noqa: E402
from is3d2_tpu.tools.sweep import run_sweep as j_run_sweep  # noqa: E402

from is3d2_tpu_torch.core.sampler import (sample_particles,  # noqa: E402
                                          to_particle_list)
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import output  # noqa: E402
from is3d2_tpu_torch.tools import analysis  # noqa: E402
from is3d2_tpu_torch.tools import choose_particles  # noqa: E402
from is3d2_tpu_torch.tools import modified_distribution, oversample, sweep  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
F64_TOL = 1e-12
ALL_DF = ("grad", "ce", "ptm", "ptb", "famod")
CORRS = ("none", "shear", "bulk", "shear_bulk")
COMBOS = [(df, c) for df in ALL_DF
          for c in (("none", "shear") if df == "famod" else CORRS)]
NEW_MODULES = ("analysis", "sweep", "choose_particles", "oversample",
               "modified_distribution")


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _script(args, **kw) -> subprocess.CompletedProcess:
    """A repo script in a fresh interpreter on the CPU."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=600, **kw)


def _load(path: Path) -> np.ndarray:
    skip = 1 if path.name.startswith("dN_pTdpTdphidy") else 0
    return np.loadtxt(path, skiprows=skip, ndmin=2)


def _tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _assert_f64_files_agree(ref_dir: Path, out_dir: Path) -> None:
    """Every file of two archives of f64 runs: equal keys, values within
    1e-12 relative or one unit of the last printed digit."""
    assert _tree(out_dir) == _tree(ref_dir)
    for name in _tree(ref_dir):
        ref, out = _load(ref_dir / name), _load(out_dir / name)
        assert out.shape == ref.shape, name
        if name.startswith("dN_dy"):
            unit = np.full(ref.shape, 1e-8)           # "%.8f"
        else:                                          # "%.8e"
            mag = np.floor(np.log10(np.maximum(np.abs(ref), 1e-300)))
            unit = 10.0 ** (mag - 8)
        bar = np.maximum(F64_TOL * np.abs(ref), 1.000001 * unit)
        assert (np.abs(out - ref) <= bar).all(), name


def _assert_files_near_f64(ref_dir: Path, out_dir: Path, tol: float) -> None:
    """A kernel run's archive against an f64 archive: spectra relative on
    bins >= 1e-4 of each file's peak, vn absolute on the (y, pT) rows whose
    dN/2pi pT dpT dy is (vn is a ratio of sums that cancel in the tails of
    a surface this viscous), keys equal."""
    assert _tree(out_dir) == _tree(ref_dir)
    for name in _tree(ref_dir):
        ref, out = _load(ref_dir / name), _load(out_dir / name)
        n_key = 1 if name.startswith("dN_dy") else 2
        np.testing.assert_array_equal(out[:, :n_key], ref[:, :n_key])
        if name.startswith("vn"):
            dn = _load(ref_dir / name.replace("vn", "dN_2pipTdpTdy"))[:, 2]
            rows = np.abs(dn) >= 1e-4 * np.abs(dn).max()
            assert np.abs(out[rows, 2:] - ref[rows, 2:]).max() <= tol, name
            continue
        v, r = out[:, -1], ref[:, -1]
        assert np.isfinite(v).all(), name
        sig = np.abs(r) >= 1e-4 * np.abs(r).max()
        err = (np.abs(v - r)[sig] / np.abs(r)[sig]).max()
        assert err <= tol, f"{name}: {err:.3e}"


# ----------------------------------------------------------------------
# sweep
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both packages' full sweep (f64) on one EOS-consistent workdir, and
    the port's grad / ptb x shear_bulk sweep at f32c on a copy."""
    root = tmp_path_factory.mktemp("torch_tools_sweep")
    wd = tiny_workdir(root / "wd", 5, "f64")
    j = _quiet(j_run_sweep, wd, ALL_DF, CORRS, root / "jax")
    p = _quiet(sweep.run_sweep, wd, ALL_DF, CORRS, root / "port",
               device="cpu")
    wd32 = shutil.copytree(wd, root / "wd_f32c",
                           ignore=shutil.ignore_patterns("results"))
    set_params(wd32, {"compute_dtype": "f32c"})
    p32 = _quiet(sweep.run_sweep, wd32, ("grad", "ptb"), ("shear_bulk",),
                 root / "port_f32c", device="cpu")
    return root, j, p, p32


def test_sweep_archives_the_same_tree(sweeps):
    root, j, p, _ = sweeps
    assert set(p) == set(j) == set(COMBOS)
    assert _tree(root / "port") == _tree(root / "jax")
    # four dN* files and vn of each chosen species
    assert len(_tree(p[("famod", "shear")])) == 5 * len(PIKP)


@pytest.mark.parametrize("df,corr", COMBOS)
def test_sweep_f64_matches_jax(sweeps, df, corr):
    _, j, p, _ = sweeps
    _assert_f64_files_agree(j[(df, corr)], p[(df, corr)])


def test_sweep_corrections_change_the_spectra(sweeps):
    """The switches act: shear moves grad's spectra, bulk moves ptb's."""
    _, _, p, _ = sweeps
    name = "dN_2pipTdpTdy_211.dat"
    for df, a, b in (("grad", "none", "shear"), ("ptb", "none", "bulk")):
        assert np.abs(_load(p[(df, a)] / name)[:, 2]
                      - _load(p[(df, b)] / name)[:, 2]).max() > 0


@pytest.mark.parametrize("stale", [False, True], ids=["renamed", "copied"])
def test_sweep_archives_each_run_and_keeps_the_last(tmp_path, stale):
    """In a workdir without results the runs' directories become their
    archives (renamed), the last run's copied; with a file left from
    before the sweep every run is copied and that file reaches every
    archive, as the JAX tool's copies leave it.  Either way the workdir
    ends with the last run's results, and ``timings`` gets each run's
    stage seconds."""
    wd = tiny_workdir(tmp_path / "wd", 1, "f64")
    left = wd / "results/continuous/dN_dy_99999.dat"
    if stale:
        left.parent.mkdir(parents=True, exist_ok=True)
        left.write_text("0 0\n")
    timings = {}
    combos = [("grad", "none"), ("grad", "shear"), ("ptb", "none")]
    out = _quiet(sweep.run_sweep, wd, ("grad", "ptb"), ("none", "shear"),
                 tmp_path / "out", device="cpu", timings=timings)
    assert set(timings) == set(out) == {*combos, ("ptb", "shear")}
    for key, d in out.items():
        assert (d / left.name).exists() == stale
        assert len(_tree(d)) == 5 * len(PIKP) + stale
        assert {"read", "setup", "compute", "write", "run",
                "archive"} <= set(timings[key])
    last, kept = out[("ptb", "shear")], wd / "results/continuous"
    assert _tree(kept) == _tree(last)
    assert all((kept / n).read_bytes() == (last / n).read_bytes()
               for n in _tree(last))


@pytest.mark.parametrize("df,tol", [("grad", 1e-6), ("ptb", 1e-4)])
def test_sweep_f32c_meets_jax_f64(sweeps, df, tol):
    """grad runs kernel B1, ptb kernel B3 (their plain versions here)."""
    _, j, _, p32 = sweeps
    _assert_files_near_f64(j[(df, "shear_bulk")], p32[(df, "shear_bulk")],
                           tol)


# ----------------------------------------------------------------------
# the modified-distribution matrix
# ----------------------------------------------------------------------

def test_modified_distribution_matches_the_jax_script(tmp_path):
    """The matrix builds Config(...) from the defaults, so the workdir's
    parameter file says what they say (df 4, f64, cell_block 4096)."""
    wd = tiny_workdir(tmp_path / "wd", 4, "f64", cell_block=4096)
    jwd = shutil.copytree(wd, tmp_path / "jwd")
    r = _script([SCRIPTS / "run_modified_distribution.py", jwd,
                 "--out", tmp_path / "jax"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = _quiet(modified_distribution.run_matrix, wd, tmp_path / "port",
                 device="cpu")
    assert len(out) == 16
    _assert_f64_files_agree(tmp_path / "jax", tmp_path / "port")


# ----------------------------------------------------------------------
# the oversampling campaign
# ----------------------------------------------------------------------

BATCHES = 3
EVENTS = 500


def _read_oscar(batch_dir: Path) -> np.ndarray:
    """Every row of a batch's OSCAR files: (pid, px, py, pz, E, ...)."""
    rows = [np.loadtxt(f, skiprows=1, ndmin=2)
            for f in sorted(batch_dir.glob("particle_list_osc_*.dat"))]
    return np.concatenate([r for r in rows if r.size])[:, 1:]


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """The port's campaign and the JAX script's, each on its own copy of
    the sampler workdir."""
    root = tmp_path_factory.mktemp("torch_tools_oversample")
    wd = build_sampler_workdir(root / "port")
    jwd = shutil.copytree(wd, root / "jax")
    r = _script([SCRIPTS / "oversample.py", jwd, "--batches", BATCHES,
                 "--events-per-batch", EVENTS])
    assert r.returncode == 0, r.stderr[-2000:]
    _, ours = _quiet(oversample.run_campaign, wd, BATCHES, EVENTS, "cpu")
    return wd, jwd, ours


@pytest.mark.parametrize("b", range(BATCHES))
def test_oversample_batch_is_a_seeded_sampler_run(campaigns, tmp_path, b):
    wd, _, ours = campaigns
    run = IS3D(wd, device="cpu")
    run.load_surface_from_file()
    _quiet(run._setup)
    seed = oversample.batch_seed(run.cfg.sampler_seed, b)
    assert ours[b]["seed"] == seed == run.cfg.sampler_seed + 1000 * b
    plist = to_particle_list(sample_particles(
        run.surface, run.species, run.chosen_idx, run.df_data, run.cfg,
        run.laguerre, EVENTS, "cpu", seed=seed))
    output.write_particle_list_oscar(tmp_path, plist, EVENTS)
    names = _tree(ours[b]["dir"])
    assert len(names) == EVENTS and names == _tree(tmp_path)
    for name in names:
        assert (ours[b]["dir"] / name).read_bytes() == \
            (tmp_path / name).read_bytes(), name
    assert ours[b]["kept"] == int(plist.valid.sum())


def test_oversample_batches_differ(campaigns):
    _, _, ours = campaigns
    first = [(r["dir"] / "particle_list_osc_1.dat").read_bytes()
             for r in ours]
    assert len(set(first)) == BATCHES


def test_oversample_matches_the_jax_script(campaigns):
    """Another RNG: the kept counts per species within 5 sigma, the pT
    histograms by chi^2."""
    wd, jwd, _ = campaigns
    ours = np.concatenate([_read_oscar(wd / f"results/batch_{b}")
                           for b in range(BATCHES)])
    ref = np.concatenate([_read_oscar(jwd / f"results/batch_{b}")
                          for b in range(BATCHES)])
    for mcid in PIKP:
        a, r = ours[ours[:, 0] == mcid], ref[ref[:, 0] == mcid]
        assert abs(len(a) - len(r)) <= 5 * np.sqrt(len(a) + len(r)), mcid
        bins = np.linspace(0.0, 3.0, 31)
        p, chi2, dof = chi2_p(np.histogram(np.hypot(a[:, 1], a[:, 2]), bins)[0],
                              np.histogram(np.hypot(r[:, 1], r[:, 2]), bins)[0])
        assert p > 1e-3, (mcid, chi2, dof)


# ----------------------------------------------------------------------
# the analysis tools
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def results_wd(tmp_path_factory):
    """The port's own result files: op 1 with outflow and regulation (what
    the sampler's acceptance weight compares with), op 2 into the test
    histograms and into OSCAR + CSV event files (20 events)."""
    wd = build_sampler_workdir(tmp_path_factory.mktemp("torch_tools_results"))
    set_params(wd, {"outflow": 1, "regulate_deltaf": 1, "df_mode": 1,
                    "compute_dtype": "f32c", "cell_block": 64,
                    "min_num_hadrons": 1e6,
                    "max_num_samples": 1e5, "test_sampler": 1})
    for fields in ({"operation": 1}, {"operation": 2},
                   {"operation": 2, "test_sampler": 0, "write_csv": 1,
                    "max_num_samples": 20}):
        set_params(wd, fields)
        _quiet(IS3D(wd, device="cpu").run_particlization)
    return wd


def _equal_reports(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys()
        for name in a[k]:
            np.testing.assert_array_equal(a[k][name], b[k][name])


def test_compare_sampling_smooth_matches_jax(results_wd, tmp_path):
    ours = _quiet(analysis.compare_sampling_smooth, results_wd, PIKP,
                  out_png=tmp_path / "port.png")
    ref = _quiet(j_analysis.compare_sampling_smooth, results_wd, PIKP,
                 out_png=tmp_path / "jax.png")
    _equal_reports(ours, ref)
    assert abs(ours[211]["yield_ratio"] - 1.0) < 0.05
    assert (tmp_path / "port.png").exists()


def test_compute_observables_matches_jax(results_wd, tmp_path):
    ours = _quiet(analysis.compute_observables, results_wd,
                  out=tmp_path / "port.npz")
    ref = _quiet(j_analysis.compute_observables, results_wd,
                 out=tmp_path / "jax.npz")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    # (the synthetic smash-box list carries no charges: dNch is 0)
    assert ours["dNch_deta"].shape == (20,)
    assert ours["dN_dy_pion"].sum() > 0


def test_compute_observables_counts_the_identified_hadrons(results_wd):
    """Per event, dN_dy_<name> counts |mcid| at |y| < 0.5, as the event's
    rows give them (events are numbered from 1)."""
    obs = _quiet(analysis.compute_observables, results_wd)
    for e in range(20):
        parts = analysis.read_particle_list(
            results_wd / f"results/particle_list_{e + 1}.dat")
        for name, mcid in (("pion", 211), ("kaon", 321), ("proton", 2212)):
            n = int(((np.abs(parts["mcid"]) == mcid)
                     & (np.abs(parts["y_rap"]) < 0.5)).sum())
            assert obs[f"dN_dy_{name}"][e] == n


def test_histogram_event_matches_jax(results_wd, tmp_path):
    path = results_wd / "results/particle_list_1.dat"
    ours = _quiet(analysis.histogram_event, path, tmp_path / "port.png")
    ref = _quiet(j_analysis.histogram_event, path, tmp_path / "jax.png")
    _equal_reports(ours, ref)
    assert sum(ours[m]["n"] for m in PIKP) > 0


def test_analysis_without_matplotlib(results_wd, tmp_path, monkeypatch):
    """The card's machine has no matplotlib: every number still comes out,
    and no figure is written."""
    with_plots = _quiet(analysis.compare_sampling_smooth, results_wd, PIKP,
                        out_png=tmp_path / "with.png")
    obs = _quiet(analysis.compute_observables, results_wd,
                 out=tmp_path / "with.npz")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert analysis._maybe_pyplot() is None
    without = _quiet(analysis.compare_sampling_smooth, results_wd, PIKP,
                     out_png=tmp_path / "without.png")
    _equal_reports(without, with_plots)
    assert not (tmp_path / "without.png").exists()
    bare = _quiet(analysis.compute_observables, results_wd,
                  out=tmp_path / "without.npz")
    for k in obs:
        np.testing.assert_array_equal(bare[k], obs[k])
    assert _quiet(analysis.plot_spectra, results_wd, PIKP) is None


@pytest.mark.parametrize("script,args", [
    ("histogram_event.py", ["results/particle_list_1.dat"]),
    ("histogram_event.py", ["results/particle_list_osc_1.dat"]),
    ("compute_observables.py", ["results/particle_list_osc_*.dat"]),
    ("compare_sampling_smooth.py", [".", "--mcids", *map(str, PIKP)]),
])
def test_shared_scripts_read_the_port_files(results_wd, script, args):
    r = _script([SCRIPTS / script, *args], cwd=results_wd)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip()


# ----------------------------------------------------------------------
# choose_particles
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pdg_dir(tmp_path_factory):
    """A synthetic PDG/ with the four preset files."""
    d = tmp_path_factory.mktemp("torch_tools_pdg") / "PDG"
    d.mkdir()
    for i, name in enumerate(sorted(choose_particles.PRESETS.values())):
        d.joinpath(name).write_text(
            "".join(f"{m}\n" for m in (211, 321, 2212, 3122)[:i + 1]))
    return d


@pytest.mark.parametrize("preset", sorted(choose_particles.PRESETS)
                         + ["211,-211,111,2212"])
def test_choose_particles_writes_the_jax_bytes(pdg_dir, preset):
    assert choose_particles.PRESETS == j_choose.PRESETS
    target = pdg_dir / "chosen_particles.dat"
    _quiet(j_choose.main, [preset, "--pdg-dir", str(pdg_dir)])
    ref = target.read_bytes()
    target.unlink()
    _quiet(choose_particles.main, [preset, "--pdg-dir", str(pdg_dir)])
    assert target.read_bytes() == ref and ref


# ----------------------------------------------------------------------
# imports and devices
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_MODULES)
def test_tool_imports_without_jax(name):
    r = _script(["-c", f"import sys, is3d2_tpu_torch.tools.{name}; "
                       "assert 'jax' not in sys.modules, 'jax'"], cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("main", [sweep.main, oversample.main,
                                  modified_distribution.main],
                         ids=["sweep", "oversample", "modified_distribution"])
def test_tools_run_on_the_gpu_unless_asked(tmp_path, monkeypatch, main):
    """Without --device the entry points take the GPU: where torch sees
    none they raise, rather than running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = tiny_workdir(tmp_path / "wd", 1, "f32c", sampler_seed=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _quiet(main, [str(wd), *(["--out", str(tmp_path / "out")]
                                 if main is not oversample.main else [])])
