"""3+1d surfaces (dimension 3) with df 3 (PTM), 4 (PTB) and 5 (famod) in
the port against the JAX package, on the CPU.

Inputs are built in code (tests/torch_parity.py): 512 cells of
make_surface(dimension=3) (each cell's eta in [-2, 2]), 8 species,
16 pT x 8 phi and a 9-point trapezoid y table over |y| <= 5; the feqmod
cases on shear 0.2, bulk 0.1 (cells break down), the famod cases on an
EOS-consistent surface (shear 0.1, bulk 0.05).
  * prepare_feqmod in 3+1d (no eta rescale, renorm / detA) field by field
    against the JAX prep: <= 1e-12;
  * the torch f64 feqmod and famod engines against the JAX
    _spectra_feqmod_jit / _spectra_famod_jit: <= 1e-10;
  * kernel B3's 3+1d plain version against the JAX f64 route: <= 1e-4
    relative on bins >= 1e-4 of each species' peak (B3's 2+1d bar), and
    against the JAX XLA program it stands in for
    (compute_spectra_feqmod_fast, dimension 3) on that program's own test
    surface (shear 0.03, bulk 0.01) at that program's bar (1e-3 on bins
    >= 1e-7 of the largest bin, tests/test_spectra_feqmod_fast.py:
    115-155); on the harsh surface the JAX program's ten-term quadratic
    form is further off f64 than the plain version (ROADMAP C4);
  * the narrow |y - eta| < detA window (kernel_check.narrow_window_surface)
    is hit, and the f64 engine and the plain version match the JAX f64
    route there;
  * operation 0 for df 3/4 on every dtype through the f64 engine against
    the JAX f64 route: <= 1e-10;
  * operation 2 for df 3/4/5: the yield estimate within 1e-12 of the JAX
    package's, the sampled dN/dy of pi+ at |y| < 1 within 5 sigma + 3 % of
    the port's op-1 spectra (the JAX 3+1d closure bar), equal bits from
    equal seeds;
  * the CLI against the JAX driver (f64 <= 1e-10; f32 B3's bar), and a
    3+1d df-4 run that imports no jax;
  * the dispatch: f32/f32c on any use_pallas run B3's 3+1d mode, f64
    (use_pallas 1 too) the f64 engine;
  * the 3+1d harness of kernel_check on the CPU (the plain version stands
    in for the kernel there).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (BLOCK, CHOSEN, FAMOD_BULK, FAMOD_SHEAR,  # noqa: E402
                          FEQMOD_BULK, FEQMOD_SHEAR, PIKP,
                          build_sampler_workdir, build_workdir, famod_state,
                          feqmod_state, jax_config, max_rel_err,
                          numpy_fields, port_config, run_drivers,
                          sampler_inputs)

from is3d2_tpu.core import sampler as js  # noqa: E402
from is3d2_tpu.core.spectra_famod import _spectra_famod_jit  # noqa: E402
from is3d2_tpu.core.spectra_feqmod import _spectra_feqmod_jit  # noqa: E402
from is3d2_tpu.core.spectra_feqmod_fast import \
    compute_spectra_feqmod_fast  # noqa: E402

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import sampler as ps  # noqa: E402
from is3d2_tpu_torch.core import spacetime  # noqa: E402
from is3d2_tpu_torch.core import spectra as sp  # noqa: E402
from is3d2_tpu_torch.core import spectra_feqmod as sfq  # noqa: E402
from is3d2_tpu_torch.core.feqmod import FeqmodCellData, prepare_feqmod  # noqa: E402
from is3d2_tpu_torch.core.sampler_hist import \
    bin_sampled_particles  # noqa: E402
from is3d2_tpu_torch.core.spectra_famod import spectra_famod  # noqa: E402
from is3d2_tpu_torch.io.deltaf_tables import DeltafTables  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import GaussLaguerre  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.physics.deltaf import DeltafData  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import (make_surface,  # noqa: E402
                                             write_workdir)

torch.set_num_threads(1)

N_Y = 9
S = len(CHOSEN)
REPO = Path(__file__).resolve().parent.parent
F64_TOL = 1e-10
KERNEL_TOL = kc.FEQMOD_TOL_F64        # B3 vs the f64 route, per species
# the JAX 3+1d fast path's own bar (tests/test_spectra_feqmod_fast.py:
# 115-155): relative on bins >= FAST_FLOOR of the largest bin
FAST_TOL = 1e-3
FAST_FLOOR = 1e-7
MILD = {"shear_scale": 0.03, "bulk_scale": 0.01}

# name -> (df_mode, include_baryon, extra cfg) of the feqmod cases
CASES = {
    "df3": (3, False, {}),
    "df4": (4, False, {}),
    "df3-outflow-regulate": (3, False, {"outflow": 1, "regulate_deltaf": 1}),
    "df4-regulate": (4, False, {"regulate_deltaf": 1}),
    "df3-baryon-diffusion": (3, True, {}),
}


@pytest.fixture(scope="module")
def wd3(tmp_path_factory):
    """The parity workdir in 3+1d, with baryon tables (the df-3 diffusion
    case); the states below draw their own surfaces."""
    return build_workdir(tmp_path_factory.mktemp("feqmod_3d"),
                         include_baryon=True, dimension=3, n_y=N_Y)


@pytest.fixture(scope="module")
def wd3_visc(tmp_path_factory):
    """A 3+1d workdir whose own surface breaks down in places (the CLI
    and operation-0 cases)."""
    return build_workdir(tmp_path_factory.mktemp("feqmod_3d_cli"),
                         dimension=3, n_y=N_Y, shear_scale=FEQMOD_SHEAR,
                         bulk_scale=FEQMOD_BULK,
                         params={"cell_block": BLOCK})


@pytest.fixture(scope="module")
def wd3_eos(tmp_path_factory):
    """A 3+1d workdir with an EOS-consistent surface (df 5)."""
    return build_workdir(tmp_path_factory.mktemp("famod_3d_cli"),
                         dimension=3, n_y=N_Y, eos_consistent=True,
                         shear_scale=FAMOD_SHEAR, bulk_scale=FAMOD_BULK,
                         params={"cell_block": BLOCK})


@pytest.fixture(scope="module")
def states(wd3):
    """Each case's JAX and port state, and the JAX f64 spectra."""
    out = {}
    for name, (df_mode, baryon, kw) in CASES.items():
        st = feqmod_state(wd3, df_mode, baryon, dimension=3, **kw)
        out[name] = (st, _jax_feqmod(st))
    return out


@pytest.fixture(scope="module")
def famod(wd3):
    st = famod_state(wd3, dimension=3)
    ref = np.asarray(_spectra_famod_jit(st.j_cells, st.j_fm, st.j_species,
                                        st.j_grid, st.cfg,
                                        st.j_cells.n_padded // BLOCK))
    return st, ref


def _jax_feqmod(st):
    return np.asarray(_spectra_feqmod_jit(st.j_cells, st.j_fq, st.j_species,
                                          st.j_grid, st.cfg,
                                          st.j_cells.n_padded // BLOCK))


def _rel(ours, ref) -> float:
    """Max |ours - ref| / max |ref| of one field, non-finite entries
    equal."""
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(ours[~fin], ref[~fin])
    if not fin.any():
        return 0.0
    return float(np.abs(ours[fin] - ref[fin]).max()
                 / max(np.abs(ref[fin]).max(), 1e-300))


def _fast_err(out, ref) -> float:
    """The JAX fast-path test's measure: relative on bins >= FAST_FLOOR of
    the largest bin."""
    out, ref = np.asarray(out), np.asarray(ref)
    sig = np.abs(ref) > FAST_FLOOR * np.abs(ref).max()
    return float((np.abs(out - ref)[sig] / np.abs(ref)[sig]).max())


def _port_df_data(wd, st, df_mode, baryon):
    tables = DeltafTables.load(3, baryon, wd / "deltaf_coefficients/vh")
    df_data = DeltafData(tables, df_mode, baryon)
    if not baryon:
        df_data.compute_jonah_coefficients(
            read_pdg(3, wd / "PDG"),
            GaussLaguerre.from_file(wd / "tables/gauss/gla_roots_weights.txt"),
            st.plasma)
    return df_data


def _kernel_route(st, fm=None):
    """B3's 3+1d route (its plain version on the CPU) on a state."""
    cfg = port_config(st.cfg)
    if fm is not None:
        return fk.compute_spectra_famod_kernel(st.cells, fm, st.species,
                                               st.grid, cfg).numpy()
    return fk.compute_spectra_feqmod_kernel(st.cells, st.fq, st.species,
                                            st.grid, cfg).numpy()


# ----------------------------------------------------------------------
# the prep and the f64 engines
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["df3", "df4", "df3-baryon-diffusion"])
def test_prepare_feqmod_3d_matches_jax(wd3, states, case):
    """No eta rescale and the renormalisation over detA in 3+1d, every
    field within 1e-12 of the JAX prep's."""
    st, _ = states[case]
    df_mode, baryon, _ = CASES[case]
    lag = GaussLaguerre.from_file(wd3 / "tables/gauss/gla_roots_weights.txt")
    fq = prepare_feqmod(st.cells, st.species,
                        _port_df_data(wd3, st, df_mode, baryon),
                        port_config(st.cfg), lag)
    ref = numpy_fields(st.j_fq)
    live = st.cells.mask.numpy() > 0
    assert 0 < int((fq.breaks_down.numpy() & live).sum()) < live.sum()
    np.testing.assert_array_equal(fq.breaks_down.numpy(), ref["breaks_down"])
    assert (fq.eta_scale.numpy() == 1.0).all()
    for f in dataclasses.fields(FeqmodCellData):
        if f.name != "breaks_down":
            assert _rel(getattr(fq, f.name), ref[f.name]) <= 1e-12, f.name


@pytest.mark.parametrize("case", list(CASES))
def test_f64_engine_3d_matches_jax(states, case):
    st, ref = states[case]
    out = sfq.spectra_feqmod(st.cells, st.fq, st.species, st.grid,
                             port_config(st.cfg)).numpy()
    assert out.shape == ref.shape == (S, 16, 8, N_Y)
    assert max_rel_err(out, ref) <= F64_TOL


def test_famod_f64_engine_3d_matches_jax(famod):
    st, ref = famod
    out = spectra_famod(st.cells, st.fm, st.species, st.grid,
                        port_config(st.cfg)).numpy()
    assert out.shape == ref.shape == (S, 16, 8, N_Y)
    assert int(st.fm.breaks_down.sum()) > 0
    assert max_rel_err(out, ref) <= F64_TOL


# ----------------------------------------------------------------------
# kernel B3's 3+1d plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES) + ["famod"])
def test_plain_version_3d_vs_jax_f64(states, famod, case):
    if case == "famod":
        st, ref = famod
        out = _kernel_route(st, st.fm)
    else:
        st, ref = states[case]
        out = _kernel_route(st)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert max_rel_err(out, ref) <= KERNEL_TOL


@pytest.mark.parametrize("df_mode", [3, 4, 5])
def test_plain_version_3d_vs_the_jax_fast_path(wd3, df_mode):
    """On the JAX fast path's own test surface the plain version and the
    XLA program it stands in for agree at that program's bar, and both
    meet it against the JAX f64 route."""
    n_blocks = 512 // BLOCK
    if df_mode == 5:
        st = famod_state(wd3, dimension=3, shear_scale=0.02)
        prep, j_prep = st.fm, st.j_fm
        ref = _spectra_famod_jit(st.j_cells, j_prep, st.j_species, st.j_grid,
                                 st.cfg, n_blocks)
    else:
        st = feqmod_state(wd3, df_mode, dimension=3, **MILD)
        prep, j_prep = None, st.j_fq
        ref = _jax_feqmod(st)
    fast = np.asarray(compute_spectra_feqmod_fast(
        st.j_cells, j_prep, st.j_species, st.j_grid, st.cfg,
        n_cell_blocks=n_blocks))
    ours = _kernel_route(st, prep)
    assert ours.shape == fast.shape
    assert _fast_err(fast, ref) < FAST_TOL
    assert _fast_err(ours, fast) < FAST_TOL
    assert _fast_err(ours, ref) < FAST_TOL
    assert max_rel_err(ours, ref) <= KERNEL_TOL


@pytest.mark.parametrize("case", ["df3", "df4"])
def test_plain_version_keeps_what_the_quadratic_form_loses(states, case):
    """ROADMAP C4 in 3+1d: on the harsh surface the JAX program's f32
    ten-term E_mod^2 is further off the f64 route than the plain
    version's f64 |U p|^2."""
    st, ref = states[case]
    fast = np.asarray(compute_spectra_feqmod_fast(
        st.j_cells, st.j_fq, st.j_species, st.j_grid, st.cfg,
        n_cell_blocks=512 // BLOCK))
    ours = _kernel_route(st)
    assert max_rel_err(ours, ref) < max_rel_err(fast, ref)


def test_narrow_window_is_hit_and_matched(wd3):
    """Cells with detA < 0.01 moved within detA of a y node take the
    linearised branch there: the window holds (cell, y) pairs, the f64
    engine follows the JAX f64 route through them, and the plain version
    the f64 engine, with the window deciding as in both."""
    cfg = port_config(jax_config(4, dimension=3))
    surf = kc.narrow_window_surface(wd3, cfg, 512, 3, "cpu")
    st = feqmod_state(wd3, 4, dimension=3, surf=surf)
    ops = fk.feqmod_operands_3d(st.cells, st.fq, st.species, st.grid, cfg)
    assert kc.narrow_pairs(ops) > 0
    ref = _jax_feqmod(st)
    out = sfq.spectra_feqmod(st.cells, st.fq, st.species, st.grid,
                             cfg).numpy()
    assert max_rel_err(out, ref) <= F64_TOL
    assert max_rel_err(_kernel_route(st), ref) <= KERNEL_TOL
    # without the window those pairs take the modified branch: another result
    wide = dataclasses.replace(st.fq, detA=torch.ones_like(st.fq.detA))
    other = sfq.spectra_feqmod(st.cells, wide, st.species, st.grid,
                               cfg).numpy()
    assert max_rel_err(other, out) > 1e-12


def test_window_predicate_is_the_f64_engines(states):
    """The plain version's window is |y - eta| < detA in f64, the f64
    engine's predicate, pair for pair (here on a made-up detA that puts
    many pairs at the edge)."""
    st, _ = states["df4"]
    fq = dataclasses.replace(st.fq, detA=torch.full_like(st.fq.detA, 0.009))
    cells = st.cells
    ops = fk.pack_feqmod_3d(cells, fq, st.species, st.grid)
    live = cells.mask > 0
    delta = st.grid.y[None, :] - cells.eta[live][:, None]
    want = sfq.narrow_window(fq.detA[live], delta)
    np.testing.assert_array_equal(ops.window().numpy(), want.numpy())


# ----------------------------------------------------------------------
# operation 0
# ----------------------------------------------------------------------

@pytest.mark.parametrize("df_mode,dtype", [(3, "f64"), (4, "f32"),
                                           (4, "f32c")])
def test_op0_3d_matches_jax_f64(wd3_visc, monkeypatch, df_mode, dtype):
    """Operation 0 in 3+1d runs the f64 engine with the dan-weighted
    feqmod integrand on every dtype, as the JAX package does."""
    def no_kernel(*a, **k):
        raise AssertionError("a kernel ran for 3+1d operation 0")
    monkeypatch.setattr(spacetime, "kernel_bins", no_kernel)
    ref, ours = run_drivers(wd3_visc, operation=0, df_mode=df_mode,
                            compute_dtype=dtype)
    assert ours.report.breakdown_cells > 0
    for a, b in zip(ours.dN_dX.normalized(ours.cfg),
                    ref.dN_dX.normalized(ref.cfg)):
        assert np.isfinite(a).all() and a.sum() > 0
        np.testing.assert_array_equal(a == 0, b == 0)
        assert max_rel_err(a, b) <= F64_TOL


def test_op0_df5_raises_as_the_reference():
    with pytest.raises(ValueError, match="famod"):
        Config(operation=0, df_mode=5, dimension=3).validate_slice()


# ----------------------------------------------------------------------
# operation 2
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wd3_sampler(tmp_path_factory):
    """The 3+1d closure surface (tests/test_torch_3d.py's: 60 cells of
    make_surface(seed=11, dimension=3)), made EOS-consistent so that df 5
    reconstructs; pi+ K+ p, 32 pT x 48 phi, the 21-point y table."""
    return build_sampler_workdir(tmp_path_factory.mktemp("feqmod_3d_op2"),
                                 seed=11, dimension=3, eos_consistent=True)


def _sampler_cfg(df_mode, **kw):
    from is3d2_tpu.config import Config as JConfig
    return JConfig(operation=2, df_mode=df_mode, hrg_eos=3, dimension=3,
                   include_shear_deltaf=1, include_bulk_deltaf=1,
                   cell_block=64, min_num_hadrons=1.0e5, **kw)


@pytest.mark.parametrize("df_mode", [3, 4, 5])
def test_op2_3d_yield_matches_jax(wd3_sampler, df_mode):
    cfg = _sampler_cfg(df_mode)
    ji = sampler_inputs(wd3_sampler, df_mode, True, dimension=3)
    pi = sampler_inputs(wd3_sampler, df_mode, False, dimension=3)
    ref = js.compute_total_yield(ji.surf, ji.species, ji.chosen, ji.df_data,
                                 cfg, ji.laguerre)
    ours = ps.compute_total_yield(pi.surf, pi.species, pi.chosen, pi.df_data,
                                  port_config(cfg), pi.laguerre, "cpu")
    assert ref > 0 and abs(ours - ref) <= 1e-12 * ref
    assert ps.number_of_events(ours, port_config(cfg)) == \
        js.number_of_events(ref, cfg)


@pytest.mark.parametrize("df_mode", [3, 4, 5])
def test_op2_3d_closure_and_seeds(wd3_sampler, df_mode):
    """The sampled pi+ dN/dy at |y| < 1 follows the port's own 3+1d op-1
    spectra (the f64 engine) within 5 sigma + 3 % in every bin, the JAX
    3+1d closure bar; the same seed gives the same particles."""
    inp = sampler_inputs(wd3_sampler, df_mode, False, dimension=3)
    cfg = Config(operation=2, df_mode=df_mode, hrg_eos=3, dimension=3,
                 include_shear_deltaf=1, include_bulk_deltaf=1, fast=1,
                 sampler_seed=3, y_bins=40, y_cut=5.0, cell_block=64)
    smooth = sp.compute_spectra(inp.surf, inp.species, inp.chosen, inp.grids,
                                inp.df_data,
                                dataclasses.replace(cfg, operation=1,
                                                    compute_dtype="f64"),
                                "cpu", laguerre=inp.laguerre)
    g = inp.grids
    dN_dy_smooth = np.einsum("p,q,spqy->sy", g.pT_weight, g.phi_weight,
                             smooth)
    n_events = 12000

    def run():
        return ps.sample_particles(inp.surf, inp.species, inp.chosen,
                                   inp.df_data, cfg, inp.laguerre, n_events,
                                   "cpu", seed=5)

    out = run()
    hist = bin_sampled_particles(out, len(PIKP), cfg, n_events)
    y_w = 2.0 * cfg.y_cut / cfg.y_bins
    y_mid = -cfg.y_cut + y_w * (np.arange(cfg.y_bins) + 0.5)
    sel = np.abs(y_mid) < 1.0
    counts = hist.dN_dy[0, sel]
    obs = counts / n_events
    ref = np.interp(y_mid[sel], g.y, dN_dy_smooth[0]) * y_w
    sigma = np.sqrt(np.maximum(counts, 1.0)) / n_events
    assert counts.sum() > 800
    assert (np.abs(obs - ref) < 5.0 * sigma + 0.03 * ref).all(), (obs, ref)
    again = run()
    for k in ("px", "py", "eta", "rapidity"):
        np.testing.assert_array_equal(again[k].numpy(), out[k].numpy())


# ----------------------------------------------------------------------
# the CLI, the dispatch and the harness
# ----------------------------------------------------------------------

@pytest.mark.parametrize("df_mode,dtype", [(3, "f64"), (3, "f32"),
                                           (4, "f64"), (4, "f32"),
                                           (5, "f64"), (5, "f32")])
def test_cli_3d_matches_the_jax_driver(wd3_visc, wd3_eos, df_mode, dtype):
    """The port's driver on a 3+1d workdir against the JAX driver's f64
    route: the f64 engines within 1e-10, B3's 3+1d mode (its plain
    version here) within its bar."""
    wd = wd3_eos if df_mode == 5 else wd3_visc
    ref, ours = run_drivers(wd, df_mode=df_mode, compute_dtype=dtype)
    out, want = np.asarray(ours.spectra), np.asarray(ref.spectra)
    assert out.shape == want.shape == (S, 16, 8, N_Y)
    assert np.isfinite(out).all() and ours.report.breakdown_cells > 0
    assert max_rel_err(out, want) <= (F64_TOL if dtype == "f64"
                                      else KERNEL_TOL)


def test_port_runs_3d_df4_without_jax(tmp_path):
    """A 3+1d df-4 CLI run in a fresh process through B3's 3+1d plain
    version imports no jax and no JAX package, and orders dN/dy."""
    wd = build_workdir(tmp_path / "df4_3d", params={"compute_dtype": "f32",
                                                    "df_mode": 4},
                       dimension=3, n_y=5, shear_scale=FEQMOD_SHEAR,
                       bulk_scale=FEQMOD_BULK)
    code = (
        "import sys\n"
        "from is3d2_tpu_torch import cli\n"
        "from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk\n"
        "calls = []\n"
        "plain = fk.cooper_frye_feqmod_3d_plain\n"
        "fk.cooper_frye_feqmod_3d_plain = "
        "lambda *a, **k: calls.append(1) or plain(*a, **k)\n"
        f"assert cli.main([{str(wd)!r}, '--device', 'cpu']) == 0\n"
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
    assert "feqmod breaks down for" in proc.stdout
    res = wd / "results/continuous"
    dndy = {m: np.loadtxt(res / f"dN_dy_{m}.dat")[:, 1] for m in (211, 321,
                                                                 2212)}
    mid = 5 // 2
    assert dndy[211][mid] > dndy[321][mid] > dndy[2212][mid] > 0


@pytest.mark.parametrize("dtype,use_pallas,route", [
    ("f64", -1, "engine"), ("f64", 1, "engine"), ("f64", 0, "engine"),
    ("f32", -1, "kernel"), ("f32", 0, "kernel"), ("f32", 1, "kernel"),
    ("f32c", -1, "kernel"), ("f32c", 0, "kernel"), ("f32c", 1, "kernel")])
def test_3d_dispatch(wd3_visc, monkeypatch, dtype, use_pallas, route):
    """3+1d df 4: f32/f32c run B3's 3+1d mode whatever use_pallas says
    (the JAX package's XLA program there); f64 the f64 engine, use_pallas
    1 too (the JAX Pallas kernel is 2+1d only)."""
    ran = []
    kernel_3d, engine = fk.cooper_frye_feqmod_3d, sfq.spectra_feqmod

    def spy(name, fn):
        def call(*a, **k):
            ran.append(name)
            return fn(*a, **k)
        return call

    def no_2d(*a, **k):
        raise AssertionError("B3's 2+1d mode ran on a 3+1d surface")

    monkeypatch.setattr(fk, "cooper_frye_feqmod_3d", spy("kernel", kernel_3d))
    monkeypatch.setattr(fk, "cooper_frye_feqmod", no_2d)
    monkeypatch.setattr(sfq, "spectra_feqmod", spy("engine", engine))
    cfg = dataclasses.replace(
        Config.from_file(wd3_visc / "iS3D_parameters.dat"), df_mode=4,
        compute_dtype=dtype, use_pallas=use_pallas, cell_block=64)
    assert sp.uses_feqmod_kernel(cfg) == (route == "kernel")
    surf = make_surface(64, seed=5, dimension=3, shear_scale=FEQMOD_SHEAR,
                        bulk_scale=FEQMOD_BULK)
    st = kc.feqmod_engine_state(wd3_visc, cfg, surf, "cpu")
    assert kc.breakdown_cells(st) > 0
    run = kc.IS3D(wd3_visc, cfg=cfg, device="cpu")
    run.surface = surf
    run._setup()
    sp.compute_spectra(surf, run.species, run.chosen_idx, run.grids,
                       run.df_data, cfg, "cpu", run.laguerre)
    assert ran == [route]


def test_the_3d_harness_runs_on_the_cpu(wd3):
    """kernel_check's B3 3+1d cases on the CPU, where the wrapper runs the
    plain version: every case meets its bars, the feqmod cases break down,
    the narrow case holds window pairs, and the ragged y counts run."""
    wd = write_workdir(wd3.parent / "harness", n_cells=16,
                       chosen_mcids=PIKP, n_pT=8, n_phi=8, n_T=21,
                       dimension=3)
    for case in ("df3", "df4-regulate"):
        r = kc.check_feqmod_3d_case(wd, case, 512, 7, "cpu")
        assert r.ok and r.launches == 0 and r.breakdown_cells > 0, case
    r = kc.check_feqmod_3d_case(wd, "famod", 512, 3, "cpu", cell_block=512)
    assert r.ok and r.breakdown_cells > 0
    r = kc.check_feqmod_3d_case(wd, "df4", 512, 4, "cpu", narrow=True)
    assert r.ok and r.narrow_pairs > 0
    for n_y in kc.RAGGED_Y:
        r = kc.check_feqmod_3d_ragged_case(wd, 1100, 7, "cpu", n_y=n_y)
        assert r.ok and r.breakdown_cells > 0
        assert r.kernel.shape == (1, 3 * 5 * 7 * n_y)
