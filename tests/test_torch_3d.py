"""3+1d surfaces (dimension 3), df 1/2, in the port against the JAX package.

On a synthetic 3+1d workdir (torch_parity.build_workdir with dimension 3:
512 cells of make_surface(dimension=3), each cell's eta in [-2, 2], 8
species, 16 pT x 8 phi and a 9-point trapezoid y table over |y| <= 5) both
packages run on the CPU:
  * operation 1 in f64 (the torch f64 engine; also with use_pallas = 1,
    which the JAX package sends to its f64 engine in 3+1d): <= 1e-10
    against the JAX f64 route;
  * operation 1 in f32c and f32 (B1's 3+1d mode, its plain version here):
    <= 1e-6 relative on bins >= 1e-4 of each species' peak and <= 2.5e-7
    of the peak on every bin, the JAX package's own 3+1d budget
    (tests/test_spectra_golden_3d.py:56-79); with baryon diffusion held to
    the JAX f64 route at that budget as the JAX test computes it, 1e-6 on
    the bins >= 1e-4 of the largest bin of all species (relative to each
    species' own peak the df-2 case is 1.2e-6 off: where delta-f nears -1,
    1 + df cancels and the plain-f32 V.p and pi:pp carry their last places
    into the term, ROADMAP C11; the JAX f32c path drops part of alphaB,
    ROADMAP C3, and is 7e-5 off there);
  * B1's 3+1d plain version against the JAX XLA programs it stands in for,
    _block_fast_3d_comp (f32c) and _block_fast_3d (plain f32), on the same
    per-cell state, and the light-cone rows against the JAX package's;
  * operation 0, df 1/2, every dtype (the f64 engine in 3+1d, as in the
    JAX package): <= 1e-10;
  * operation 2: the yield estimate and event count equal to the JAX
    package's (<= 1e-12), the closure of the JAX package's
    tests/test_sampler.py::test_sampler_closure_3plus1d against the port's
    own 3+1d op-1 spectra (5 sigma + 3 %), the host lab boost of the OSCAR
    route bit for bit with the JAX package's and within f32 rounding of
    the device boost, and OSCAR files through the CLI;
  * the CLI on a 3+1d workdir writes the JAX driver's files, and the
    writers the same bytes on the same 3+1d spectra;
  * what validate_slice still rejects in 3+1d (mode 5, the mesh).
"""

import contextlib
import dataclasses
import io
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (CHOSEN, PIKP, build_sampler_workdir,  # noqa: E402
                          build_workdir, case_state, max_rel_err,
                          numpy_fields, port_config, run_drivers,
                          sampler_inputs)

import jax.numpy as jnp  # noqa: E402

from is3d2_tpu.core import sampler as js  # noqa: E402
from is3d2_tpu.core import spectra_fast as j_fast  # noqa: E402
from is3d2_tpu.core.spectra import MomentumGridDevice as JGrid  # noqa: E402
from is3d2_tpu.core.spectra import _spectra_df12_jit  # noqa: E402
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402
from is3d2_tpu.io import output as j_output  # noqa: E402
from is3d2_tpu.io.surface import read_surface as j_read_surface  # noqa: E402
from is3d2_tpu.io.tables import MomentumGrids as JGrids  # noqa: E402

from is3d2_tpu_torch import cli, interop  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import sampler as ps  # noqa: E402
from is3d2_tpu_torch.core import spacetime  # noqa: E402
from is3d2_tpu_torch.core import spectra_fast  # noqa: E402
from is3d2_tpu_torch.core.sampler_hist import \
    bin_sampled_particles  # noqa: E402
from is3d2_tpu_torch.core.spectra import (MomentumGridDevice,  # noqa: E402
                                          compute_spectra)
from is3d2_tpu_torch.io import output  # noqa: E402
from is3d2_tpu_torch.io.surface import read_surface  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_f32 as b2  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import \
    compute_spectra_comp  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402

torch.set_num_threads(1)

N_Y = 9
F32C_TOL = 1e-6       # relative, bins >= 1e-4 of each species' peak
PEAK_TOL = kc.ABS_TOL_3D

# name -> config fields of the op-1 kernel-route cases
KERNEL_CASES = {
    "df1": {"df_mode": 1},
    "df2": {"df_mode": 2},
    "df1-regulate-outflow": {"df_mode": 1, "regulate_deltaf": 1,
                             "outflow": 1},
    "df2-regulate-outflow": {"df_mode": 2, "regulate_deltaf": 1,
                             "outflow": 1},
}


@pytest.fixture(scope="module")
def wd3(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_3d"), dimension=3,
                         n_y=N_Y)


@pytest.fixture(scope="module")
def wd3_baryon(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_3d_b"),
                         include_baryon=True, dimension=3, n_y=N_Y)


def _spectra(run) -> np.ndarray:
    return np.asarray(run.spectra)


# ----------------------------------------------------------------------
# operation 1
# ----------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [-1, 1])
@pytest.mark.parametrize("df_mode", [1, 2])
def test_op1_f64_engine_matches_jax(wd3, monkeypatch, df_mode, use_pallas):
    """The f64 route, and use_pallas = 1 with f64, which in 3+1d is the f64
    engine too (kernel B2 is 2+1d only, as the JAX package's _kernel is)."""
    def no_b2(*a, **k):
        raise AssertionError("kernel B2 ran in 3+1d")
    monkeypatch.setattr(b2, "cooper_frye_f32", no_b2)
    ref, ours = run_drivers(wd3, df_mode=df_mode, compute_dtype="f64",
                            use_pallas=use_pallas)
    assert _spectra(ours).shape == (len(CHOSEN), 16, 8, N_Y)
    assert max_rel_err(_spectra(ours), _spectra(ref)) <= 1e-10


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_op1_kernel_route_matches_jax_f64(wd3, case):
    """f32c through B1's 3+1d mode (its plain version on the CPU) within
    the JAX package's 3+1d budget of its f64 route; f32 runs the same
    kernel, as in 2+1d: the same numbers."""
    fields = KERNEL_CASES[case]
    ref, ours = run_drivers(wd3, compute_dtype="f32c", **fields)
    out, want = _spectra(ours), _spectra(ref)
    assert np.isfinite(out).all()
    assert max_rel_err(out, want) <= F32C_TOL
    assert kc.peak_err(out, want) <= PEAK_TOL
    _, ours32 = run_drivers(wd3, compute_dtype="f32", use_pallas=0, **fields)
    np.testing.assert_array_equal(_spectra(ours32), out)


@pytest.mark.parametrize("df_mode", [1, 2])
def test_op1_baryon_diffusion_is_held_to_jax_f64(wd3_baryon, df_mode):
    """Baryons with diffusion: the f64 engine within 1e-10 of the JAX f64
    route, and the f32c route held to that route too (ROADMAP C3: the JAX
    f32c path drops abl b from the delta-f energy; the port keeps it)."""
    ref, ours = run_drivers(wd3_baryon, df_mode=df_mode, compute_dtype="f64")
    assert max_rel_err(_spectra(ours), _spectra(ref)) <= 1e-10
    _, ours_c = run_drivers(wd3_baryon, df_mode=df_mode,
                            compute_dtype="f32c")
    out = _spectra(ours_c)
    assert kc.global_rel_err(out, _spectra(ref)) <= F32C_TOL
    assert kc.peak_err(out, _spectra(ref)) <= PEAK_TOL


def _jax_block_routes(st):
    """The JAX package's 3+1d f32c and plain f32 XLA programs and its f64
    engine on one case's state."""
    n_blocks = st.j_cells.n_padded // 128
    args = (st.j_cells, st.j_coeffs, st.j_species, st.j_grid, st.cfg)
    return (np.asarray(j_fast.compute_spectra_fast(
                *args, n_blocks, compute_dtype="f32c")),
            np.asarray(j_fast.compute_spectra_fast(
                *args, n_blocks, compute_dtype=jnp.float32)),
            np.asarray(_spectra_df12_jit(*args, n_blocks)))


@pytest.mark.parametrize("df_mode", [1, 2])
def test_plain_version_matches_the_jax_xla_programs(wd3, df_mode):
    """B1's 3+1d plain version on the JAX package's own per-cell state:
    within 1e-6 of _block_fast_3d_comp (both compensated), within 1e-5 of
    the plain-f32 _block_fast_3d (whose own error against f64 is ~2.5e-6
    here), and within the 3+1d budget of the JAX f64 engine."""
    st = case_state(wd3, df_mode, dimension=3)
    comp, plain32, f64 = _jax_block_routes(st)
    ours = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid,
                                port_config(st.cfg)).numpy()
    assert ours.shape == comp.shape == (len(CHOSEN), 16, 8, N_Y)
    assert max_rel_err(ours, comp) <= 1e-6
    assert max_rel_err(ours, plain32) <= 1e-5
    assert max_rel_err(plain32, f64) > max_rel_err(ours, f64)
    assert max_rel_err(ours, f64) <= F32C_TOL
    assert kc.peak_err(ours, f64) <= PEAK_TOL


def test_plain_version_with_baryons_is_held_to_jax_f64(wd3_baryon):
    """With baryons the JAX f32c program is no yardstick (ROADMAP C3: it
    is more than 1e-5 off its own f64 engine here), so the plain version
    is held to the JAX f64 engine."""
    st = case_state(wd3_baryon, 1, include_baryon=True, dimension=3)
    comp, _, f64 = _jax_block_routes(st)
    ours = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid,
                                port_config(st.cfg)).numpy()
    assert max_rel_err(comp, f64) > 1e-5
    assert kc.global_rel_err(ours, f64) <= F32C_TOL
    assert kc.peak_err(ours, f64) <= PEAK_TOL


def test_light_cone_rows_match_jax(wd3):
    """momentum_matrix_3d_comp and _cell_Q_3d_comp against the JAX
    package's: the JAX momenta run (species, pT, phi, y), the port's
    (species, pT, y, phi); every split row's hi + lo and every Q column
    within 1e-14 relative, the hi parts 12-bit."""
    st = case_state(wd3, 1, dimension=3)
    ref = j_fast.momentum_matrix_3d_comp(st.j_species, st.j_grid)
    ours = spectra_fast.momentum_matrix_3d_comp(st.species, st.grid)
    shape = (len(CHOSEN), 16, 8, N_Y)

    def port_order(a):
        return np.asarray(a, np.float64).reshape(shape).transpose(0, 1, 3, 2)

    for name in ("mp", "px", "py", "mm"):
        hi, lo = ours[name + "1"], ours[name + "2"]
        assert not (hi.view(torch.int32) & 0xFFF).any(), name
        want = port_order(ref[name + "1"]) + port_order(ref[name + "2"])
        got = (hi.double() + lo.double()).reshape(want.shape).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    for name in ("mass2", "b", "sgn"):
        np.testing.assert_array_equal(
            ours[name].float().reshape(shape[:2] + (N_Y, 8)).numpy(),
            port_order(ref[name]).astype(np.float32))
    q_ref = j_fast._cell_Q_3d_comp(st.j_cells, st.j_coeffs)
    q = spectra_fast._cell_Q_3d_comp(st.cells, st.coeffs)
    for name in ("Q_E", "Q_d", "Q_pi", "Q_V"):
        want = np.asarray(q_ref[name], np.float64)
        np.testing.assert_allclose(q[name].float().numpy(), want,
                                   rtol=1e-7, atol=0)
    for name in ("qp", "qx", "qy", "qm", "ab"):
        hi, lo = ((name + "1", name + "2") if name != "ab"
                  else ("abf", "abl"))
        got = q[hi].double() + q[lo].double()
        want = (np.asarray(q_ref[hi], np.float64)
                + np.asarray(q_ref[lo], np.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


def test_3d_inputs_carry_across(wd3):
    """The 3+1d surface and the tables (y included) read by the JAX package
    and carried to the port (interop) are what the port reads itself, and
    the 3+1d grid takes y from the table with one eta node of weight 1."""
    surf = read_surface(wd3 / "input/surface.dat", 1, 3, False)
    carried = interop.surface_from_numpy(numpy_fields(j_read_surface(
        wd3 / "input/surface.dat", 1, 3, False)))
    for f in ("tau", "eta", "dan", "un", "pixn", "piyn"):
        np.testing.assert_array_equal(getattr(carried, f), getattr(surf, f))
    assert np.abs(surf.eta).max() > 1.0 and np.abs(surf.un).max() > 0
    grids = interop.grids_from_numpy(numpy_fields(
        JGrids.from_dir(wd3 / "tables")))
    ours = MomentumGridDevice.from_grids(grids, 3, "cpu")
    ref = JGrid.from_grids(grids, 3)
    for f in dataclasses.fields(MomentumGridDevice):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))
    assert ours.y.shape == (N_Y,) and ours.eta.tolist() == [0.0]
    assert ours.eta_weight.tolist() == [1.0]
    assert float(ours.y[0]) == -5.0 and float(ours.y[-1]) == 5.0


# ----------------------------------------------------------------------
# operation 0
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f64", "f32", "f32c"])
@pytest.mark.parametrize("df_mode", [1, 2])
def test_op0_matches_jax_f64(wd3, monkeypatch, df_mode, dtype):
    """Operation 0 in 3+1d runs the f64 engine on every dtype, as the JAX
    package does: no kernel, <= 1e-10 on the normalized bins, the same
    empty bins."""
    def no_kernel(*a, **k):
        raise AssertionError("a kernel ran for 3+1d operation 0")
    monkeypatch.setattr(spacetime, "kernel_bins", no_kernel)
    ref, ours = run_drivers(wd3, operation=0, df_mode=df_mode,
                            compute_dtype=dtype)
    for a, b in zip(ours.dN_dX.normalized(ours.cfg),
                    ref.dN_dX.normalized(ref.cfg)):
        assert np.isfinite(a).all() and a.sum() > 0
        np.testing.assert_array_equal(a == 0, b == 0)
        assert max_rel_err(a, b) <= 1e-10


# ----------------------------------------------------------------------
# operation 2
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wd3_sampler(tmp_path_factory):
    """The JAX package's 3+1d closure surface: 60 cells of
    make_surface(seed=11, dimension=3, shear 0.03, bulk 0.01), pi+ K+ p,
    32 pT x 48 phi, the 21-point y table."""
    return build_sampler_workdir(tmp_path_factory.mktemp("torch_3d_op2"),
                                 seed=11, dimension=3)


@pytest.mark.parametrize("df_mode", [1, 2])
def test_total_yield_and_event_count_match_jax(wd3_sampler, df_mode):
    """The 3+1d yield: no factor 2 y_cut (the cells' dsigma carries the
    eta extent)."""
    from is3d2_tpu.config import Config as JConfig
    cfg = JConfig(operation=2, df_mode=df_mode, hrg_eos=3, dimension=3,
                  include_shear_deltaf=1, include_bulk_deltaf=1,
                  cell_block=64, min_num_hadrons=1.0e5)
    ji = sampler_inputs(wd3_sampler, df_mode, True, dimension=3)
    pi = sampler_inputs(wd3_sampler, df_mode, False, dimension=3)
    ref = js.compute_total_yield(ji.surf, ji.species, ji.chosen, ji.df_data,
                                 cfg, ji.laguerre)
    ours = ps.compute_total_yield(pi.surf, pi.species, pi.chosen, pi.df_data,
                                  port_config(cfg), pi.laguerre, "cpu")
    assert ref > 0 and abs(ours - ref) <= 1e-12 * ref
    two_d = ps.compute_total_yield(
        pi.surf, pi.species, pi.chosen, pi.df_data,
        port_config(dataclasses.replace(cfg, dimension=2)), pi.laguerre,
        "cpu")
    assert two_d == pytest.approx(10.0 * ours, rel=1e-12)   # 2 y_cut
    assert ps.number_of_events(ours, port_config(cfg)) == \
        js.number_of_events(ref, cfg)


def test_sampler_closure_3plus1d(wd3_sampler):
    """The JAX package's 3+1d closure on the port: the rapidity comes from
    the cell's eta and the LRF kinematics (no flat y draw), so the sampled
    pion dN/dy at |y| < 1 must follow the 3+1d op-1 spectra's dN/dy within
    5 sigma + 3 % in every bin."""
    inp = sampler_inputs(wd3_sampler, 1, False, dimension=3)
    cfg = Config(operation=2, df_mode=1, hrg_eos=3, dimension=3,
                 include_shear_deltaf=1, include_bulk_deltaf=1,
                 regulate_deltaf=1, outflow=1, fast=1, sampler_seed=3,
                 y_bins=40, y_cut=5.0, cell_block=64)
    smooth = compute_spectra(inp.surf, inp.species, inp.chosen, inp.grids,
                             inp.df_data,
                             dataclasses.replace(cfg, operation=1,
                                                 compute_dtype="f64"),
                             "cpu", laguerre=inp.laguerre)
    g = inp.grids
    dN_dy_smooth = np.einsum("p,q,spqy->sy", g.pT_weight, g.phi_weight,
                             smooth)
    n_events = 30000
    out = ps.sample_particles(inp.surf, inp.species, inp.chosen, inp.df_data,
                              cfg, inp.laguerre, n_events, "cpu", seed=3)
    hist = bin_sampled_particles(out, len(PIKP), cfg, n_events)
    y_w = 2.0 * cfg.y_cut / cfg.y_bins
    y_mid = -cfg.y_cut + y_w * (np.arange(cfg.y_bins) + 0.5)
    sel = np.abs(y_mid) < 1.0
    counts = hist.dN_dy[0, sel]
    obs = counts / n_events
    ref = np.interp(y_mid[sel], g.y, dN_dy_smooth[0]) * y_w
    sigma = np.sqrt(np.maximum(counts, 1.0)) / n_events
    assert counts.sum() > 2000
    assert (np.abs(obs - ref) < 5.0 * sigma + 0.03 * ref).all(), (obs, ref)
    # the 3+1d hadron keeps its cell's eta, and its rapidity is that eta
    # plus the thermal spread, which reaches past the cells' |eta| <= 2
    rap = out["rapidity"].numpy()
    assert np.abs(out["eta"].numpy()).max() <= 2.0
    assert np.abs(rap).max() > 2.0


def test_3d_chunk_collector_matches_jax_bits():
    """The host lab boost of a lean (OSCAR) chunk in 3+1d: pz from the
    cell's eta and u^eta, eta the cell's own, no rapidity draw; the JAX
    package's collector on the same chunk gives the same bits."""
    rng = np.random.default_rng(2)
    C, n, ev0, n_ev = 64, 3000, 40, 20
    f32 = np.float32
    ch = {"cell_tau": rng.uniform(1.0, 10.0, C),
          "cell_x": rng.uniform(-9, 9, C), "cell_y": rng.uniform(-9, 9, C),
          "cell_eta": rng.uniform(-2.0, 2.0, C),
          "cell_ux": rng.uniform(-1, 1, C), "cell_uy": rng.uniform(-1, 1, C),
          "cell_un": rng.uniform(-0.05, 0.05, C),
          "px": rng.normal(0, 0.4, n), "py": rng.normal(0, 0.4, n),
          "pz": rng.normal(0, 0.4, n)}
    ch = {k: v.astype(f32) for k, v in ch.items()}
    ch.update(mcid=np.array(PIKP, dtype=np.int64),
              mass_tab=np.array([0.13957, 0.493677, 0.938272], dtype=f32),
              lrf=True, dimension=3, y_max=5.0, ev0=ev0, n_ev=n_ev,
              rap_seed=ps.rap_seed(7, ev0),
              event=(rng.integers(0, n_ev, n) + ev0).astype(np.int32),
              sp_idx=rng.integers(0, 3, n).astype(np.int32),
              cell_idx=rng.integers(0, C, n).astype(np.int32))
    ours = ps.ChunkCollector()
    ours({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in ch.items()})
    ref = js.ChunkCollector()
    ref(dict(ch, keep=np.ones(n, dtype=bool),
             sp_idx=ch["sp_idx"].astype(np.uint16)))
    a, b = ours.particle_list(), ref.particle_list()
    assert a.n_valid == b.n_valid == n
    for f in ("event", "mcid", "tau", "x", "y", "eta", "t", "z", "E", "px",
              "py", "pz", "mass"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_array_equal(a.eta, ch["cell_eta"][ch["cell_idx"]])


def test_3d_host_boost_matches_device_boost(wd3_sampler):
    """In 3+1d the lean route's host boost and the full route's device
    boost take the same rows to the same lab momenta (no rapidity stream
    apart, unlike 2+1d): px, py, pz within f32 rounding, eta equal."""
    inp = sampler_inputs(wd3_sampler, 1, False, dimension=3)
    cfg = Config(operation=2, df_mode=1, hrg_eos=3, dimension=3,
                 include_shear_deltaf=1, include_bulk_deltaf=1, fast=1,
                 cell_block=64)

    def run(**kw):
        return ps.sample_particles(inp.surf, inp.species, inp.chosen,
                                   inp.df_data, cfg, inp.laguerre, 2000,
                                   "cpu", seed=21, **kw)

    coll = ps.ChunkCollector()
    run(chunk_consumer=coll, lean=True)
    lean, dev = coll.particle_list(), ps.to_particle_list(run())
    assert lean.n_valid == dev.n_valid > 2000
    for f in ("event", "mcid", "tau", "eta"):
        np.testing.assert_array_equal(getattr(lean, f), getattr(dev, f),
                                      err_msg=f)
    for f in ("px", "py", "pz", "E"):
        a, b = getattr(lean, f), getattr(dev, f)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f


@pytest.mark.parametrize("df_mode", [1, 2])
def test_3d_cli_writes_oscar_event_files(tmp_path, capsys, df_mode):
    """Operation 2 in 3+1d through the CLI into OSCAR files: one file per
    event, rows summing to the kept count, every hadron at its cell's
    spacetime rapidity (|eta| <= 2 from t and z)."""
    wd = build_sampler_workdir(
        tmp_path / "wd", seed=11, dimension=3,
        params={"operation": 2, "df_mode": df_mode, "test_sampler": 0,
                "min_num_hadrons": 5.0e3, "max_num_samples": 1.0e5,
                "cell_block": 64})
    assert cli.main([str(wd), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    n_events = int(re.search(r"sampling (\d+) events", out).group(1))
    kept = int(re.search(r"sampled hadrons: (\d+) kept", out).group(1))
    osc = sorted((wd / "results").glob("particle_list_osc_*.dat"))
    assert len(osc) == n_events > 1 and kept > 2.0e3
    lines = []
    for f in osc:
        head, *body = f.read_text().splitlines()
        assert head == "n pid px py pz E m x y z t"
        lines += body
    rows = np.array([line.split() for line in lines], dtype=np.float64)
    assert rows.shape == (kept, 11)
    z, t = rows[:, 9], rows[:, 10]
    assert np.abs(np.arctanh(z / t)).max() <= 2.0 + 1e-4


# ----------------------------------------------------------------------
# the CLI and the writers
# ----------------------------------------------------------------------

KINDS = ("dN_pTdpTdphidy", "vn", "dN_2pipTdpTdy", "dN_dphidy", "dN_dy")


@pytest.mark.parametrize("df_mode", [1, 2])
def test_cli_3d_writes_the_jax_files(tmp_path, df_mode):
    """The port's CLI (f32c, B1's 3+1d plain version) and the JAX driver's
    f64 route on one 3+1d workdir: the same files, rows and key columns
    (y first), values within 1e-6 on bins >= 1e-4 of their file's peak,
    v_n within 1e-6 on those rows."""
    wd = build_workdir(tmp_path / "jax", params={"df_mode": df_mode,
                                                 "compute_dtype": "f32c"},
                       dimension=3, n_y=N_Y)
    port = shutil.copytree(wd, tmp_path / "port")
    from is3d2_tpu.config import Config as JConfig
    jcfg = dataclasses.replace(
        JConfig.from_file(wd / "iS3D_parameters.dat"), compute_dtype="f64")
    with contextlib.redirect_stdout(io.StringIO()):
        JIS3D(wd, cfg=jcfg).run_particlization()
        assert cli.main([str(port), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (wd / "results/continuous").iterdir())
    assert names == sorted(p.name for p in
                           (port / "results/continuous").iterdir())
    assert len(names) == len(KINDS) * len(CHOSEN)
    for name in names:
        skip = 1 if name.startswith("dN_pTdpTdphidy") else 0
        ref = np.loadtxt(wd / "results/continuous" / name, skiprows=skip,
                         ndmin=2)
        out = np.loadtxt(port / "results/continuous" / name, skiprows=skip,
                         ndmin=2)
        assert out.shape == ref.shape, name
        n_key = 1 if name.startswith("dN_dy") else (
            3 if name.startswith("dN_pTdpTdphidy") else 2)
        np.testing.assert_array_equal(out[:, :n_key], ref[:, :n_key])
        if name.startswith("vn"):
            # v_n where its (y, pT) row's spectrum, the file of the same
            # rows dN_2pipTdpTdy, reaches 1e-4 of its peak
            den = np.loadtxt(wd / "results/continuous"
                             / name.replace("vn", "dN_2pipTdpTdy"))[:, -1]
            sig = den >= 1e-4 * den.max()
            assert np.abs(out[sig, 2:] - ref[sig, 2:]).max() <= 1e-6, name
            continue
        v, r = out[:, -1], ref[:, -1]
        sig = np.abs(r) >= 1e-4 * np.abs(r).max()
        assert (np.abs(v - r)[sig] / np.abs(r)[sig]).max() <= F32C_TOL, name
    dndy = np.loadtxt(port / "results/continuous/dN_dy_211.dat")
    assert dndy.shape == (N_Y, 2) and (dndy[:, 1] > 0).all()


def test_writers_3d_bytes_match_jax(tmp_path):
    """The five op-1 writers on the same 3+1d spectra and tables: the JAX
    writer's bytes."""
    rng = np.random.default_rng(12)
    S, NpT, Nphi, Ny = 3, 4, 5, 7
    g = JGrids(pT=np.linspace(0.1, 2.0, NpT), pT_weight=rng.uniform(0, 1, NpT),
               phi=np.linspace(0.0, 6.0, Nphi),
               phi_weight=rng.uniform(0, 1, Nphi),
               y=np.linspace(-5.0, 5.0, Ny), y_weight=np.full(Ny, 1.0 / 6),
               eta=np.zeros(1), eta_weight=np.ones(1))
    spectra = rng.uniform(0, 1, (S, NpT, Nphi, Ny)) * 10.0 ** rng.integers(
        -9, 3, (S, NpT, Nphi, Ny))
    mcids = [211, -321, 2212]
    for name in ("write_spectra", "write_vn", "write_dN_2pipTdpTdy",
                 "write_dN_dphidy", "write_dN_dy"):
        getattr(output, name)(tmp_path / "ours", mcids, spectra,
                              interop.grids_from_numpy(numpy_fields(g)), 3)
        getattr(j_output, name)(tmp_path / "ref", mcids, spectra, g, 3)
    files = sorted(p.name for p in (tmp_path / "ref/continuous").iterdir())
    assert len(files) == len(KINDS) * S
    for name in files:
        assert (tmp_path / "ours/continuous" / name).read_bytes() == \
            (tmp_path / "ref/continuous" / name).read_bytes(), name


# ----------------------------------------------------------------------
# what validate_slice lets through and rejects in 3+1d
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"operation": op, "compute_dtype": dt, "use_pallas": up}
    for op in (0, 1, 2) for dt in ("f64", "f32", "f32c") for up in (-1, 0, 1)])
@pytest.mark.parametrize("df_mode", [1, 2])
def test_validate_slice_lets_3d_df12_through(kw, df_mode):
    Config(dimension=3, df_mode=df_mode, mode=1, **kw).validate_slice()


@pytest.mark.parametrize("kw", [
    # a mode-5 surface in 3+1d runs after df 1-5 and every operation
    # (tests/test_torch_polarization_3d.py)
    {"df_mode": 3, "mode": 5},
    {"df_mode": 5, "compute_dtype": "f32c", "mode": 5},
    {"df_mode": 4, "operation": 2, "mode": 5},
    {"df_mode": 1, "mode": 5},
    {"df_mode": 2, "mode": 5, "operation": 2},
])
def test_validate_slice_lets_3d_mode5_through(kw):
    Config(**{"dimension": 3, **kw}).validate_slice()


@pytest.mark.parametrize("kw,item", [
    # 3+1d df 1-5 and mode 5 under a mesh: rejected until ROADMAP ``item``
    # (parallel/) was ported
    ({"df_mode": 4, "compute_dtype": "f32", "use_mesh": 1}, "A12"),
    ({"df_mode": 3, "operation": 0, "use_mesh": 1}, "A12"),
    ({"df_mode": 1, "use_mesh": 1}, "A12"),
    ({"df_mode": 2, "operation": 2, "use_mesh": 1}, "A12"),
    ({"df_mode": 1, "mode": 5, "use_mesh": 1}, "A12"),
])
def test_validate_slice_still_rejects_in_3d(kw, item):
    """With the mesh ported these validate; what 3+1d still rejects under
    a mesh is what the JAX package rejects: df 4 with baryons."""
    Config(**{"dimension": 3, **kw}).validate_slice()
    with pytest.raises(ValueError, match="PTB"):
        Config(**{"dimension": 3, **kw, "df_mode": 4,
                  "include_baryon": 1}).validate_slice()
