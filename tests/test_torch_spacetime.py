"""Operation 0 (dN/dX) of the port against the JAX package.

On synthetic workdirs (384 cells of make_surface, 8 species, 12 pT x 8 phi,
24 eta; a mode-6 surface with dsigma_eta / tau in [-0.05, 0.05]), the
normalized bins of all three axes match the JAX driver's f64 route on bins
>= 1e-4 of each species' peak:
  * the port's f64 engines <= 1e-10 (df 1/2, and df 3/4 in the spacetime
    distributions' dan-weighted convention, with dsigma_eta != 0);
  * kernel B1's route (f32c) <= 1e-6, <= 5e-6 with baryons (ROADMAP C3:
    the port's energy is the f64 one, the JAX f32c paths drop part of
    alphaB; held to the JAX f64 route all the same);
  * kernel B3's route (f32) <= 1e-4.
On the CPU each kernel runs its plain version: B1's per-cell mode once,
B3 once per non-empty bin.
Also: the binning against the JAX package's at bin edges, the writer's
bytes, df 5's ValueError, the report lines, the mass-sorted order of
group_particles, and the dan convention (it decides the number only where
the integrand is not even in eta, e.g. with outflow).
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

from torch_parity import CHOSEN, max_rel_err, run_drivers  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core import spacetime as j_spacetime  # noqa: E402
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402
from is3d2_tpu.io import output as j_output  # noqa: E402

from is3d2_tpu_torch import cli  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import spacetime  # noqa: E402
from is3d2_tpu_torch.core.cells import prepare_cells  # noqa: E402
from is3d2_tpu_torch.core.spectra import df12_state  # noqa: E402
from is3d2_tpu_torch.core.spectra_feqmod import feqmod_state  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import output  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)

FEQMOD_SURFACE = {"shear_scale": 0.2, "bulk_scale": 0.1}


def _workdir(root: Path, params: dict, mode: int = 6, dan: float = 0.05,
             chosen=CHOSEN, **kw) -> Path:
    return synthetic.write_workdir(
        root, n_cells=384, seed=3, chosen_mcids=chosen, n_pT=12, n_phi=8,
        n_T=21, surface_mode=mode, dan_scale=dan,
        params={"operation": 0, "cell_block": 128, **params}, **kw)


def _errors(ours, ref) -> list[float]:
    return [max_rel_err(a, b) for a, b in
            zip(ours.dN_dX.normalized(ours.cfg), ref.dN_dX.normalized(ref.cfg))]


# name -> (config fields, bar against the JAX f64 route, write_workdir kw)
CASES = {
    "df1-f64": ({"df_mode": 1, "compute_dtype": "f64"}, 1e-10, {}),
    "df2-f64": ({"df_mode": 2, "compute_dtype": "f64"}, 1e-10, {"mode": 1,
                                                               "dan": 0.0}),
    "df3-f64": ({"df_mode": 3, "compute_dtype": "f64"}, 1e-10,
                FEQMOD_SURFACE),
    "df4-f64-outflow": ({"df_mode": 4, "compute_dtype": "f64",
                         "outflow": 1}, 1e-10, FEQMOD_SURFACE),
    "df1-f32c": ({"df_mode": 1, "compute_dtype": "f32c"}, 1e-6, {}),
    "df2-f32c-mode0": ({"df_mode": 2, "compute_dtype": "f32c"}, 1e-6,
                       {"mode": 0}),
    "df1-f32c-baryons": ({"df_mode": 1, "compute_dtype": "f32c",
                          "include_baryon": 1,
                          "include_baryondiff_deltaf": 1}, 5e-6,
                         {"include_baryon": True, "n_muB": 9}),
    "df2-f32c-baryons": ({"df_mode": 2, "compute_dtype": "f32c",
                          "include_baryon": 1,
                          "include_baryondiff_deltaf": 1}, 5e-6,
                         {"include_baryon": True, "n_muB": 9}),
    "df3-f32": ({"df_mode": 3, "compute_dtype": "f32"}, 1e-4,
                FEQMOD_SURFACE),
    "df4-f32": ({"df_mode": 4, "compute_dtype": "f32"}, 1e-4,
                FEQMOD_SURFACE),
    "df4-f32-outflow-regulate": ({"df_mode": 4, "compute_dtype": "f32",
                                  "outflow": 1, "regulate_deltaf": 1}, 1e-4,
                                 FEQMOD_SURFACE),
    # the re-anchor's probes of operation 0 (ROADMAP C8)
    "df1-f32c-outflow-regulate": ({"df_mode": 1, "compute_dtype": "f32c",
                                   "outflow": 1, "regulate_deltaf": 1}, 1e-6,
                                  {}),
    "df3-f32-baryons": ({"df_mode": 3, "compute_dtype": "f32",
                         "include_baryon": 1,
                         "include_baryondiff_deltaf": 1}, 1e-4,
                        {"include_baryon": True, "n_muB": 9,
                         **FEQMOD_SURFACE}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_op0_matches_the_jax_f64_route(tmp_path, case):
    params, bar, kw = CASES[case]
    wd = _workdir(tmp_path / "wd", params, **kw)
    ref, ours = run_drivers(wd)
    assert [b.shape for b in ours.dN_dX.normalized(ours.cfg)] == \
        [(8, 120), (8, 60), (8, 100)]
    for a, b in zip(ours.dN_dX.normalized(ours.cfg),
                    ref.dN_dX.normalized(ref.cfg)):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a == 0, b == 0)   # the same bins
    errs = _errors(ours, ref)
    assert max(errs) <= bar, f"{case}: {errs}"


def test_kernel_route_launches_once_per_nonempty_bin(tmp_path):
    """B1's route hands the kernel each non-empty bin's cells once per axis,
    out-of-range and u.dsigma <= 0 cells left out, and its bins equal the
    f64 route's per-cell sums binned (<= 1e-6)."""
    wd = _workdir(tmp_path / "wd", {"df_mode": 1, "compute_dtype": "f32c"})
    run = IS3D(wd, device="cpu")
    run.load_surface_from_file()
    run._setup()
    cfg = run.cfg
    state = df12_state(run.surface, run.species, run.chosen_idx, run.grids,
                       run.df_data, cfg, "cpu")
    cells = state[0]
    ops = spacetime.kernel_operands(*state, cfg)
    handed = []

    def call(o, c):
        handed.append(o.cell.shape[0])
        return spacetime.run_kernel(o, c)

    bins = spacetime.kernel_bins(cells, ops, state[2], state[3], cfg, call)
    mask = cells.mask.numpy()
    runs = [spacetime.binned_cells(idx, n, mask)
            for idx, n in spacetime.bin_indices(cells, cfg)]
    assert len(handed) == sum(len(r) for _, r in runs)
    in_range = [rows.shape[0] for rows, _ in runs]
    assert sum(handed) == sum(in_range)
    assert in_range[0] == in_range[2] == int(mask.sum())   # tau, phi: all
    assert in_range[1] < in_range[0]                       # r > 12 fm: out
    dN = spacetime.dN_dy_cells(*state, cfg)
    for b, (idx, n) in zip(bins, spacetime.bin_indices(cells, cfg)):
        ref = spacetime._scatter(dN, idx, n, mask)
        assert max_rel_err(b.numpy(), ref.numpy()) <= 1e-6


def test_bin_indices_match_jax_at_the_edges():
    """Cells on bin edges, outside the ranges and at negative phi land in
    the JAX package's bins."""
    n = 64
    rng = np.random.default_rng(2)
    s = synthetic.make_surface(n, seed=2)
    s.tau = np.concatenate([[0.0, 0.1, 12.0, 11.9999999, -0.1],
                            rng.uniform(0.0, 13.0, n - 5)])
    s.x = np.concatenate([[0.0, -3.0, 12.0, 0.2, -0.0],
                          rng.uniform(-13.0, 13.0, n - 5)])
    s.y = np.concatenate([[0.0, -0.0, 0.0, -1e-12, 5.0],
                          rng.uniform(-13.0, 13.0, n - 5)])
    cfg = Config(operation=0, df_mode=1, cell_block=n)
    cells = prepare_cells(s, cfg, "cpu")
    ours = spacetime.bin_indices(cells, cfg)
    j_cells = dataclasses.replace(cells, x=jnp.asarray(s.x),
                                  y_pos=jnp.asarray(s.y),
                                  tau=jnp.asarray(s.tau))
    ref = j_spacetime._bin_indices(j_cells, JConfig(operation=0, df_mode=1))
    for (idx, n_bins), j_idx, want in zip(ours, ref, (120, 60, 100)):
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
        assert n_bins == want


def test_write_dN_dX_bytes_match_jax(tmp_path):
    cfg = JConfig(operation=0, tau_bins=7, r_bins=5, phip_bins=9)
    rng = np.random.default_rng(4)
    tau_w, r_w, phi_w = spacetime.bin_widths(cfg)
    dX = spacetime.SpacetimeDistributions(
        tau_mid=cfg.tau_min + tau_w * (np.arange(7) + 0.5),
        r_mid=cfg.r_min + r_w * (np.arange(5) + 0.5),
        phi_mid=phi_w * (np.arange(9) + 0.5),
        dN_taudtaudy=rng.uniform(0, 1, (3, 7)) * 10.0 ** rng.integers(-9, 3,
                                                                     (3, 7)),
        dN_twopirdrdy=rng.uniform(0, 1, (3, 5)),
        dN_dphidy=np.concatenate([np.zeros((3, 4)),
                                  rng.uniform(0, 1, (3, 5))], axis=1))
    mcids = [211, -321, 2212]
    output.write_dN_dX(tmp_path / "ours", mcids, dX, cfg)
    j_output.write_dN_dX(tmp_path / "ref", mcids, dX, cfg)
    files = sorted(p.name for p in (tmp_path / "ref/continuous").iterdir())
    assert len(files) == 9
    for name in files:
        assert (tmp_path / "ours/continuous" / name).read_bytes() == \
            (tmp_path / "ref/continuous" / name).read_bytes(), name


def test_cli_writes_the_jax_files(tmp_path):
    """Both CLIs on one df-2 f64 workdir: the same files, the same bin
    middles, values within the %.6e printing."""
    wd = _workdir(tmp_path / "jax", {"df_mode": 2, "compute_dtype": "f64"})
    port = tmp_path / "port"
    shutil.copytree(wd, port)
    with contextlib.redirect_stdout(io.StringIO()):
        JIS3D(wd).run_particlization()
        assert cli.main([str(port), "--device", "cpu"]) == 0
    ref_files = sorted(p.name for p in (wd / "results/continuous").iterdir())
    assert ref_files == sorted(
        p.name for p in (port / "results/continuous").iterdir())
    assert len(ref_files) == 3 * len(CHOSEN)
    for name in ref_files:
        a = np.loadtxt(port / "results/continuous" / name)
        b = np.loadtxt(wd / "results/continuous" / name)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=1e-6, atol=0)


def test_df5_raises_the_jax_value_error(tmp_path):
    wd = _workdir(tmp_path / "wd", {"df_mode": 5, "compute_dtype": "f32"},
                  eos_consistent=True, shear_scale=0.1, bulk_scale=0.05)
    ref = JIS3D(wd)
    ref.load_surface_from_file()
    ref._setup()
    with pytest.raises(ValueError) as jax_err:
        j_spacetime.compute_dN_dX(ref.surface, ref.species, ref.chosen_idx,
                                  ref.grids, ref.df_data, ref.cfg,
                                  ref.laguerre)
    with pytest.raises(ValueError) as err:
        IS3D(wd, device="cpu")
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="famod"):
        spacetime.compute_dN_dX(None, None, None, None, None,
                                Config(operation=0, df_mode=5), "cpu")


def test_report_lines_match_jax(tmp_path, capsys):
    """The skipped-cell and breakdown lines of an op-0 df-4 run."""
    wd = _workdir(tmp_path / "wd", {"df_mode": 4, "compute_dtype": "f32"},
                  **FEQMOD_SURFACE)
    JIS3D(wd).run_particlization(write=False)
    ref = capsys.readouterr().out
    IS3D(wd, device="cpu").run_particlization(write=False)
    out = capsys.readouterr().out

    def lines(log):
        return [line for line in log.splitlines()
                if line.startswith(("skipped", "feqmod breaks down"))]
    assert lines(out) == lines(ref)
    assert any(line.startswith("feqmod breaks down") for line in lines(ref))


def test_grouped_op0_keeps_the_jax_mass_order(tmp_path):
    """group_particles in operation 0 sorts the species by mass, as the
    JAX driver does, and computes each of them."""
    wd = _workdir(tmp_path / "wd", {"df_mode": 1, "compute_dtype": "f64",
                                    "group_particles": 1})
    ref, ours = run_drivers(wd)
    mcids = [int(ours.species.mc_id[i]) for i in ours.chosen_idx]
    assert mcids == [int(ref.species.mc_id[i]) for i in ref.chosen_idx]
    assert mcids != list(CHOSEN)
    assert max(_errors(ours, ref)) <= 1e-10


@pytest.mark.parametrize("outflow", [0, 1])
def test_the_dan_convention(tmp_path, outflow):
    """The spacetime distributions' p.dsigma weights its dan term; the
    spectra's does not.  On a 2+1d surface the integrand is even in eta,
    so the dan term's odd part sums to zero over the symmetric nodes in
    either convention; with outflow (Theta(p.dsigma)) the convention
    decides the number, and the JAX package's op 0 takes the weighted one."""
    from is3d2_tpu_torch.core import spectra_feqmod
    wd = _workdir(tmp_path / "wd", {"df_mode": 3, "compute_dtype": "f64",
                                    "outflow": outflow}, **FEQMOD_SURFACE)
    run = IS3D(wd, device="cpu")
    run.load_surface_from_file()
    run._setup()
    cells, fq, species, grid = feqmod_state(
        run.surface, run.species, run.chosen_idx, run.grids, run.df_data,
        run.cfg, "cpu", run.laguerre)
    blk = slice(0, 128)
    cb = type(cells)(**{f.name: getattr(cells, f.name)[blk]
                        for f in dataclasses.fields(cells)})
    fb = type(fq)(**{f.name: getattr(fq, f.name)[blk]
                     for f in dataclasses.fields(fq)})
    w = cb.mask[:, None, None, None, None, None]
    a, b = (torch.sum(w * spectra_feqmod.feqmod_weighted_value(
        cb, fb, species, grid, run.cfg, dan_weighted=d), dim=(0, 5))
        for d in (True, False))
    diff = max_rel_err(a.numpy(), b.numpy())
    assert (diff > 1e-3) if outflow else (diff < 1e-10), diff
    ref, ours = run_drivers(wd)
    assert max(_errors(ours, ref)) <= 1e-10
