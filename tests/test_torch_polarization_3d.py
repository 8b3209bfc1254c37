"""Surface mode 5 in 3+1d: the spin polarization against the JAX package on
the CPU.

A 3+1d mode-5 workdir (torch_parity.build_workdir with dimension 3: each
cell's eta in [-2, 2], u^eta and dsigma_eta nonzero, the thermal vorticity;
512 cells, 8 species, 16 pT x 8 phi and 9 y nodes).  In 3+1d each (cell, y)
pair is one term, d = y - eta_cell, with no eta weight and no delta_eta
(the JAX package's w_eta = 1).  Bars, as in tests/test_torch_polarization.py
(kernel_check.polarization_errors): the port's f64 engine meets the JAX f64
engine to 1e-12 on both metrics; kernel P1's 3+1d plain version (f32,
f32c: the route on the CPU) meets the JAX f64 engine and the JAX XLA f32
program (_polzn_fast_3d_jit) to 2e-5 on Snorm and 1e-5 of max |P| on P,
also where cells sit within 1e-4 of a y node (the pure pn spin terms take
mT sinh(y - eta) there).  Result files carry 9 significant digits: the f64
route's files are held to 1e-8 of max |P|.
"""

import contextlib
import dataclasses
import io
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
                          polarization_file_errors, set_params)

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core.polarization import (  # noqa: E402
    compute_polarization as j_compute_polarization)
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402
from is3d2_tpu.io.pdg import read_pdg as j_read_pdg  # noqa: E402
from is3d2_tpu.io.tables import MomentumGrids as JGrids  # noqa: E402

from is3d2_tpu_torch import cli  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core.polarization import (  # noqa: E402
    compute_polarization, polarization_f64, polarization_state)
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import output, surface  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import MomentumGrids  # noqa: E402
from is3d2_tpu_torch.ops import polarization_f32 as pz  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_Y = 9
F64_TOL = 1e-12
FILE_TOL = 1e-8      # the f64 route's files: 9 significant digits


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("polzn3d"), surface_mode=5,
                         dimension=3, n_y=N_Y)


def _surface(n=N_CELLS, seed=3):
    return synthetic.make_surface(n, seed=seed, dimension=3, vorticity=True)


def _jax(workdir, surf, dtype):
    cfg = JConfig(operation=1, mode=5, df_mode=1, hrg_eos=3, dimension=3,
                  cell_block=BLOCK, compute_dtype=dtype)
    species = j_read_pdg(3, workdir / "PDG")
    chosen = species.chosen_indices(CHOSEN)
    grids = JGrids.from_dir(workdir / "tables")
    return np.stack(j_compute_polarization(surf, species, chosen, grids,
                                           surf.thermo_averages(), cfg))


def _port(workdir, surf, dtype, grids=None):
    cfg = Config(operation=1, mode=5, df_mode=1, dimension=3,
                 cell_block=BLOCK, compute_dtype=dtype)
    species = read_pdg(3, workdir / "PDG")
    chosen = species.chosen_indices(CHOSEN)
    grids = grids or MomentumGrids.from_dir(workdir / "tables")
    return np.stack(compute_polarization(surf, species, chosen, grids,
                                         surf.thermo_averages(), cfg, "cpu"))


def _bars(out, ref):
    norm, p = kc.polarization_errors(out, ref)
    assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


@pytest.fixture(scope="module")
def jax_f64(workdir):
    return _jax(workdir, _surface(), "f64")


# ----------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------

def test_f64_engine_matches_jax_f64(workdir, jax_f64):
    """(5, S, NpT, Nphi, Ny) sums on a surface whose un and dsigma_eta are
    nonzero, 1e-12 of the JAX f64 engine on both metrics."""
    surf = _surface()
    assert np.abs(surf.un).max() > 0 and np.abs(surf.dan).max() > 0
    a = _port(workdir, surf, "f64")
    assert a.shape == (5, len(CHOSEN), 16, 8, N_Y) == jax_f64.shape
    norm, p = kc.polarization_errors(a, jax_f64)
    assert norm <= F64_TOL and p <= F64_TOL, (norm, p)


@pytest.mark.parametrize("dtype", ["f32c", "f32"])
@pytest.mark.parametrize("jax_dtype", ["f64", "f32"])
def test_p1_3d_plain_matches_jax_routes(workdir, jax_f64, dtype, jax_dtype):
    """Kernel P1's 3+1d plain version (the port's f32 and f32c route on
    the CPU) against the JAX package's f64 engine and its XLA f32
    program."""
    ref = jax_f64 if jax_dtype == "f64" else _jax(workdir, _surface(), "f32")
    out = _port(workdir, _surface(), dtype)
    assert out.shape == ref.shape
    _bars(out, ref)


@pytest.mark.parametrize("jax_dtype", ["f64", "f32"])
def test_p1_3d_near_cancellation(workdir, jax_dtype):
    """Half the cells within NEAR_Y of a y node, the vorticity nonzero: the
    plain version meets the JAX routes at the bars there too."""
    surf = kc.near_cancellation_surface(workdir, N_CELLS, 3)
    y = MomentumGrids.from_dir(workdir / "tables").y
    gap = np.abs(y[None, :] - surf.eta[:, None]).min(axis=1)
    assert (gap <= kc.NEAR_Y).sum() == N_CELLS // 2
    for f in ("wxy", "wty", "wtx"):
        assert np.abs(getattr(surf, f)).max() > 0
    _bars(_port(workdir, surf, "f32c"), _jax(workdir, surf, jax_dtype))


def test_p1_3d_check_cases_on_the_cpu(workdir):
    """kernel_check's 3+1d cases (the plain version stands in for the
    kernel here): on the surface and the near-cancellation surface it
    meets the f64 engine at the bars, and the pack holds the (cosh, sinh)
    of y - eta formed in f64."""
    for near in (False, True):
        r = kc.check_polarization_3d_case(workdir, N_CELLS, 5, "cpu",
                                          near=near, cell_block=BLOCK)
        assert r.ok and r.launches == 0, (near, r.vs_f64)
        assert r.kernel.shape == (5, len(CHOSEN) * 16 * N_Y * 8)
    cfg = Config(mode=5, dimension=3, compute_dtype="f32c",
                 cell_block=BLOCK)
    surf = kc.near_cancellation_surface(workdir, N_CELLS, 5)
    state = kc.polarization_engine_state(workdir, cfg, surf, "cpu")
    ops = kc.polarization_operands_3d(state)
    d = state[2].y[None, :] - state[0].eta[:N_CELLS, None]
    want = torch.stack([torch.cosh(d), torch.sinh(d)], dim=2).float()
    assert torch.equal(ops.ytab, want)


def _factor_exponents(ops):
    """(e_m, exy, A) as the plain version forms them in f32: the (cells,
    M) exponents of the factored exponential are e_m - A (per (cell, y))
    and exy + A (per (cell, phi))."""
    q = {n: ops.cell[:, i:i + 1] for i, n in enumerate(pz.CELL_COLS_3D)}
    mT, px, py, _, _, pT = ops.mom
    t = ops.ytab[:, torch.arange(ops.mom.shape[1]) // ops.row_len % ops.n_y]
    e_m = (q["qe0"] * mT) * t[..., 0] + (q["qe3"] * mT) * t[..., 1]
    return e_m, q["qe1"] * px + q["qe2"] * py, q["qa"] * pT


@pytest.mark.parametrize("which", ["surface", "near", "fast"])
def test_p1_3d_shifted_factors_stay_at_least_one(workdir, which):
    """P1's shift A = |u_perp| pT log2(e) / T keeps both exponents of the
    factored 2^(u.p log2(e) / T) at least 0 up to f32 rounding, so both
    factors are at least ~1: on the test surface, the near-cancellation
    surface and the fast cold one."""
    surf = {"surface": _surface(),
            "near": kc.near_cancellation_surface(workdir, N_CELLS, 3),
            "fast": kc.fast_flow_surface(N_CELLS, 3)}[which]
    e_m, exy, a = _factor_exponents(
        kc.polarization_operands_3d(_state(workdir, surf)))
    assert float(a.min()) > 0
    tol = 1e-6 * float(a.max())
    assert float((e_m - a).min()) >= -tol
    assert float((exy + a).min()) >= -tol


def test_p1_3d_shifted_factors_stay_finite_on_fast_cold_cells(workdir):
    """kernel_check.fast_flow_surface: |u_perp| ~ 3, T = 0.08 GeV, pT up
    to 3 GeV.  Unshifted, 2^e_m 2^exy is inf times 0 (a NaN) for some
    terms; P1's plain version (shifted) stays finite and within
    kc.FAST_FLOW_TOL of the f64 engine on both metrics.  At |u.p| / T ~
    150 no f32 order of the arithmetic reaches the JAX bars: the JAX
    package's f32 program's distance from its f64 engine is printed
    beside the port's."""
    surf = kc.fast_flow_surface(N_CELLS, 3)
    e_m, exy, _ = _factor_exponents(
        kc.polarization_operands_3d(_state(workdir, surf)))
    assert torch.isnan(torch.exp2(e_m) * torch.exp2(exy)).any()
    r = kc.check_polarization_3d_case(workdir, N_CELLS, 3, "cpu",
                                      fast_flow=True, cell_block=BLOCK)
    assert r.launches == 0 and np.isfinite(r.kernel).all()
    assert r.ok, r.vs_f64
    jax = kc.polarization_errors(_jax(workdir, surf, "f32"),
                                 _jax(workdir, surf, "f64"))
    print(f"fast cold cells: port f32c vs f64 Snorm {r.vs_f64[0]:.3e}, P "
          f"{r.vs_f64[1]:.3e}; JAX f32 vs f64 Snorm {jax[0]:.3e}, P "
          f"{jax[1]:.3e}")


# ----------------------------------------------------------------------
# the 3+1d pack and its ragged sizes
# ----------------------------------------------------------------------

def _state(workdir, surf):
    cfg = Config(mode=5, dimension=3, cell_block=BLOCK, compute_dtype="f32c")
    species = read_pdg(3, workdir / "PDG")
    grids = MomentumGrids.from_dir(workdir / "tables")
    state = polarization_state(surf, species, species.chosen_indices(CHOSEN),
                               grids, cfg, "cpu")
    return (*state, surf.thermo_averages().temperature, 1.0)


def test_p1_3d_pack_takes_the_real_cells_and_orders_y_before_phi(workdir):
    """pack_inputs_3d hands P1 the pad_mask > 0 rows (the u.dsigma <= 0
    cells kept, no padding) and the momenta in (species, pT, y, phi)
    order; with ``mask`` in place of pad_mask Snorm moves, so those cells
    count; the sums meet the f64 engine on the padded cells."""
    n = N_CELLS - 12
    state = _state(workdir, _surface(n))
    cells = state[0]
    assert cells.n_padded == N_CELLS
    assert ((cells.mask == 0) & (cells.pad_mask == 1)).sum() > 0
    ops = kc.polarization_operands_3d(state)
    assert ops.cell.shape == (n, len(pz.CELL_COLS_3D))
    assert ops.ytab.shape == (n, N_Y, 2)
    assert (ops.row_len, ops.n_y) == (8, N_Y)
    mom = ops.mom.reshape(len(pz.MOM_ROWS_3D), len(CHOSEN), 16, N_Y, 8)
    assert (mom[1] == mom[1][:, :, :1]).all()          # px along y
    assert (mom[0] == mom[0][..., :1, :1]).all()        # mT per group
    assert (mom[5] == mom[5][..., :1, :1]).all()        # pT per group
    ref = kc.f64_polarization_3d(state)
    _bars(pz.polarization_f32_3d(*ops.args(), **ops.layout()).numpy(), ref)
    skipped = dataclasses.replace(cells, pad_mask=cells.mask)
    out = polarization_f64(skipped, *state[1:], dimension=3).numpy()
    full = polarization_f64(*state, dimension=3).numpy()
    assert np.abs(full[4] - out[4]).max() > 1e-6 * np.abs(full[4]).max()


# name -> (write_workdir options, cells): 1 y node; 5 y and 7 phi, which
# the register tile (4 phi x 3 y) does not divide, on 500 cells (not a
# whole number of 256-cell runs)
RAGGED_WORKDIRS = {
    "one-y": ({"n_y": 1, "n_phi": 8}, N_CELLS),
    "5y-7phi-500cells": ({"n_y": 5, "n_phi": 7}, 500),
}


@pytest.mark.parametrize("case", list(RAGGED_WORKDIRS))
def test_p1_3d_ragged_sizes_match_jax(tmp_path, case):
    kw, n = RAGGED_WORKDIRS[case]
    wd = synthetic.write_workdir(tmp_path / "wd", n_cells=16, seed=3,
                                 chosen_mcids=CHOSEN, n_pT=16, n_T=21,
                                 surface_mode=5, dimension=3, **kw)
    surf = _surface(n)
    out = _port(wd, surf, "f32c")
    assert out.shape == (5, len(CHOSEN), 16, kw["n_phi"], kw["n_y"])
    _bars(out, _jax(wd, surf, "f64"))


@pytest.mark.parametrize("n_y", kc.RAGGED_Y)
def test_p1_3d_ragged_cut_runs(workdir, n_y):
    """kernel_check's ragged 3+1d case: 3 species x 5 pT x 7 phi, the
    first n_y rapidities, 1000 cells: the wrapper (its plain version on
    the CPU) gives the plain version's bits."""
    r = kc.check_polarization_3d_ragged_case(workdir, 1024, 7, "cpu",
                                             n_y=n_y)
    assert r.kernel.shape == (5, 3 * 5 * n_y * 7)
    assert np.array_equal(r.kernel, r.plain) and r.ok


def test_p1_3d_sums_runs_of_64_cells_in_f32(workdir):
    """The plain version adds the terms of each run of RUN_CELLS_3D (256)
    cells in f32, in cell order, and the runs in f64 (as the kernel does):
    with the factor -1/(4m) set to 1, the cut to two runs is the f64 sum
    of its two runs bit for bit, and a run is not the f64 sum of its cells
    (it rounds in f32) but within f32 rounding of it."""
    ops = kc.polarization_operands_3d(_state(workdir, _surface()))
    mom = ops.mom.clone()
    mom[4] = -1.0

    def run(c0, c1):
        return pz.polarization_f32_3d_plain(
            ops.cell[c0:c1].contiguous(), ops.ytab[c0:c1].contiguous(), mom,
            **ops.layout())
    n = pz.RUN_CELLS_3D
    assert n == 256 and ops.cell.shape[0] >= 2 * n
    a = run(0, n)
    assert torch.equal(a + run(n, 2 * n), run(0, 2 * n))
    singles = sum(run(c, c + 1) for c in range(n))
    assert not torch.equal(singles, a)
    torch.testing.assert_close(a, singles, rtol=1e-5,
                               atol=1e-6 * float(a.abs().max()))


def test_p1_3d_wrapper_checks_its_operands(workdir):
    ops = kc.polarization_operands_3d(_state(workdir, _surface()))
    with pytest.raises(ValueError, match="n_y"):
        pz.polarization_f32_3d(*ops.args(), row_len=8)
    with pytest.raises(ValueError, match="ytab"):
        pz.polarization_f32_3d(ops.cell, ops.ytab[:, :3].contiguous(),
                               ops.mom, **ops.layout())
    with pytest.raises(ValueError, match="cell"):
        pz.polarization_f32_3d(ops.cell.double(), ops.ytab, ops.mom,
                               **ops.layout())


def test_3d_polarization_takes_no_eta_table(workdir):
    """In 3+1d the eta table enters neither route (no eta weight, no
    delta_eta): another table gives the same bits."""
    surf = _surface()
    grids = MomentumGrids.from_dir(workdir / "tables")
    other = dataclasses.replace(grids, eta=grids.eta[:7] * 0.3,
                                eta_weight=grids.eta_weight[:7] * 2.0)
    for dtype in ("f64", "f32c"):
        assert np.array_equal(_port(workdir, surf, dtype),
                              _port(workdir, surf, dtype, other))


# ----------------------------------------------------------------------
# the driver and the CLI
# ----------------------------------------------------------------------

# (workdir parameters, build_workdir options, bar on the files' P): the
# JAX driver runs its f64 route, the port the given one
DRIVER_CASES = {
    "op1-df1-f32c": ({"compute_dtype": "f32c"}, {}, kc.POLZN_TOL_P),
    "op1-df4-f32": ({"df_mode": 4, "compute_dtype": "f32"},
                    {"shear_scale": 0.2, "bulk_scale": 0.1}, kc.POLZN_TOL_P),
    "op1-df4-f64": ({"df_mode": 4, "compute_dtype": "f64"},
                    {"shear_scale": 0.2, "bulk_scale": 0.1}, FILE_TOL),
    "op2-df1-hist": ({"operation": 2, "test_sampler": 1,
                      "min_num_hadrons": 2.0e4}, {}, kc.POLZN_TOL_P),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_port_cli_matches_jax_driver_3d_mode5(tmp_path, case):
    """The port's CLI writes St, Sx, Sy, Sn.dat with Ny y blocks of every
    chosen species (never grouped), after the operation's own files, and
    they meet the JAX driver's f64 files."""
    params, kw, tol = DRIVER_CASES[case]
    wd = build_workdir(tmp_path / "jax", params={"cell_block": BLOCK},
                       surface_mode=5, dimension=3, n_y=N_Y, **kw)
    port = shutil.copytree(wd, tmp_path / "port")
    set_params(port, params)
    set_params(wd, {**params, "compute_dtype": "f64"})
    ref = JIS3D(wd)
    with contextlib.redirect_stdout(io.StringIO()):
        ref.run_particlization()
        assert cli.main([str(port), "--device", "cpu"]) == 0
    St, Sx, Sy, Sn, Snorm = ref.polarization
    assert St.shape == (len(CHOSEN), 16, 8, N_Y)
    assert polarization_file_errors(wd, port, Snorm) <= tol
    sub = "sampled" if params.get("operation") == 2 else "continuous"
    assert any((port / "results" / sub).iterdir())


def test_in_memory_runs_equal_the_file_route(workdir):
    """IS3D on a surface held in memory (fo_from_file = False) gives the
    file route's polarization bit for bit (f32c); the JETSCAPE-style
    in-memory surface carries no vorticity, so there the spin sums are 0
    and Snorm is the file route's."""
    cfg = dataclasses.replace(
        Config.from_file(workdir / "iS3D_parameters.dat"),
        compute_dtype="f32c")
    assert (cfg.dimension, cfg.mode) == (3, 5)
    s = surface.read_surface(workdir / "input/surface.dat", 5, 3, False)
    fields = dict(tau=s.tau, x=s.x, y=s.y, eta=s.eta, dsigma_tau=s.dat,
                  dsigma_x=s.dax, dsigma_y=s.day, dsigma_eta=s.dan, E=s.E,
                  T=s.T, P=s.P, ux=s.ux, uy=s.uy, un=s.un, pixx=s.pixx,
                  pixy=s.pixy, pixn=s.pixn, piyy=s.piyy, piyn=s.piyn,
                  pinn=np.zeros_like(s.tau), Pi=s.bulkPi)
    runs = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for how in ("file", "held", "jetscape"):
            run = IS3D(workdir, cfg=cfg, device="cpu")
            if how == "held":
                run.surface = s
            elif how == "jetscape":
                run.load_surface_from_memory(**fields)
            run.run_particlization(fo_from_file=how == "file", write=False)
            runs[how] = np.stack(run.polarization)
    assert runs["file"].shape == (5, len(CHOSEN), 16, 8, N_Y)
    assert np.array_equal(runs["held"], runs["file"])
    assert np.array_equal(runs["jetscape"][4], runs["file"][4])
    assert not runs["jetscape"][:4].any() and runs["file"][:4].any()


def test_port_runs_3d_mode5_without_jax(tmp_path):
    """3+1d mode 5 in a fresh process (f32c: P1's 3+1d plain version,
    called once): never imports jax or the JAX package; four finite files
    of S x NpT x Nphi x Ny rows."""
    wd = synthetic.write_workdir(
        tmp_path / "wd", n_cells=BLOCK, chosen_mcids=CHOSEN, n_pT=8,
        n_phi=8, n_T=21, surface_mode=5, dimension=3, n_y=5,
        params={"cell_block": BLOCK})
    code = (
        "import sys\n"
        "from is3d2_tpu_torch import cli\n"
        "from is3d2_tpu_torch.ops import polarization_f32 as pz\n"
        "calls = []\n"
        "plain = pz.polarization_f32_3d_plain\n"
        "pz.polarization_f32_3d_plain = "
        "lambda *a, **k: calls.append(1) or plain(*a, **k)\n"
        f"cli.main([{str(wd)!r}, '--device', 'cpu'])\n"
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
    assert "computing spin polarization" in proc.stdout
    for name in output.POLARIZATION_FILES:
        v = np.loadtxt(wd / "results" / f"{name}.dat")
        assert v.shape == (len(CHOSEN) * 8 * 8 * 5, 4)
        assert np.isfinite(v).all()
