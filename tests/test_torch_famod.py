"""Parity of the port's df 5 (famod) path with the JAX package.

Synthetic inputs only (tests/torch_parity.py: 512 cells of an
EOS-consistent surface, 8 species, 16 pT x 8 phi, 24 eta; the VAH solver
keeps the first <= 320 species of the synthetic list).  Tolerances,
relative:
  * physics/aniso.py against is3d2_tpu.physics.aniso on the same seeded
    f64 inputs: <= 1e-12 (the t-functions on both sides of the Taylor edges
    z = +-0.01, F, J, the 3x3 solve, the line search, the Newton with its
    failed mask lane by lane, the famod coefficients, I_100);
  * three tests/test_aniso.py cases rebuilt on the synthetic list (the
    equilibrium fixed point, the isotropic limit of the famod coefficients,
    an anisotropic solution);
  * every field of prepare_famod against the JAX f64 prep
    (_prepare_famod_host), from the reconstruction and from a mode-3
    surface's variables: <= 1e-10, with equal breakdown, pl < 0 and
    failure masks;
  * the torch f64 famod engine against _spectra_famod_jit: <= 1e-10;
  * kernel B3's famod plain version against the port's f64 famod engine:
    <= 1e-4 on bins >= 1e-4 of each species' peak (never against
    interpret-mode Pallas output, ROADMAP C1);
  * the port's CLI against the JAX driver on one df-5 workdir: f64 <= 1e-10
    (in memory), the port's f32 route against the JAX f64 route <= 1e-4;
  * the mode-2 and mode-3 readers against the JAX readers (equal arrays)
    and the mode-3 round trip (< 1e-10);
  * the report's df-5 lines equal to the JAX package's text.
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

import jax.numpy as jnp  # noqa: E402

from torch_parity import (BLOCK, CHOSEN, build_workdir,  # noqa: E402
                          eos_surface, famod_state, max_rel_err,
                          port_config, port_spectra_by_use_pallas,
                          tiny_workdir)

from is3d2_tpu.core.spectra_famod import \
    _spectra_famod_jit  # noqa: E402
from is3d2_tpu.core.spectra_famod import \
    prepare_famod as j_prepare_famod  # noqa: E402
from is3d2_tpu.core.spectra_famod import \
    vah_from_surface as j_vah_from_surface  # noqa: E402
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402
from is3d2_tpu.io import surface as j_surface  # noqa: E402
from is3d2_tpu.io.deltaf_tables import DeltafTables as JTables  # noqa: E402
from is3d2_tpu.physics import aniso as ja  # noqa: E402
from is3d2_tpu.physics.deltaf import DeltafData as JDeltafData  # noqa: E402
from is3d2_tpu.report import RunReport as JRunReport  # noqa: E402

from is3d2_tpu_torch import cli  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import spectra_famod as sf  # noqa: E402
from is3d2_tpu_torch.core.spectra import compute_spectra  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import surface as p_surface  # noqa: E402
from is3d2_tpu_torch.io.deltaf_tables import DeltafTables  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import MomentumGrids, load_table  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.physics import aniso  # noqa: E402
from is3d2_tpu_torch.physics.deltaf import DeltafData  # noqa: E402
from is3d2_tpu_torch.report import RunReport  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import (write_mode2,  # noqa: E402
                                             write_mode3, write_workdir)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PREP_TOL = 1e-10
ANISO_TOL = 1e-12


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_famod"))


@pytest.fixture(scope="module")
def famod(workdir):
    """The JAX f64 famod state of the EOS-consistent surface (~1 % of the
    cells break down), and the same state as port tensors."""
    return famod_state(workdir)


@pytest.fixture(scope="module")
def species(workdir):
    """The solver's species (the first <= 320 of the synthetic list) as
    (numpy, torch) triples of (mass, sign, degeneracy)."""
    table = read_pdg(3, workdir / "PDG")
    m, s, g = sf.reconstruction_species(table, "cpu")
    return (m.numpy(), s.numpy(), g.numpy()), (m, s, g)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(ours, ref):
    """Max |ours - ref| over max |ref| (equal non-finite entries)."""
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(ours[~fin], ref[~fin])
    if not fin.any():
        return 0.0
    return float(np.abs(ours[fin] - ref[fin]).max()
                 / max(np.abs(ref[fin]).max(), 1e-300))


def _targets(n, seed, mass, sign, deg):
    """(E, pl, pt, T) of n cells: the HRG (E, P) at T = 0.14-0.17 GeV of
    the solver's species, with anisotropic pressures pl = P (1 - d),
    pt = P (1 + d / 2), d in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(0.14, 0.17, n)
    lam = T
    X = np.stack([lam, np.ones(n), np.ones(n)], axis=-1)
    zero = np.zeros(n)
    F = ja.compute_F(jnp.asarray(X), jnp.asarray(zero), jnp.asarray(zero),
                     jnp.asarray(zero), mass, sign, deg)
    E, P = np.array(F[:, 0]), np.array(F[:, 1])
    d = rng.uniform(-0.5, 0.5, n)
    return E, P * (1.0 - d), P * (1.0 + d / 2.0), T


# ----------------------------------------------------------------------
# physics/aniso.py
# ----------------------------------------------------------------------

def test_t_functions_match_jax_across_the_taylor_edges():
    edges = []
    for e in (-0.2, -aniso.DELTA, aniso.DELTA, 0.2):
        edges += [e, np.nextafter(e, -np.inf), np.nextafter(e, np.inf)]
    z = np.concatenate([np.linspace(-0.99, 40.0, 4001), edges, [0.0, 1e-9]])
    ours = aniso._t_functions_200(_t(z)) + aniso._t_functions_400(_t(z))
    ref = ja._t_functions_200(jnp.asarray(z)) + ja._t_functions_400(
        jnp.asarray(z))
    for i, (a, b) in enumerate(zip(ours, ref)):
        # relative to each function's largest value: point by point the
        # t_40x reach 1.3e-12 at z ~ -0.17, where their exact branch
        # cancels and XLA:CPU's arctanh is 1.6e-14 off (torch's is
        # correctly rounded, checked below)
        assert _rel(a, b) <= ANISO_TOL, i
    x = np.sqrt(np.linspace(aniso.DELTA, 0.99, 2001))
    assert _rel(torch.arctanh(_t(x)), np.arctanh(x)) <= 1e-15


def test_F_J_solve_and_coefficients_match_jax(species):
    (m, s, g), (mt, st, gt) = species
    rng = np.random.default_rng(11)
    n = 64
    E, pl, pt, T = _targets(n, 5, m, s, g)
    X = np.stack([T * rng.uniform(0.9, 1.1, n), rng.uniform(0.6, 1.4, n),
                  rng.uniform(0.6, 1.4, n)], axis=-1)
    F = aniso.compute_F(_t(X), _t(E), _t(pt), _t(pl), mt, st, gt)
    jF = ja.compute_F(jnp.asarray(X), E, pt, pl, m, s, g)
    assert _rel(F, jF) <= ANISO_TOL
    J = aniso.compute_J(_t(X), F, _t(E), _t(pt), _t(pl), mt, st, gt)
    jJ = ja.compute_J(jnp.asarray(X), jF, E, pt, pl, m, s, g)
    for i in range(3):
        for k in range(3):
            assert _rel(J[:, i, k], np.asarray(jJ)[:, i, k]) <= ANISO_TOL
    dX = aniso._solve3x3(J, -F)
    assert _rel(dX, ja._solve3x3(jJ, -jF)) <= 1e-10   # conditioned by J
    bpp, bwp = aniso.compute_famod_coefficients(_t(X[:, 0]), _t(X[:, 1]),
                                                _t(X[:, 2]), mt, st, gt)
    jb = ja.compute_famod_coefficients(X[:, 0], X[:, 1], X[:, 2], m, s, g)
    assert _rel(bpp, jb[0]) <= ANISO_TOL and _rel(bwp, jb[1]) <= ANISO_TOL
    chem = rng.uniform(-0.5, 0.5, (n, m.shape[0]))
    I100 = aniso.aniso_density_integral(_t(X[:, 0]), mt, st, _t(chem))
    jI = ja.aniso_density_integral(jnp.asarray(X[:, 0]), m, s, g,
                                   chem=jnp.asarray(chem))
    assert _rel(I100, jI) <= ANISO_TOL


def test_line_search_matches_jax(species):
    """A full Newton step from a guess far off: most lanes backtrack."""
    (m, s, g), (mt, st, gt) = species
    E, pl, pt, T = _targets(48, 6, m, s, g)
    X = np.stack([0.6 * T, np.full(48, 1.8), np.full(48, 0.5)], axis=-1)
    Fargs = (E, pt, pl, m, s, g)
    jF = ja.compute_F(jnp.asarray(X), *Fargs)
    jJ = ja.compute_J(jnp.asarray(X), jF, *Fargs)
    dX = np.asarray(ja._solve3x3(jJ, -jF))
    dX_abs = np.sqrt((dX * dX).sum(-1))
    f = 0.5 * (np.asarray(jF) ** 2).sum(-1)
    jl, jFn = ja._line_backtrack(jnp.asarray(X), jnp.asarray(dX),
                                 jnp.asarray(dX_abs), jnp.asarray(f), Fargs)
    l, Fn = aniso._line_backtrack(_t(X), _t(dX), _t(dX_abs), _t(f),
                                  (_t(E), _t(pt), _t(pl), mt, st, gt))
    assert (np.asarray(jl) < 1.0).sum() > 10
    assert _rel(l, jl) <= ANISO_TOL and _rel(Fn, jFn) <= ANISO_TOL


def test_newton_matches_jax_lane_by_lane(species):
    """Converged, negative-input and non-converging lanes: the same
    solution and the same failed mask; the loop's iteration count is the
    largest of the lanes' own counts (the JAX while_loop's)."""
    (m, s, g), (mt, st, gt) = species
    n = 16
    E, pl, pt, T = _targets(n, 7, m, s, g)
    pl[3] = -0.01                # bad input: fails at once
    pt[8] = 3.0 * E[8]           # no HRG state has it
    E[12] = 0.25                 # the cells' padding values
    pl[12] = pt[12] = 0.08
    T[12] = 0.15
    one = np.ones(n)
    ours = aniso.find_anisotropic_variables(_t(E), _t(pl), _t(pt), _t(T),
                                            _t(one), _t(one), mt, st, gt)
    ref = ja.find_anisotropic_variables(E, pl, pt, T, one, one, m, s, g)
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    assert ours.failed[3] and ours.failed[8] and not ours.failed[12]
    for k in ("lam", "aT", "aL"):
        assert _rel(getattr(ours, k), getattr(ref, k)) <= ANISO_TOL, k
    each = [aniso.find_anisotropic_variables(
        _t(E[i:i + 1]), _t(pl[i:i + 1]), _t(pt[i:i + 1]), _t(T[i:i + 1]),
        _t(one[:1]), _t(one[:1]), mt, st, gt).iterations for i in range(n)]
    assert ours.iterations == max(each) and each[3] == 0
    assert ours.iterations > int(np.median(each))
    # the Newton iterates each lane until it is done, and no further
    assert ours.lane_iterations == sum(each)


def test_equilibrium_fixed_point(workdir, species):
    """For HRG-consistent (E, P, P) the solution is (lambda = T, aT = aL =
    1) (tests/test_aniso.py::test_equilibrium_fixed_point on the synthetic
    list; E and P come from the whole list, the solver sees <= 320)."""
    _, (mt, st, gt) = species
    surf = eos_surface(workdir, 16, seed=5, shear_scale=0.0, bulk_scale=0.0)
    E, P, T = _t(surf.E), _t(surf.P), _t(surf.T)
    one = torch.ones(16, dtype=torch.float64)
    sol = aniso.find_anisotropic_variables(E, P, P, T, one, one, mt, st, gt)
    assert not sol.failed.any()
    assert torch.allclose(sol.aT, one, atol=0.05)
    assert torch.allclose(sol.aL, one, atol=0.05)
    assert torch.allclose(sol.lam, T, rtol=0.05)
    X = torch.stack([sol.lam, sol.aT, sol.aL], dim=-1)
    assert float(aniso.compute_F(X, E, P, P, mt, st, gt).abs().max()) < 1e-4


def test_famod_coefficients_isotropic_limit(species):
    """aT = aL: beta_piperp = beta_Wperp (both reduce to one integral)."""
    _, (mt, st, gt) = species
    lam = _t([0.15, 0.12])
    one = torch.ones(2, dtype=torch.float64)
    bpp, bwp = aniso.compute_famod_coefficients(lam, one, one, mt, st, gt)
    torch.testing.assert_close(bpp, bwp, rtol=1e-12, atol=0)
    assert bool((bpp > 0).all())


def test_anisotropic_solution_consistency(species):
    """Anisotropic targets: a small residual, and pt > pl gives aT > aL."""
    _, (mt, st, gt) = species
    E, pl, pt = _t([0.3]), _t([0.06]), _t([0.09])
    one = torch.ones(1, dtype=torch.float64)
    sol = aniso.find_anisotropic_variables(E, pl, pt, _t([0.15]), one, one,
                                           mt, st, gt)
    assert not bool(sol.failed[0])
    X = torch.stack([sol.lam, sol.aT, sol.aL], dim=-1)
    assert float(aniso.compute_F(X, E, pt, pl, mt, st, gt).abs().max()) < 1e-4
    assert float(sol.aT[0]) > float(sol.aL[0])


# ----------------------------------------------------------------------
# core/spectra_famod.py
# ----------------------------------------------------------------------

def _assert_prep_equal(fm, j_fm):
    for f in dataclasses.fields(fm):
        ours, ref = getattr(fm, f.name).numpy(), np.asarray(getattr(j_fm,
                                                                    f.name))
        if ours.dtype == bool:
            np.testing.assert_array_equal(ours, ref, err_msg=f.name)
        else:
            assert _rel(ours, ref) <= PREP_TOL, f.name


def test_prepare_famod_matches_jax(workdir, famod):
    st = famod
    cfg = port_config(st.cfg)
    stats = sf.Reconstruction()
    fm = sf.prepare_famod(st.cells, read_pdg(3, workdir / "PDG"), cfg,
                          stats=stats)
    _assert_prep_equal(fm, st.j_fm)
    live = st.cells.mask > 0
    assert int((fm.breaks_down & live).sum()) > 0
    assert int((fm.recon_failed & live).sum()) > 0
    assert int((fm.pl_negative & live).sum()) > 0
    assert stats.newton_iterations > 1 and stats.blocks == 1


def test_prepare_famod_from_vah_variables_matches_jax(workdir, famod):
    """A mode-3 surface's (Lambda, aT, aL, upsilonB): no Newton."""
    st = famod
    cfg = port_config(st.cfg)
    surf = dataclasses.replace(st.surf)
    n = surf.n_cells
    rng = np.random.default_rng(4)
    surf.Lambda = np.asarray(st.j_fm.lam)[:n] * rng.uniform(0.98, 1.02, n)
    surf.aT = np.array(st.j_fm.aT)[:n]
    surf.aL = np.array(st.j_fm.aL)[:n]
    surf.upsilonB = rng.uniform(0.0, 0.02, n)
    surf.aL[::50] = -1.0         # a non-positive variable fails
    j_fm = j_prepare_famod(st.j_cells, st.j_species_table, st.cfg,
                           j_vah_from_surface(surf, st.j_cells.n_padded))
    stats = sf.Reconstruction()
    fm = sf.prepare_famod(st.cells, read_pdg(3, workdir / "PDG"), cfg,
                          sf.vah_from_surface(surf, st.cells.n_padded, "cpu"),
                          stats)
    _assert_prep_equal(fm, j_fm)
    assert int(fm.recon_failed[:n].sum()) == len(range(0, n, 50))
    assert stats.newton_iterations == 0


@pytest.mark.parametrize("outflow", [0, 1])
def test_f64_engine_matches_jax(famod, outflow):
    st = famod
    cfg = dataclasses.replace(st.cfg, outflow=outflow)
    ref = np.asarray(_spectra_famod_jit(st.j_cells, st.j_fm, st.j_species,
                                        st.j_grid, cfg,
                                        st.j_cells.n_padded // BLOCK))
    out = sf.spectra_famod(st.cells, st.fm, st.species, st.grid,
                           port_config(cfg)).numpy()
    assert max_rel_err(out, ref) <= PREP_TOL


@pytest.mark.parametrize("outflow", [0, 1])
def test_plain_kernel_vs_f64_famod_engine(famod, outflow):
    """B3's famod plain version (the f32 route on the CPU) on the real
    famod prep against the port's f64 engine: the JAX famod kernel's bar
    (tests/test_pallas_kernel.py: err < 1e-4)."""
    st = famod
    cfg = port_config(dataclasses.replace(st.cfg, outflow=outflow,
                                          compute_dtype="f32"))
    ref = sf.spectra_famod(st.cells, st.fm, st.species, st.grid, cfg).numpy()
    ops = fk.famod_operands(st.cells, st.fm, st.species, st.grid, cfg)
    assert ops.kind == "famod" and ops.eta.shape[0] == 12   # folded
    out = fk.compute_spectra_famod_kernel(st.cells, st.fm, st.species,
                                          st.grid, cfg).numpy()
    assert max_rel_err(out, ref) <= 1e-4


def test_famod_operands_refuse_other_modes(famod):
    st = famod
    cfg = port_config(dataclasses.replace(st.cfg, df_mode=4))
    with pytest.raises(ValueError, match="famod mode implements 2\\+1d df 5"):
        fk.famod_operands(st.cells, st.fm, st.species, st.grid, cfg)


# ----------------------------------------------------------------------
# the CLI, the report and the configuration
# ----------------------------------------------------------------------

def _famod_lines(out: str) -> list:
    keys = ("famod breaks down", "pl went negative",
            "Number of reconstruction failures")
    return [ln for ln in out.splitlines() if ln.startswith(keys)]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_port_cli_matches_jax_driver_df5(tmp_path, capsys, dtype):
    """df 5 through both CLIs on one EOS-consistent workdir where cells
    break down: the same famod report lines; f64 in memory <= 1e-10; the
    port's f32 route (kernel B3's famod plain version) against the JAX f64
    route <= 1e-4 (the JAX f32 route runs its XLA feqmod fast path, ROADMAP
    C7)."""
    wd = build_workdir(tmp_path / "jax", params={"df_mode": 5,
                                                 "compute_dtype": "f64",
                                                 "cell_block": BLOCK},
                       eos_consistent=True, shear_scale=0.1,
                       bulk_scale=0.05)
    port_wd = tmp_path / "port"
    shutil.copytree(wd, port_wd)
    p = port_wd / "iS3D_parameters.dat"
    p.write_text(p.read_text().replace("compute_dtype = f64",
                                       f"compute_dtype = {dtype}"))
    ref = JIS3D(wd)
    ref.run_particlization()
    ref_lines = _famod_lines(capsys.readouterr().out)
    run = IS3D(port_wd, device="cpu")   # what cli.main runs
    run.run_particlization()
    out = capsys.readouterr().out
    assert _famod_lines(out) == ref_lines and len(ref_lines) == 3
    assert int(ref_lines[0].split()[4]) > 0
    assert "Newton iterations" in out and "famod_prep" in out
    err = max_rel_err(run.spectra, np.asarray(ref.spectra))
    assert err <= (1e-10 if dtype == "f64" else 1e-4), f"{dtype}: {err:.3e}"


def test_report_famod_lines_match_jax(famod):
    st = famod
    ours, ref = RunReport(n_cells=500), JRunReport(n_cells=500)
    ours.record_breakdown(st.fm.breaks_down, st.cells.tau, st.cells.mask,
                          pl_negative=st.fm.pl_negative,
                          recon_failed=st.fm.recon_failed)
    ref.record_breakdown(st.j_fm.breaks_down, st.j_cells.tau,
                         st.j_cells.mask, pl_negative=st.j_fm.pl_negative,
                         recon_failed=st.j_fm.recon_failed)
    assert ours.pl_negative_cells > 0 and ours.reconstruction_failures > 0
    assert ours.lines() == ref.lines()
    ours.reconstruction = sf.Reconstruction(1.5, 7, 2, 9000)
    assert ours.lines()[-1] == ("famod reconstruction: 1.500 s, 7 Newton "
                                "iterations (2 cell blocks, 9000 "
                                "cell-iterations)")


@pytest.mark.parametrize("kw", [
    {}, {"compute_dtype": "f32"}, {"compute_dtype": "f32c"},
    {"compute_dtype": "f64", "use_pallas": 1}, {"mode": 2}, {"mode": 3},
    {"operation": 2}, {"operation": 2, "fast": 0, "compute_dtype": "f32"},
])
def test_validate_slice_lets_df5_through(kw):
    Config(df_mode=5, **kw).validate_slice()


@pytest.mark.parametrize("kw", [{"mode": 5, "dimension": 3}])
def test_validate_slice_lets_df5_on_a_3d_mode5_surface_through(kw):
    """df 5 on a 3+1d mode-5 surface: B3's 3+1d famod mode, then the
    polarization, which no df mode enters."""
    Config(**{"df_mode": 5, **kw}).validate_slice()


@pytest.mark.parametrize("kw,item", [
    # df 5 under a mesh: rejected until ROADMAP ``item`` (parallel/) was
    # ported
    ({"mode": 2, "use_mesh": 1}, "A12"),
    ({"operation": 2, "mode": 5, "use_mesh": 1}, "A12"),
])
def test_validate_slice_rejects_the_df5_corners(kw, item):
    """With the mesh ported these validate; the df-5 corner left is the
    JAX package's: operation 0 (no spacetime routine for famod)."""
    Config(**{"df_mode": 5, **kw}).validate_slice()
    with pytest.raises(ValueError, match="famod"):
        Config(**{"df_mode": 5, **kw, "operation": 0}).validate_slice()


@pytest.mark.parametrize("dtype", ["f32", "f32c"])
def test_use_pallas0_runs_the_famod_mode(tmp_path, dtype):
    """df 5 with use_pallas = 0 and f32/f32c (the JAX package's XLA famod
    fast path; ROADMAP A9b) validates and runs B3's famod mode, its plain
    version here: the spectra of use_pallas = -1, bit for bit."""
    Config(df_mode=5, compute_dtype=dtype, use_pallas=0).validate_slice()
    off, auto = port_spectra_by_use_pallas(tiny_workdir(tmp_path, 5, dtype))
    assert np.isfinite(off).all() and off.any()
    np.testing.assert_array_equal(off, auto)


def test_df5_takes_the_chapman_enskog_coefficients(workdir):
    tables = DeltafTables.load(3, False, workdir / "deltaf_coefficients/vh")
    jt = JTables.load(3, False, workdir / "deltaf_coefficients/vh")
    T = np.linspace(0.13, 0.17, 9)
    E, P, Pi = 0.3 + 0 * T, 0.1 + 0 * T, 0.01 + 0 * T
    d5 = DeltafData(tables, 5, False).evaluate(_t(T), _t(0 * T), _t(E),
                                               _t(P), _t(Pi))
    d2 = DeltafData(tables, 2, False).evaluate(_t(T), _t(0 * T), _t(E),
                                               _t(P), _t(Pi))
    j5 = JDeltafData(jt, 5, False).evaluate(T, 0 * T, E, P, Pi)
    for k in ("F", "betabulk", "betapi", "betaV"):
        torch.testing.assert_close(getattr(d5, k), getattr(d2, k), rtol=0,
                                   atol=0)
        assert _rel(getattr(d5, k), getattr(j5, k)) <= ANISO_TOL, k


# ----------------------------------------------------------------------
# the legacy VAH readers (modes 2/3)
# ----------------------------------------------------------------------

_VAH_FIELDS = ("PL", "PT", "Wt", "Wx", "Wy", "Wn", "Lambda", "aT", "aL",
               "upsilonB")


def _assert_surfaces_equal(ours, ref):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert ours.has_aniso_variables and ref.has_aniso_variables


def test_vah_readers_match_jax(workdir, tmp_path):
    surf = eos_surface(workdir, 64, seed=13)
    rng = np.random.default_rng(2)
    f2, f3 = tmp_path / "mode2.dat", tmp_path / "mode3.dat"
    write_mode2(surf, f2, pl=surf.P * rng.uniform(0.6, 1.4, 64))
    write_mode3(surf, f3, surf.T * rng.uniform(0.95, 1.05, 64),
                rng.uniform(0.8, 1.2, 64), rng.uniform(0.8, 1.2, 64),
                pl=0.8 * surf.P, pt=1.1 * surf.P)
    for f, mode in ((f2, 2), (f3, 3)):
        ours = p_surface.read_surface(f, mode, 2, False)
        ref = j_surface.read_surface(f, mode, 2, False)
        _assert_surfaces_equal(ours, ref)
    np.testing.assert_array_equal(p_surface.aL_fit(np.linspace(0.2, 2.5, 40)),
                                  j_surface.aL_fit(np.linspace(0.2, 2.5, 40)))
    aL = np.linspace(0.3, 3.0, 40)
    np.testing.assert_array_equal(p_surface.R200(aL), j_surface.R200(aL))
    s2 = p_surface.read_surface(f2, 2, 2, False)
    assert (s2.Lambda > 0).all() and (s2.aT == 1.0).all()


def test_mode3_roundtrip_matches_reconstruction(workdir, tmp_path):
    """A mode-3 surface carrying the solver's own (Lambda, aT, aL) gives the
    famod spectra of the reconstruction (the port's own version of
    tests/test_surface_vah.py::test_mode3_roundtrip_matches_reconstruction,
    < 1e-10; f64 engine)."""
    table = read_pdg(3, workdir / "PDG")
    grids = MomentumGrids.from_dir(workdir / "tables")
    chosen = table.chosen_indices(
        load_table(workdir / "PDG/chosen_particles.dat")[:, 0].astype(int))
    df_data = DeltafData(DeltafTables.load(3, False,
                                           workdir / "deltaf_coefficients/vh"),
                         5, False)
    surf = eos_surface(workdir, 64, seed=13, shear_scale=0.02,
                       bulk_scale=0.005)
    cfg = Config(operation=1, df_mode=5, include_shear_deltaf=1,
                 include_bulk_deltaf=1, cell_block=64)
    ref = compute_spectra(surf, table, chosen, grids, df_data, cfg, "cpu")
    fm = sf.prepare_famod(sf.famod_cells(surf, cfg, "cpu"), table, cfg)
    n = surf.n_cells
    f = tmp_path / "surface_mode3.dat"
    write_mode3(surf, f, fm.lam.numpy()[:n], fm.aT.numpy()[:n],
                fm.aL.numpy()[:n])
    surf3 = p_surface.read_surface(f, 3, 2, False)
    assert surf3.has_aniso_variables
    np.testing.assert_allclose(surf3.Lambda, fm.lam.numpy()[:n], rtol=1e-12)
    np.testing.assert_allclose(surf3.pixy, surf.pixy, rtol=1e-12)
    out = compute_spectra(surf3, table, chosen, grids, df_data,
                          dataclasses.replace(cfg, mode=3), "cpu")
    sig = np.abs(ref) > 1e-9 * np.abs(ref).max()
    rel = (np.abs(out - ref) / np.maximum(np.abs(ref), 1e-300))[sig].max()
    assert rel < 1e-10, f"mode-3 roundtrip err {rel:.2e}"


def test_port_cli_runs_mode2_and_mode3_surfaces(tmp_path):
    """Operation 1 with df 5 on written mode-2 and mode-3 workdirs
    (write_workdir(surface_mode=...)) through the CLI, f32 route."""
    for mode in (2, 3):
        wd = build_workdir(tmp_path / f"m{mode}",
                           params={"df_mode": 5, "compute_dtype": "f32",
                                   "cell_block": BLOCK},
                           eos_consistent=True, surface_mode=mode,
                           shear_scale=0.05, bulk_scale=0.02)
        assert "mode = %d" % mode in (wd / "iS3D_parameters.dat").read_text()
        assert cli.main([str(wd), "--device", "cpu"]) == 0
        dndy = {m: float(np.loadtxt(wd / f"results/continuous/dN_dy_{m}.dat")[1])
                for m in (211, 321, 2212)}
        assert dndy[211] > dndy[321] > dndy[2212] > 0, mode


def test_port_runs_df5_without_jax(tmp_path):
    """df 5, operations 1 (f32: kernel B3's famod plain version) and 2, in
    a fresh process: never imports jax or the JAX package."""
    kw = dict(n_cells=BLOCK, chosen_mcids=CHOSEN, n_pT=8, n_phi=8, n_eta=8,
              n_T=21, eos_consistent=True, shear_scale=0.1, bulk_scale=0.05)
    wd1 = write_workdir(tmp_path / "op1", params={
        "df_mode": 5, "compute_dtype": "f32", "cell_block": BLOCK}, **kw)
    wd2 = write_workdir(tmp_path / "op2", params={
        "df_mode": 5, "operation": 2, "min_num_hadrons": 2e4,
        "sampler_seed": 3, "cell_block": BLOCK}, **kw)
    code = (
        "import sys\n"
        "from is3d2_tpu_torch import cli\n"
        "from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk\n"
        "calls = []\n"
        "plain = fk.cooper_frye_feqmod_plain\n"
        "fk.cooper_frye_feqmod_plain = "
        "lambda *a: calls.append(a[-1]) or plain(*a)\n"
        f"cli.main([{str(wd1)!r}, '--device', 'cpu'])\n"
        "assert calls == ['famod'], calls\n"
        f"cli.main([{str(wd2)!r}, '--device', 'cpu'])\n"
        "assert calls == ['famod'], calls\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'is3d2_tpu' or m.startswith('is3d2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert proc.stdout.count("Newton iterations") == 2
    assert "sampled hadrons:" in proc.stdout
