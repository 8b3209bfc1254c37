"""group_particles against the JAX package.

  * SpeciesTable.chosen_indices(group_by_mass) and group_species: equal
    arrays on the synthetic 371-species list at three tolerances, with and
    without the baryon key;
  * the grouped op-1 spectra of the port's driver against the JAX driver's
    grouped spectra, species compared by MC ID: the f64 engines <= 1e-10;
    kernel B1's route (f32c) <= 1e-6, B2's (f64 with use_pallas = 1)
    <= 2e-5 and B3's (f32, df 3/4 and famod) <= 1e-4 against the JAX f64
    route, the kernels' own bars; on bins >= 1e-4 of each species' peak;
  * species whose (mass, sign, baryon) equal their representative's come
    out of the grouped run as in the ungrouped one (<= 1e-12: only the
    cell sums' order differs), and every species is as far from its
    ungrouped spectra as the JAX package's grouping puts it (the
    grouping's own error, the same to 1e-9);
  * operation 2 with group_particles = 1 on a mode-6 surface: the JAX
    sampler's mass-sorted species order, yield estimate and event count,
    its yield bound, and per-species dN/dy histograms that agree with the
    JAX sampler's.
"""

import contextlib
import dataclasses
import io
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import chi2_p, max_rel_err, run_drivers  # noqa: E402

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402
from is3d2_tpu.io import pdg as j_pdg  # noqa: E402

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import pdg  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)

# pi0 pi+ pi- within 5 MeV; the four Deltas and the three Sigma*s share a
# mass, sign and baryon number; K+ K0 within 4 MeV; p n within 1.3 MeV;
# antiprotons share the proton's mass and sign, not its baryon number
CHOSEN = (2212, 211, -211, 111, 321, 311, -2212, 2112, 2224, 2214, 2114,
          1114, 3224, 3214, 3114, 3122)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("group_pdg")
    (root / "pdg_box.dat").write_text("\n".join(synthetic.pdg_box_lines())
                                      + "\n")
    return (pdg.read_pdg_smash_box(root / "pdg_box.dat"),
            j_pdg.read_pdg_smash_box(root / "pdg_box.dat"))


# (tolerance, key_baryon) -> representatives on the 371-species list; the
# main path (no baryon chemistry) groups without the baryon key
@pytest.mark.parametrize("tolerance,key_baryon,n_reps", [
    (0.01, False, 94), (1e-3, False, 150), (1e-6, False, 160),
    (0.01, True, 125), (1e-3, True, 207), (1e-6, True, 220)])
def test_group_species_matches_jax(tables, tolerance, key_baryon, n_reps):
    ours = pdg.SpeciesTable.from_species(tables[0])
    ref = j_pdg.SpeciesTable.from_species(tables[1])
    assert len(ours) == 371
    mcids = ours.mc_id[::-1]          # not in mass order
    idx = ours.chosen_indices(mcids, group_by_mass=True)
    np.testing.assert_array_equal(
        idx, ref.chosen_indices(mcids, group_by_mass=True))
    assert (np.diff(ours.mass[idx]) >= 0).all()
    rep, group_of = ours.group_species(idx, tolerance, key_baryon)
    j_rep, j_group_of = ref.group_species(idx, tolerance, key_baryon)
    np.testing.assert_array_equal(rep, j_rep)
    np.testing.assert_array_equal(group_of, j_group_of)
    assert len(rep) == n_reps


def _workdir(root: Path, params: dict, **kw) -> Path:
    args = dict(n_cells=384, seed=3, chosen_mcids=CHOSEN, n_pT=12, n_phi=8,
                n_T=21)
    args.update(kw)
    return synthetic.write_workdir(root, params={"cell_block": 128,
                                                 **params}, **args)


def _mcids(run) -> list[int]:
    return [int(run.species.mc_id[i]) for i in run.chosen_idx]


# name -> (config fields, bar against the JAX f64 route, write_workdir kw)
GROUPED_CASES = {
    "df1-f64": ({"df_mode": 1, "compute_dtype": "f64"}, 1e-10, {}),
    "df2-f32c-B1": ({"df_mode": 2, "compute_dtype": "f32c"}, 1e-6, {}),
    "df1-f64-B2": ({"df_mode": 1, "compute_dtype": "f64", "use_pallas": 1},
                   2e-5, {}),
    "df4-f64": ({"df_mode": 4, "compute_dtype": "f64"}, 1e-10,
                {"shear_scale": 0.2, "bulk_scale": 0.1}),
    "df3-f32-B3": ({"df_mode": 3, "compute_dtype": "f32"}, 1e-4,
                   {"shear_scale": 0.2, "bulk_scale": 0.1}),
    "df5-f32-B3": ({"df_mode": 5, "compute_dtype": "f32"}, 1e-4,
                   {"eos_consistent": True, "shear_scale": 0.1,
                    "bulk_scale": 0.05}),
    "df1-f32c-baryons": ({"df_mode": 1, "compute_dtype": "f32c",
                          "include_baryon": 1,
                          "include_baryondiff_deltaf": 1}, 5e-6,
                         {"include_baryon": True, "n_muB": 9}),
}


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_spectra_match_the_jax_driver(tmp_path, case):
    params, bar, kw = GROUPED_CASES[case]
    wd = _workdir(tmp_path / "wd", {**params, "group_particles": 1}, **kw)
    ref, ours = run_drivers(wd)
    assert _mcids(ours) == _mcids(ref)     # the mass-sorted order
    assert [int(m) for m in ref.species.mc_id[ref.chosen_idx]] != \
        list(CHOSEN)
    err = max_rel_err(ours.spectra, np.asarray(ref.spectra))
    assert err <= bar, f"{case}: {err:.3e}"


@pytest.mark.parametrize("params,bar", [
    ({"df_mode": 1, "compute_dtype": "f32c"}, 1e-6),
    ({"df_mode": 4, "compute_dtype": "f32"}, 1e-4)])
def test_grouping_error_is_the_jax_packages(tmp_path, params, bar):
    """Grouped against ungrouped, on one workdir, in each package: the
    exact multiplets agree to 1e-12, and every species is off by the JAX
    package's grouping error (on its f64 route) give or take twice the
    route's bar ``bar``."""
    kw = {"shear_scale": 0.2, "bulk_scale": 0.1} \
        if params["df_mode"] == 4 else {}
    wd = _workdir(tmp_path / "wd", {**params, "group_particles": 1}, **kw)
    ref_g, ours_g = run_drivers(wd)
    ref_u, ours_u = run_drivers(wd, group_particles=0)
    table = ours_g.species
    idx = ours_g.chosen_idx
    order_u = _mcids(ours_u)
    assert _mcids(ref_u) == order_u == list(CHOSEN)
    rep, group_of = table.group_species(idx, ours_g.cfg.particle_diff_tolerance,
                                        False)
    assert len(rep) < len(idx)
    key = np.stack([table.mass, table.sign, table.baryon], axis=1)
    n_exact = 0
    for pos, m in enumerate(_mcids(ours_g)):
        u = order_u.index(m)
        ours_err = max_rel_err(ours_g.spectra[pos:pos + 1],
                               ours_u.spectra[u:u + 1])
        jax_err = max_rel_err(np.asarray(ref_g.spectra)[pos:pos + 1],
                              np.asarray(ref_u.spectra)[u:u + 1])
        if (key[idx[pos]] == key[idx[rep[group_of[pos]]]]).all():
            n_exact += 1
            assert ours_err <= 1e-12 and jax_err <= 1e-12, m
        assert abs(ours_err - jax_err) <= 2 * bar, (m, ours_err, jax_err)
    # the representatives, 3 more Deltas and 2 more Sigma*s
    assert n_exact == len(rep) + 5


def test_operation2_grouped_on_a_mode6_surface(tmp_path):
    wd = synthetic.write_workdir(
        tmp_path / "wd", n_cells=60, seed=3, chosen_mcids=(2212, 321, 211),
        n_pT=16, n_phi=8, n_T=21, shear_scale=0.03, surface_mode=6,
        dan_scale=0.05, params={"operation": 2, "df_mode": 1,
                                "group_particles": 1, "test_sampler": 1,
                                "min_num_hadrons": 4.0e4, "pT_bins": 30,
                                "y_bins": 20})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref = JIS3D(wd)
        ref.run_particlization(write=False)
        ours = IS3D(wd, device="cpu")
        ours.run_particlization(write=False)
    assert _mcids(ours) == _mcids(ref) == [211, 321, 2212]
    assert ours.n_events == ref.n_events
    log = out.getvalue()
    yields = [int(line.split()[5]) for line in log.splitlines()
              if line.startswith("Estimated total particle yield")]
    assert len(yields) == 2 and abs(yields[0] - yields[1]) <= 1
    kept = ours.sampler_diags["kept"]
    Ntot = yields[1]
    n = ours.n_events
    assert abs(kept / n - Ntot) < 0.05 * Ntot + 5 * np.sqrt(Ntot / n)
    for i, m in enumerate(_mcids(ours)):
        p, chi2, dof = chi2_p(ours.histograms.dN_dy[i],
                              np.asarray(ref.histograms.dN_dy)[i])
        assert p > 1e-3, (m, chi2, dof)


def test_the_grouping_bar_of_the_chip_check(tmp_path):
    """chip_smoke.py phase 17 holds every species of the grouped main path
    (all 371 species, tolerance 0.01) to GROUP_BAR against its ungrouped
    run.  The bar is the grouping's own error, which this measures with
    the JAX package on the same synthetic list and surface generator (512
    cells, 12 pT x 8 phi, pT to 3 GeV): the port's grouped spectra are as
    far from its ungrouped ones as the JAX package's (B1's f32c route
    against the JAX f32c route, within 1e-5), and both stay under the bar."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    wd = synthetic.write_workdir(
        tmp_path / "wd", n_cells=512, seed=3, n_pT=12, n_phi=8, n_T=21,
        surface_mode=6, params={"df_mode": 1, "compute_dtype": "f32c",
                                "cell_block": 512})
    path = wd / "iS3D_parameters.dat"
    errs = {}
    for name, make, config in (("jax", JIS3D, JConfig),
                               ("port", partial(IS3D, device="cpu"), Config)):
        runs = []
        for grouped in (0, 1):
            run = make(wd, cfg=dataclasses.replace(config.from_file(path),
                                                   group_particles=grouped))
            with contextlib.redirect_stdout(io.StringIO()):
                run.run_particlization(write=False)
            runs.append(run)
        order = _mcids(runs[0])
        errs[name] = np.array([
            max_rel_err(np.asarray(runs[1].spectra)[p:p + 1],
                        np.asarray(runs[0].spectra)[order.index(m):
                                                    order.index(m) + 1])
            for p, m in enumerate(_mcids(runs[1]))])
    print(f"grouping error, JAX package: {errs['jax'].max():.4f}; port: "
          f"{errs['port'].max():.4f}; bar {chip_smoke.GROUP_BAR}")
    assert len(errs["jax"]) == 371
    assert np.abs(errs["port"] - errs["jax"]).max() <= 1e-5
    assert 0.06 < errs["jax"].max() < chip_smoke.GROUP_BAR
