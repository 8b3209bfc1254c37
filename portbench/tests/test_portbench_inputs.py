"""The frozen input generators give the same bits as the port's
synthetic-workdir builder and delta-f table generator for the same seed."""

import numpy as np
import pytest

from is3d2_tpu_torch.config import Config
from is3d2_tpu_torch.core.spectra_famod import (Reconstruction, famod_cells,
                                                lrf_pressures, reconstruct,
                                                solver_species)
from is3d2_tpu_torch.io.pdg import SpeciesTable, read_pdg_smash_box
from is3d2_tpu_torch.io.surface import SurfaceData
from is3d2_tpu_torch.io.tables import GaussLaguerre
from is3d2_tpu_torch.tools import generate_deltaf_tables as port_tables
from is3d2_tpu_torch.tools import synthetic
from portbench.harness import inputs, manifest

SURFACE_CASES = [(2, 0.02, 0.01, 3), (3, 0.2, 0.1, 12345),
                 (2, 0.02, 0.01, 2**33 + 5), (3, 0.2, 0.1, [2**31 + 7, 1])]


def _species_table(tmp_path) -> SpeciesTable:
    (tmp_path / "pdg_box.dat").write_text(
        "\n".join(inputs.pdg_box_lines(370)) + "\n")
    return SpeciesTable.from_species(read_pdg_smash_box(tmp_path / "pdg_box.dat"))


@pytest.mark.parametrize("dimension,shear,bulk,seed", SURFACE_CASES)
def test_make_surface_bits(dimension, shear, bulk, seed):
    ours = inputs.make_surface(257, seed, dimension, shear, bulk)
    theirs = synthetic.make_surface(257, seed=seed, dimension=dimension,
                                    shear_scale=shear, bulk_scale=bulk)
    for f in inputs.SURFACE_FIELDS:
        assert np.array_equal(ours[f], getattr(theirs, f)), f


def test_pdg_lines_and_species(tmp_path):
    lines = inputs.pdg_box_lines(370)
    assert lines == synthetic.pdg_box_lines(370)
    (tmp_path / "pdg_box.dat").write_text("\n".join(lines) + "\n")
    table = SpeciesTable.from_species(read_pdg_smash_box(tmp_path / "pdg_box.dat"))
    ours = inputs.species_of_lines(lines)
    assert len(ours["mc_id"]) == 371
    for k in ("mc_id", "mass", "gspin", "sign", "baryon"):
        assert np.array_equal(ours[k], getattr(table, k)), k


def test_quadrature_files(tmp_path):
    inputs.write_quadrature_tables(tmp_path / "a", 51, 48, 24, n_y=21)
    synthetic.write_quadrature_tables(tmp_path / "b", 51, 48, 24, n_y=21)
    files = sorted(p.relative_to(tmp_path / "a")
                   for p in (tmp_path / "a").rglob("*.dat"))
    files += [p.relative_to(tmp_path / "a")
              for p in (tmp_path / "a").rglob("*.txt")]
    assert len(files) == 6
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f


def test_deltaf_tables(tmp_path):
    lines = inputs.pdg_box_lines(370)
    (tmp_path / "pdg_box.dat").write_text("\n".join(lines) + "\n")
    table = SpeciesTable.from_species(read_pdg_smash_box(tmp_path / "pdg_box.dat"))
    ours = inputs.compute_tables(inputs.species_of_lines(lines), n_T=11, n_muB=3)
    theirs = port_tables.compute_tables(table, n_T=11, n_muB=3)
    assert set(ours) == set(theirs)
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    inputs.write_tables(ours, tmp_path / "a")
    port_tables.write_tables(theirs, tmp_path / "b")
    for p in sorted((tmp_path / "a").iterdir()):
        assert p.read_bytes() == (tmp_path / "b" / p.name).read_bytes()


@pytest.mark.parametrize("dimension,shear,bulk,seed", SURFACE_CASES)
def test_make_eos_consistent_bits(tmp_path, dimension, shear, bulk, seed):
    drawn = inputs.make_surface(257, seed, dimension, shear, bulk)
    ours = inputs.make_eos_consistent(
        inputs.make_surface(257, seed, dimension, shear, bulk),
        inputs.species_of_lines(inputs.pdg_box_lines(370)))
    synthetic.write_quadrature_tables(tmp_path, 51, 48, 24)
    theirs = synthetic.make_eos_consistent(
        synthetic.make_surface(257, seed=seed, dimension=dimension,
                               shear_scale=shear, bulk_scale=bulk),
        _species_table(tmp_path),
        GaussLaguerre.from_file(tmp_path / "tables/gauss/gla_roots_weights.txt"))
    for f in ("E", "P"):
        assert np.array_equal(ours[f], getattr(theirs, f)), f
        assert not np.array_equal(ours[f], drawn[f]), f
    for f in inputs.SURFACE_FIELDS:
        if f not in ("E", "P"):
            assert np.array_equal(ours[f], drawn[f]), f


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_accepted_cells_keep_their_surfaces(cell):
    bench = manifest.load()
    wl = manifest.workload(bench, cell)
    traffic = manifest.traffic(wl["traffic"])
    cfg = manifest.effective(manifest.config(bench, wl["config"]), traffic)
    inp = cfg["inputs"]
    count = traffic["distinct_surfaces"]
    got = inputs.make_surfaces(cfg, 2**31 + 11, count)
    assert len(got) == count
    for k, s in enumerate(got):
        drawn = inputs.make_surface(inp["n_cells"], [2**31 + 11, k],
                                    dimension=inp["dimension"],
                                    shear_scale=inp["shear_scale"],
                                    bulk_scale=inp["bulk_scale"])
        for f in inputs.SURFACE_FIELDS:
            assert np.array_equal(s[f], drawn[f]), (k, f)


@pytest.mark.parametrize("seed", [3, 12345, 2**33 + 5])
def test_eos_consistent_surfaces_reconstruct(tmp_path, seed):
    """df 5's Newton reconstructs (Lambda, aT, aL) on nearly every live
    cell of an EOS-consistent surface, and fails on a large share of the
    independently drawn one."""
    bench = manifest.load()
    base = manifest.config(bench, "box2d-grad")
    table = _species_table(tmp_path)
    share = {}
    for eos in (True, False):
        cfg = {**base, "inputs": {**base["inputs"], "n_cells": 256,
                                  "shear_scale": 0.1, "bulk_scale": 0.05,
                                  "eos_consistent": eos}}
        s = inputs.make_surfaces(cfg, seed, 1)[0]
        surf = SurfaceData.zeros(256)
        for f in inputs.SURFACE_FIELDS:
            setattr(surf, f, s[f])
        cells = famod_cells(surf, Config(df_mode=5, cell_block=256), "cpu")
        _, _, pl, pt = lrf_pressures(cells)
        out = reconstruct(cells.E, pl, pt, cells.T,
                          *solver_species(table, "cpu"), Reconstruction())
        live = cells.mask > 0
        share[eos] = float((out["failed"] & live).sum() / live.sum())
    assert share[True] <= 0.03, share
    assert share[False] >= 0.20, share
