"""The frozen input generators give the same bits as the port's
synthetic-workdir builder and delta-f table generator for the same seed."""

import numpy as np
import pytest

from is3d2_tpu_torch.io.pdg import SpeciesTable, read_pdg_smash_box
from is3d2_tpu_torch.tools import generate_deltaf_tables as port_tables
from is3d2_tpu_torch.tools import synthetic
from portbench.harness import inputs


@pytest.mark.parametrize("dimension,shear,bulk,seed", [
    (2, 0.02, 0.01, 3), (3, 0.2, 0.1, 12345), (2, 0.02, 0.01, 2**33 + 5),
    (3, 0.2, 0.1, [2**31 + 7, 1])])
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
