"""The port's readers, writers and synthetic builder against the JAX package.

Readers must return identical arrays on a synthetic workdir, and the op-1
writers identical bytes (the JAX writers go through the native block writer
when it builds, else their Python loop; both print with %.8e).
"""

import filecmp
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

import surfgen  # noqa: E402
from torch_parity import CHOSEN, build_workdir  # noqa: E402

from is3d2_tpu.io import output as j_output  # noqa: E402
from is3d2_tpu.io import pdg as j_pdg  # noqa: E402
from is3d2_tpu.io import surface as j_surface  # noqa: E402
from is3d2_tpu.io import tables as j_tables  # noqa: E402
from is3d2_tpu.io.deltaf_tables import DeltafTables as JTables  # noqa: E402

from is3d2_tpu_torch.io import output, pdg, surface, tables  # noqa: E402
from is3d2_tpu_torch.io.deltaf_tables import DeltafTables  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_io"),
                         include_baryon=True)


def _same_fields(a, b, names):
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(a, n)),
                                      np.asarray(getattr(b, n)), err_msg=n)


def test_pdg_reader_and_chosen_indices(workdir):
    ours = pdg.read_pdg(3, workdir / "PDG")
    ref = j_pdg.read_pdg(3, workdir / "PDG")
    _same_fields(ours, ref, ("mc_id", "mass", "gspin", "sign", "baryon"))
    assert len(ours) >= 370
    assert 0.134 < ours.mass.min() and ours.mass.max() <= 2.5
    chosen = tables.load_table(workdir / "PDG/chosen_particles.dat")[:, 0]
    np.testing.assert_array_equal(ours.chosen_indices(chosen),
                                  ref.chosen_indices(chosen))
    assert [int(m) for m in chosen] == list(CHOSEN)


def test_conventional_pdg_reader(tmp_path):
    text = ("211 pi+ 0.13957 0.0 1 0 0 0 0 3 1 1\n"
            "1 1 1.0 211 0 0 0 0\n"
            "2212 p 0.938 0.0 2 1 0 0 0 2 1 1\n"
            "1 1 1.0 2212 0 0 0 0\n"
            "2214 Delta+ 1.232 0.117 4 1 0 0 0 4 1 1\n"
            "1 2 1.0 2212 111 0 0 0\n")
    path = tmp_path / "pdg.dat"
    path.write_text(text)
    ours = pdg.read_pdg_conventional(path)
    ref = j_pdg.read_pdg_conventional(path)
    assert [vars(s) | {"decays": None} for s in ours] == \
        [vars(s) | {"decays": None} for s in ref]
    assert [[vars(d) for d in s.decays] for s in ours] == \
        [[vars(d) for d in s.decays] for s in ref]


def test_decode_mcid_on_the_synthetic_list(workdir):
    ids = {abs(int(m)) for m in pdg.read_pdg(3, workdir / "PDG").mc_id}
    for mcid in sorted(ids) + [1000010020]:
        assert pdg.decode_mcid(mcid) == j_pdg.decode_mcid(mcid)


def test_quadrature_and_momentum_tables(workdir):
    t = workdir / "tables"
    _same_fields(tables.GaussLaguerre.from_file(t / "gauss/gla_roots_weights.txt"),
                 j_tables.GaussLaguerre.from_file(t / "gauss/gla_roots_weights.txt"),
                 ("roots", "weights"))
    _same_fields(tables.GaussLegendre.from_file(t / "gauss/gauss_legendre.dat"),
                 j_tables.GaussLegendre.from_file(t / "gauss/gauss_legendre.dat"),
                 ("roots", "weights"))
    ours = tables.MomentumGrids.from_dir(t)
    _same_fields(ours, j_tables.MomentumGrids.from_dir(t),
                 ("pT", "pT_weight", "phi", "phi_weight", "y", "y_weight",
                  "eta", "eta_weight"))
    assert ours.pT.shape == (16,) and ours.phi.shape == (8,)
    assert ours.eta.shape == (24,)
    np.testing.assert_array_equal(ours.eta, -ours.eta[::-1])


@pytest.mark.parametrize("include_baryon", [False, True])
def test_deltaf_tables(workdir, include_baryon):
    base = workdir / "deltaf_coefficients/vh"
    _same_fields(DeltafTables.load(3, include_baryon, base),
                 JTables.load(3, include_baryon, base),
                 ("T_grid", "muB_grid", "c0", "c1", "c2", "c3", "c4", "F", "G",
                  "betabulk", "betaV", "betapi"))


@pytest.mark.parametrize("include_baryon", [False, True])
def test_mode1_surface_reader(workdir, tmp_path, include_baryon):
    path = tmp_path / "surface.dat"
    synthetic.write_mode1(synthetic.make_surface(64, seed=5,
                                                 include_baryon=include_baryon),
                          path, include_baryon=include_baryon)
    ours = surface.read_surface(path, 1, 2, include_baryon)
    ref = j_surface.read_surface(path, 1, 2, include_baryon)
    _same_fields(ours, ref, surface._FIELDS)
    a, b = ours.thermo_averages(), ref.thermo_averages()
    assert vars(a) == vars(b)
    a.write(tmp_path / "ours.dat")
    b.write(tmp_path / "ref.dat")
    assert filecmp.cmp(tmp_path / "ours.dat", tmp_path / "ref.dat",
                       shallow=False)
    # mode 5: the same columns and the thermal vorticity after them (drawn
    # last, so the other fields keep their bits)
    path5 = tmp_path / "surface5.dat"
    synthetic.write_mode1(synthetic.make_surface(
        64, seed=5, include_baryon=include_baryon, vorticity=True), path5,
        include_baryon=include_baryon, vorticity=True)
    ours5 = surface.read_surface(path5, 5, 2, include_baryon)
    _same_fields(ours5, j_surface.read_surface(path5, 5, 2, include_baryon),
                 surface._FIELDS)
    _same_fields(ours5, ours, [f for f in surface._FIELDS
                               if not f.startswith("w")])


@pytest.mark.parametrize("kw", [
    {}, {"seed": 7, "include_baryon": True},
    {"seed": 11, "dimension": 3, "vorticity": True, "shear_scale": 0.05},
])
def test_make_surface_is_bitwise_surfgen(kw, tmp_path):
    ours = synthetic.make_surface(200, **kw)
    ref = surfgen.make_surface(200, **kw)
    _same_fields(ours, ref, surface._FIELDS)
    baryon = kw.get("include_baryon", False)
    vort = kw.get("vorticity", False)
    synthetic.write_mode1(ours, tmp_path / "a.dat", baryon, vort)
    surfgen.write_mode1(ref, tmp_path / "b.dat", baryon, vort)
    assert filecmp.cmp(tmp_path / "a.dat", tmp_path / "b.dat", shallow=False)


def test_op1_writers_write_identical_bytes(workdir, tmp_path):
    grids = tables.MomentumGrids.from_dir(workdir / "tables")
    rng = np.random.default_rng(17)
    S = 3
    spectra = rng.lognormal(-3.0, 2.0, (S, grids.pT.shape[0],
                                        grids.phi.shape[0], 1))
    spectra[0, 0, 0, 0] = 0.0
    mcids = [211, -2212, 3122]
    writers = ("write_spectra", "write_vn", "write_dN_2pipTdpTdy",
               "write_dN_dphidy", "write_dN_dy")
    for name in writers:
        getattr(output, name)(tmp_path / "ours", mcids, spectra, grids, 2)
        getattr(j_output, name)(tmp_path / "ref", mcids, spectra, grids, 2)
    files = sorted(p.name for p in (tmp_path / "ref/continuous").iterdir())
    assert len(files) == S * len(writers)
    assert sorted(p.name for p in (tmp_path / "ours/continuous").iterdir()) == files
    for f in files:
        assert filecmp.cmp(tmp_path / "ours/continuous" / f,
                           tmp_path / "ref/continuous" / f, shallow=False), f
