"""The port's per-cell physics, eta fold and configuration against the JAX
package, from the same synthetic workdir."""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (BLOCK, build_workdir, case_state,  # noqa: E402
                          numpy_fields, port_config)

from is3d2_tpu.config import Config as JConfig  # noqa: E402
from is3d2_tpu.core import spectra_fast as j_fast  # noqa: E402
from is3d2_tpu.io.deltaf_tables import DeltafTables as JTables  # noqa: E402
from is3d2_tpu.physics.deltaf import DeltafData as JDeltafData  # noqa: E402
from is3d2_tpu.physics.spline import CubicSpline as JSpline  # noqa: E402
from is3d2_tpu.report import check_invariants as j_check_invariants  # noqa: E402

from is3d2_tpu_torch import interop  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core.cells import CellArrays, prepare_cells  # noqa: E402
from is3d2_tpu_torch.core.spectra import df12_cell_coefficients  # noqa: E402
from is3d2_tpu_torch.core.spectra_fast import (_split12, _two_sum,  # noqa: E402
                                               fold_eta_quadrature)
from is3d2_tpu_torch.io.deltaf_tables import DeltafTables  # noqa: E402
from is3d2_tpu_torch.physics.deltaf import DeltafData  # noqa: E402
from is3d2_tpu_torch.physics.spline import CubicSpline  # noqa: E402
from is3d2_tpu_torch.report import check_invariants  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import make_surface  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_physics"),
                         include_baryon=True)


def _assert_rel(ours, ref, rtol, name):
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(ours - ref).max() / scale
    assert err <= rtol, f"{name}: {err:.3e}"


@pytest.mark.parametrize("df_mode,baryon", [(1, False), (2, False),
                                            (1, True), (2, True)])
def test_prepare_cells_and_coefficients(workdir, df_mode, baryon):
    """The port's own prepare_cells and coefficient columns, from the same
    surface and tables, within 1e-13 relative of the JAX package's."""
    st = case_state(workdir, df_mode, baryon)
    cfg = port_config(st.cfg)
    surf = make_surface(512, seed=3, include_baryon=baryon)
    cells = prepare_cells(surf, cfg, "cpu", block=BLOCK)
    ref = numpy_fields(st.j_cells)
    for f in dataclasses.fields(CellArrays):
        _assert_rel(getattr(cells, f.name), ref[f.name], 1e-13, f.name)
    tables = DeltafTables.load(3, baryon, workdir / "deltaf_coefficients/vh")
    coeffs = df12_cell_coefficients(cells, DeltafData(tables, df_mode, baryon),
                                    cfg)
    assert set(coeffs) == set(st.j_coeffs)
    for k, v in coeffs.items():
        _assert_rel(v, st.j_coeffs[k], 1e-13, k)


def test_spline_and_bilinear(workdir):
    x = np.linspace(0.1, 0.2, 21)
    y = np.sin(30 * x) / x
    xq = np.linspace(0.05, 0.25, 301)
    np.testing.assert_allclose(CubicSpline(x, y)(torch.from_numpy(xq)).numpy(),
                               np.asarray(JSpline(x, y)(jnp.asarray(xq))),
                               rtol=1e-14, atol=0)
    t = DeltafTables.load(3, True, workdir / "deltaf_coefficients/vh")
    jt = JTables.load(3, True, workdir / "deltaf_coefficients/vh")
    rng = np.random.default_rng(0)
    T = rng.uniform(0.09, 0.21, 200)
    muB = rng.uniform(-0.05, 0.85, 200)
    ours = DeltafData(t, 1, True)._bilinear(t.c3, torch.from_numpy(T),
                                            torch.from_numpy(muB))
    ref = JDeltafData(jt, 1, True)._bilinear(jt.c3, jnp.asarray(T),
                                             jnp.asarray(muB))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-14)


# name -> (cfg overrides, fields made nonzero, folds?)
FOLD_CASES = {
    "default": ({}, (), True),
    "eta_fold=0": ({"eta_fold": 0}, (), False),
    "un": ({}, ("un",), False),
    "dan": ({}, ("dan",), True),
    "dan+outflow": ({"outflow": 1}, ("dan",), False),
    "odd-shear": ({}, ("pitn", "pixn"), True),
    "odd-shear+regulate": ({"regulate_deltaf": 1}, ("piyn",), False),
    "dan+odd-shear": ({}, ("dan", "pitn"), False),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_gate_matches_jax(workdir, case):
    kw, odd, folds = FOLD_CASES[case]
    st = case_state(workdir, 1, False, **kw)
    rng = np.random.default_rng(5)
    live = np.asarray(st.j_cells.mask) > 0
    j_cells = dataclasses.replace(st.j_cells, **{
        f: jnp.asarray(rng.uniform(-0.02, 0.02, st.j_cells.n_padded) * live)
        for f in odd})
    cells = interop.cells_from_numpy(numpy_fields(j_cells))
    j_out, j_grid, j_folded = j_fast.fold_eta_quadrature(j_cells, st.j_grid,
                                                         st.cfg)
    out, grid, folded = fold_eta_quadrature(cells, st.grid, port_config(st.cfg))
    assert folded == j_folded == folds
    assert grid.eta.shape[0] == (12 if folds else 24)
    np.testing.assert_array_equal(grid.eta.numpy(), np.asarray(j_grid.eta))
    np.testing.assert_array_equal(grid.eta_weight.numpy(),
                                  np.asarray(j_grid.eta_weight))
    ref = numpy_fields(j_out)
    for f in dataclasses.fields(CellArrays):
        np.testing.assert_array_equal(getattr(out, f.name).numpy(),
                                      ref[f.name], err_msg=f.name)


def test_odd_node_count_fold(workdir):
    """An odd symmetric table keeps the zero node with its own weight."""
    st = case_state(workdir, 1, False)
    x, w = np.polynomial.legendre.leggauss(7)
    j_grid = dataclasses.replace(st.j_grid, eta=jnp.asarray(3 * x),
                                 eta_weight=jnp.asarray(3 * w))
    grid = interop.grid_from_numpy(numpy_fields(j_grid))
    _, jg, jf = j_fast.fold_eta_quadrature(st.j_cells, j_grid, st.cfg)
    _, g, f = fold_eta_quadrature(st.cells, grid, port_config(st.cfg))
    assert f and jf and g.eta.shape[0] == 4
    np.testing.assert_array_equal(g.eta.numpy(), np.asarray(jg.eta))
    np.testing.assert_array_equal(g.eta_weight.numpy(),
                                  np.asarray(jg.eta_weight))


def test_split12_and_two_sum_are_exact():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 10, 5000), rng.uniform(-1e-3, 1e-3, 5000),
                        [0.0, -0.0, 1.0, 50.0, -2.5e-7]])
    hi, lo = _split12(torch.from_numpy(x))
    jhi, jlo = j_fast._split12(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    bits = hi.view(torch.int32) & 0xFFF
    assert int(bits.abs().max()) == 0
    a = torch.from_numpy(rng.normal(0, 1e3, 4000)).float()
    b = torch.from_numpy(rng.normal(0, 1e-3, 4000)).float()
    s, e = _two_sum(a, b)
    np.testing.assert_array_equal(s.double() + e.double(), a.double() + b.double())


def test_config_parser_and_slice(workdir):
    path = workdir / "iS3D_parameters.dat"
    ours = Config.from_file(path)
    ref = JConfig.from_file(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    defaults = Config()
    assert (defaults.compute_dtype, defaults.df_mode, defaults.use_pallas) == \
        ("f64", 4, -1)
    ours.validate_slice()
    Config(df_mode=2, compute_dtype="f64").validate_slice()


@pytest.mark.parametrize("kw,item", [
    ({"operation": 0, "mode": 5, "dimension": 3}, "A7"),
    ({"operation": 2, "dimension": 3}, "A7"),
    ({"df_mode": 3, "use_pallas": 0}, "A9"), ({"df_mode": 4, "dimension": 3}, "A9"),
    ({"df_mode": 5, "dimension": 3}, "A7"),
    ({"dimension": 3}, "A7"), ({"operation": 0, "dimension": 3}, "A7"),
    ({"mode": 5, "use_mesh": 1}, "A12"),
    ({"compute_dtype": "f32", "use_pallas": 0}, "A7"),
    ({"compute_dtype": "f32c", "use_pallas": 0}, "A7"),
    # kernel B2 is 2+1d, as in the JAX package
    ({"compute_dtype": "f64", "use_pallas": 1, "dimension": 3}, "B2"),
    ({"group_particles": 1, "use_mesh": 1}, "A12"), ({"use_mesh": 1}, "A12"),
])
def test_validate_slice_rejects_the_rest(kw, item):
    cfg = Config(**{"df_mode": 1, "compute_dtype": "f32c", **kw})
    with pytest.raises(NotImplementedError, match=item):
        cfg.validate_slice()


@pytest.mark.parametrize("kw", [{"mode": m} for m in (0, 1, 2, 3, 4, 6, 7)]
                         + [{"use_pallas": 0}, {"group_particles": 1}])
def test_validate_slice_lets_this_slice_through(kw):
    """Operations 0, 1 and 2 with df 1-4 on every ported surface mode, and
    group_particles; operation 0 with use_pallas = 0 too (the JAX
    package's operation 0 ignores it)."""
    for operation in (0, 1, 2):
        if operation == 1 and kw.get("use_pallas") == 0:
            continue
        for df_mode in (1, 2, 3, 4):
            for dtype in ("f64", "f32c"):
                Config(operation=operation, df_mode=df_mode,
                       compute_dtype=dtype, **kw).validate_slice()


@pytest.mark.parametrize("baryon", [False, True])
def test_check_invariants(baryon):
    surf = make_surface(300, seed=9, include_baryon=baryon, shear_scale=0.05)
    ours = check_invariants(surf, include_baryondiff=baryon)
    ref = j_check_invariants(surf, include_baryondiff=baryon)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k][1] == ref[k][1]
        assert abs(ours[k][0] - ref[k][0]) <= 1e-15, k
