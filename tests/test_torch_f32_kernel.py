"""Parity of kernel B2's plain version (the plain-f32 df-1/2 kernel) and its
pack with the JAX package.

Same per-cell state into both packages (tests/torch_parity.py), over the
seven df 1/2 cases of test_torch_kernel.py.  Bars, relative on bins >= 1e-4
of their species' peak:
  * the plain version (``compute_spectra_f32`` on CPU tensors) against
    JAX's f64 engine ``_spectra_df12_jit``: <= 1e-5.  JAX's own XLA f32
    path sits ~4.6e-6 from it: plain f32 rounds the exp argument;
  * against JAX's XLA f32 path (``compute_spectra_fast`` in float32, the
    arithmetic of ``_kernel`` with exact dots): <= 5e-6.  Both round the
    same f32 operands, so they differ only by the order of the roundings;
  * the port's ``pack_inputs`` against JAX's ``pack_inputs``, column by
    column on the unpadded rows: equal.
Interpret-mode Pallas output is never a yardstick here (ROADMAP C1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from is3d2_tpu.core.spectra import _spectra_df12_jit  # noqa: E402
from is3d2_tpu.core.spectra_fast import compute_spectra_fast  # noqa: E402
from is3d2_tpu.core.spectra_fast import fold_eta_quadrature as j_fold  # noqa: E402
from is3d2_tpu.ops.spectra_fast_common import (  # noqa: E402
    pack_inputs as j_pack_inputs)

from torch_parity import (BLOCK, DF12_CASES, build_workdir,  # noqa: E402
                          case_state, max_rel_err, port_config)

from is3d2_tpu_torch.core.spectra_fast import fold_eta_quadrature  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_f32 as b2  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import (  # noqa: E402
    compute_spectra_f32, f32_operands, pack_inputs)

torch.set_num_threads(1)

TOL_F64 = 1e-5
TOL_XLA_F32 = 5e-6


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_f32_kernel"),
                         include_baryon=True)


@pytest.fixture(scope="module")
def cases(workdir):
    """Each case's state, JAX results and the port's plain-version result,
    computed once."""
    out = {}
    for name, (df_mode, baryon, shear, kw) in DF12_CASES.items():
        st = case_state(workdir, df_mode, baryon, shear_scale=shear, **kw)
        n_blocks = st.j_cells.n_padded // BLOCK
        ref64 = np.asarray(_spectra_df12_jit(st.j_cells, st.j_coeffs,
                                             st.j_species, st.j_grid, st.cfg,
                                             n_blocks))
        xla32 = np.asarray(compute_spectra_fast(
            st.j_cells, st.j_coeffs, st.j_species, st.j_grid, st.cfg,
            n_blocks=n_blocks, compute_dtype=jnp.float32))
        ours = compute_spectra_f32(st.cells, st.coeffs, st.species, st.grid,
                                   port_config(st.cfg)).numpy()
        out[name] = (st, ref64, xla32, ours)
    return out


@pytest.mark.parametrize("case", list(DF12_CASES))
def test_plain_f32_kernel_vs_jax_f64_engine(cases, case):
    _, ref64, _, ours = cases[case]
    assert np.isfinite(ours).all()
    err = max_rel_err(ours, ref64)
    assert err <= TOL_F64, f"{case}: plain f32 vs JAX f64 {err:.3e}"


@pytest.mark.parametrize("case", list(DF12_CASES))
def test_plain_f32_kernel_vs_jax_xla_f32(cases, case):
    _, _, xla32, ours = cases[case]
    err = max_rel_err(ours, xla32)
    assert err <= TOL_XLA_F32, f"{case}: plain f32 vs JAX XLA f32 {err:.3e}"


@pytest.mark.parametrize("case", list(DF12_CASES))
def test_pack_matches_jax_pack(cases, case):
    """Same columns as pack_inputs of the JAX package (whose layout is
    tiled and padded for the TPU), on the unpadded rows."""
    st = cases[case][0]
    cfg = port_config(st.cfg)
    cells, grid, folded = fold_eta_quadrature(st.cells, st.grid, cfg)
    assert folded
    ops = pack_inputs(cells, st.coeffs, st.species, grid, cfg)

    j_cells, j_grid, _ = j_fold(st.j_cells, st.j_grid, st.cfg)
    q, cols, mom, eta_pack, M, Ne = (
        np.asarray(a) if hasattr(a, "shape") else a
        for a in j_pack_inputs(j_cells, st.j_coeffs, st.j_species, j_grid,
                               st.cfg, c_tile=BLOCK, m_tile=512))
    C = st.cells.n_padded
    cell = ops.cell.numpy()
    col = {n: cell[:, i] for i, n in enumerate(b2.CELL_COLS)}
    jax_cols = {**{f"qe{k}": q[:C, k] for k in range(4)},
                **{f"qd{k}": q[:C, 16 + k] for k in range(4)},
                **{f"qpi{k}": q[:C, 36 + k] for k in range(10)},
                **{f"qv{k}": q[:C, 48 + k] for k in range(4)},
                "invT": cols[:C, 0], "alphaB": cols[:C, 1],
                "shear": cols[:C, 2], "bulk0": cols[:C, 3],
                "bulk1": cols[:C, 4], "bulk2": cols[:C, 5],
                "diff0": cols[:C, 6], "diff1": cols[:C, 7]}
    assert set(jax_cols) | {"unused0", "unused1"} == set(b2.CELL_COLS)
    for name, ref in jax_cols.items():
        np.testing.assert_array_equal(col[name], ref, err_msg=name)
    assert not col["unused0"].any() and not col["unused1"].any()
    np.testing.assert_array_equal(ops.mom.numpy(), mom[:6, :M])
    np.testing.assert_array_equal(ops.eta.numpy().T, eta_pack[:2, :Ne])
    np.testing.assert_array_equal(ops.eta_w.numpy().astype(np.float32),
                                  eta_pack[2, :Ne])


def test_pack_hands_the_phi_count_over(cases, monkeypatch):
    """F32Operands.row_len is the phi count, and compute_spectra_f32 hands
    it to the wrapper, so that no launch reads the momentum rows back."""
    st = cases["df1"][0]
    cfg = port_config(st.cfg)
    ops = f32_operands(st.cells, st.coeffs, st.species, st.grid, cfg)
    assert ops.row_len == st.grid.cos_phi.shape[0] == 8
    seen = []
    wrapper = b2.cooper_frye_f32
    monkeypatch.setattr(b2, "cooper_frye_f32",
                        lambda *a, **kw: seen.append(kw) or wrapper(*a, **kw))
    compute_spectra_f32(st.cells, st.coeffs, st.species, st.grid, cfg)
    assert seen == [{"row_len": 8}]


def test_wrapper_checks_operands(cases):
    st = cases["df1"][0]
    cfg = port_config(st.cfg)
    ops = f32_operands(st.cells, st.coeffs, st.species, st.grid, cfg)
    cell, eta, eta_w, mom = ops.args()
    with pytest.raises(ValueError, match="cell"):
        b2.cooper_frye_f32(cell.double(), eta, eta_w, mom, cfg)
    with pytest.raises(ValueError, match="eta_w"):
        b2.cooper_frye_f32(cell, eta, eta_w.float(), mom, cfg)
    with pytest.raises(ValueError, match="mom"):
        b2.cooper_frye_f32(cell, eta, eta_w, mom[:5].contiguous(), cfg)
    with pytest.raises(ValueError, match="eta"):
        b2.cooper_frye_f32(cell, eta[:-1], eta_w, mom, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        b2.cooper_frye_f32(cell, eta, eta_w, mom.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        b2.cooper_frye_f32(cell.t().contiguous().t(), eta, eta_w, mom, cfg)
    with pytest.raises(ValueError, match="is on meta"):
        b2.cooper_frye_f32(cell, eta.to("meta"), eta_w, mom, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        b2.cooper_frye_f32(*(a.to("meta") for a in ops.args()), cfg)
    # CPU tensors take the plain version and never count as a launch
    before = b2.cooper_frye_f32.launches
    out = b2.cooper_frye_f32(*ops.args(), cfg)
    assert b2.cooper_frye_f32.launches == before
    torch.testing.assert_close(out, b2.cooper_frye_f32_plain(*ops.args(), cfg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype,use_pallas,engine", [
    ("f64", 1, "kernel B2"), ("f64", -1, "f64 engine"), ("f64", 0, "f64 engine"),
    ("f32", -1, "kernel B1"), ("f32", 1, "kernel B1"),
    ("f32c", -1, "kernel B1"), ("f32c", 1, "kernel B1"),
])
def test_df12_dispatch_follows_the_jax_package(workdir, monkeypatch, dtype,
                                               use_pallas, engine):
    """compute_spectra routes df 1/2 as is3d2_tpu/core/spectra.py:354-389
    does on one accelerator: f32/f32c with the kernels on to the
    compensated kernel B1, f64 with use_pallas = 1 to the plain-f32 kernel
    B2, f64 otherwise to the f64 engine."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.core import spectra
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.ops import spectra_fast_common as sfc

    ran = []

    def spy(name):
        def run(cells, coeffs, species, grid, cfg):
            ran.append(name)
            return torch.zeros(species.mass.shape[0], grid.pT.shape[0],
                               grid.cos_phi.shape[0], 1, dtype=torch.float64)
        return run

    monkeypatch.setattr(sfc, "compute_spectra_comp", spy("kernel B1"))
    monkeypatch.setattr(sfc, "compute_spectra_f32", spy("kernel B2"))
    monkeypatch.setattr(spectra, "spectra_df12", spy("f64 engine"))
    cfg = Config(df_mode=2, compute_dtype=dtype, use_pallas=use_pallas,
                 include_baryon=1, include_baryondiff_deltaf=1,
                 cell_block=BLOCK)
    run = IS3D(workdir, cfg=cfg, device="cpu")
    run.load_surface_from_file()
    run._setup()
    spectra.compute_spectra(run.surface, run.species, run.chosen_idx,
                            run.grids, run.df_data, cfg, "cpu")
    assert ran == [engine]


@pytest.mark.parametrize("kw", [
    {"compute_dtype": "f64", "use_pallas": 1},
    {"compute_dtype": "f32", "use_pallas": -1},
    {"compute_dtype": "f32", "use_pallas": 1},
])
@pytest.mark.parametrize("df_mode", [1, 2])
def test_validate_slice_lets_the_kernel_routes_through(kw, df_mode):
    from is3d2_tpu_torch.config import Config
    Config(df_mode=df_mode, **kw).validate_slice()


@pytest.mark.parametrize("kw", [
    {"compute_dtype": "f32", "use_pallas": 0},
    {"compute_dtype": "f32c", "use_pallas": 0},
    {"compute_dtype": "f64", "use_pallas": 1, "dimension": 3},
    {"compute_dtype": "f32", "use_pallas": -1, "dimension": 3},
])
@pytest.mark.parametrize("df_mode", [1, 2])
def test_validate_slice_still_rejects_the_kernel_less_engines(kw, df_mode):
    from is3d2_tpu_torch.config import Config
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Config(df_mode=df_mode, **kw).validate_slice()
