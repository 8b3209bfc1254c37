"""Parity of the port's spectra engines and kernel B1 with the JAX package.

Same per-cell state into both packages (tests/torch_parity.py):
  * the plain torch version of the compensated kernel against JAX's f64
    engine ``_spectra_df12_jit`` and JAX's XLA f32c path: <= 1e-6 relative
    on bins >= 1e-4 of their species' peak (the accuracy bar _kernel_comp
    was built to; ROADMAP C1 measured the XLA f32c path at 2.5e-7);
  * the port's torch f64 engine against ``_spectra_df12_jit``: <= 1e-12
    (same f64 arithmetic, summed in another order);
Interpret-mode Pallas output is never a yardstick here (ROADMAP C1).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from is3d2_tpu.core.spectra import _spectra_df12_jit  # noqa: E402
from is3d2_tpu.core.spectra_fast import compute_spectra_fast  # noqa: E402
from is3d2_tpu.ops.spectra_fast_common import (  # noqa: E402
    pack_inputs_comp as j_pack_inputs_comp)

from torch_parity import (BLOCK, DF12_CASES, build_workdir,  # noqa: E402
                          case_state, max_rel_err, port_config)

from is3d2_tpu_torch.core.spectra import spectra_df12  # noqa: E402
from is3d2_tpu_torch.core.spectra_fast import fold_eta_quadrature  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_comp as ck  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import (  # noqa: E402
    comp_operands, compute_spectra_comp, pack_inputs_comp)

torch.set_num_threads(1)

CASES = DF12_CASES


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_kernel"),
                         include_baryon=True)


@pytest.fixture(scope="module")
def cases(workdir):
    """Each case's state and JAX results, computed once."""
    out = {}
    for name, (df_mode, baryon, shear, kw) in CASES.items():
        st = case_state(workdir, df_mode, baryon, shear_scale=shear, **kw)
        n_blocks = st.j_cells.n_padded // BLOCK
        ref64 = np.asarray(_spectra_df12_jit(st.j_cells, st.j_coeffs,
                                             st.j_species, st.j_grid, st.cfg,
                                             n_blocks))
        xla32c = np.asarray(compute_spectra_fast(
            st.j_cells, st.j_coeffs, st.j_species, st.j_grid, st.cfg,
            n_blocks=n_blocks, compute_dtype="f32c"))
        out[name] = (st, ref64, xla32c)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernel_vs_jax_f64_engine(cases, case):
    st, ref64, _ = cases[case]
    out = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid,
                               port_config(st.cfg)).numpy()
    assert np.isfinite(out).all()
    err = max_rel_err(out, ref64)
    assert err <= 1e-6, f"{case}: plain f32c vs JAX f64 {err:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernel_vs_jax_xla_f32c(cases, case):
    """Against the JAX f32c path, except where that path is at fault: for
    baryons it forms the delta-f energy as (A + abf b) T and drops the low
    part abl b of alphaB b (ROADMAP C3), an error of ~T abl ~ 1e-4 GeV on
    E.  There the port must stay within the bar of the f64 engine while the
    JAX f32c path misses it."""
    st, ref64, xla32c = cases[case]
    out = compute_spectra_comp(st.cells, st.coeffs, st.species, st.grid,
                               port_config(st.cfg)).numpy()
    if st.cfg.include_baryon:
        assert max_rel_err(xla32c, ref64) > 1e-6
        assert max_rel_err(out, ref64) <= 1e-6
    else:
        err = max_rel_err(out, xla32c)
        assert err <= 1e-6, f"{case}: plain f32c vs JAX XLA f32c {err:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_torch_f64_engine_vs_jax_f64_engine(cases, case):
    st, ref64, _ = cases[case]
    out = spectra_df12(st.cells, st.coeffs, st.species, st.grid,
                       port_config(st.cfg)).numpy()
    err = max_rel_err(out, ref64)
    assert err <= 1e-12, f"{case}: torch f64 vs JAX f64 {err:.3e}"


def test_regulation_and_outflow_cases_change_the_result(cases):
    """The clip and the Theta really act on these surfaces, so the cases
    above test them."""
    base = cases["df1"][1]
    assert max_rel_err(cases["df1-outflow"][1], base) > 1e-6
    reg = cases["df1-regulate"][0]
    free = dataclasses.replace(reg.cfg, regulate_deltaf=0)
    unclipped = np.asarray(_spectra_df12_jit(
        reg.j_cells, reg.j_coeffs, reg.j_species, reg.j_grid, free,
        reg.j_cells.n_padded // BLOCK))
    assert max_rel_err(cases["df1-regulate"][1], unclipped) > 1e-6


@pytest.mark.parametrize("case", ["df1", "df2-baryon-diffusion"])
def test_pack_matches_jax_pack(cases, case):
    """Same columns, same 12-bit splits as pack_inputs_comp of the JAX
    package (whose layout is tiled for the TPU)."""
    st, _, _ = cases[case]
    cfg = port_config(st.cfg)
    cells, grid, folded = fold_eta_quadrature(st.cells, st.grid, cfg)
    assert folded
    ops = pack_inputs_comp(cells, st.coeffs, st.species, grid, cfg)

    from is3d2_tpu.core.spectra_fast import fold_eta_quadrature as j_fold
    j_cells, j_grid, _ = j_fold(st.j_cells, st.j_grid, st.cfg)
    q, cols, qm1, qm2, mom, eta_pack, M, Ne = (
        np.asarray(a) if hasattr(a, "shape") else a
        for a in j_pack_inputs_comp(j_cells, st.j_coeffs, st.j_species,
                                    j_grid, st.cfg, c_tile=BLOCK, m_tile=512))
    C = st.cells.n_padded
    cell = ops.cell.numpy()
    col = {n: cell[:, i] for i, n in enumerate(ck.CELL_COLS)}
    jax_cols = {"shear": cols[:C, 2], "bulk0": cols[:C, 3],
                "bulk1": cols[:C, 4], "bulk2": cols[:C, 5],
                "diff0": cols[:C, 6], "diff1": cols[:C, 7],
                "qx1": cols[:C, 9], "qx2": cols[:C, 10], "qy1": cols[:C, 11],
                "qy2": cols[:C, 12], "abf": cols[:C, 13], "abl": cols[:C, 14],
                "Tf": cols[:C, 15],
                **{f"qd{k}": q[:C, 16 + k] for k in range(4)},
                **{f"qpi{k}": q[:C, 36 + k] for k in range(10)},
                **{f"qv{k}": q[:C, 48 + k] for k in range(4)}}
    for name, ref in jax_cols.items():
        np.testing.assert_array_equal(col[name], ref, err_msg=name)
    np.testing.assert_array_equal(ops.qm[:, :, 0].numpy(), qm1[:C, :Ne])
    np.testing.assert_array_equal(ops.qm[:, :, 1].numpy(), qm2[:C, :Ne])
    np.testing.assert_array_equal(ops.mom.numpy(), mom[:12, :M])
    np.testing.assert_array_equal(ops.eta.numpy().T, eta_pack[:2, :Ne])


def test_wrapper_checks_operands(cases):
    st, _, _ = cases["df1"]
    cfg = port_config(st.cfg)
    ops = comp_operands(st.cells, st.coeffs, st.species, st.grid, cfg)
    args = (ops.cell, ops.qm, ops.eta, ops.eta_w, ops.mom)
    with pytest.raises(ValueError, match="cell"):
        ck.cooper_frye_comp(ops.cell.double(), *args[1:], cfg)
    with pytest.raises(ValueError, match="contiguous"):
        ck.cooper_frye_comp(ops.cell, ops.qm, ops.eta, ops.eta_w,
                            ops.mom.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="qm"):
        ck.cooper_frye_comp(ops.cell, ops.qm[:-1], *args[2:], cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ck.cooper_frye_comp(*(a.to("meta") for a in args), cfg)
    # CPU tensors take the plain version and never count as a launch
    before = ck.cooper_frye_comp.launches
    out = ck.cooper_frye_comp(*args, cfg)
    assert ck.cooper_frye_comp.launches == before
    torch.testing.assert_close(out, ck.cooper_frye_comp_plain(*args, cfg),
                               rtol=0, atol=0)
