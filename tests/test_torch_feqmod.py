"""Parity of the port's df 3/4 (feqmod) path and kernel B3 with the JAX
package.

Same per-cell state into both packages (tests/torch_parity.py), 512 cells,
8 species, 16 pT x 8 phi, 24 eta (12 folded):
  * thermal integrals, Jonah splines, delta-f coefficients, boost_shear and
    every FeqmodCellData field: <= 1e-12 relative (f64 on both sides);
  * the torch f64 engine against ``_spectra_feqmod_jit``: <= 1e-10;
  * the operand pack against ``pack_feqmod_pallas``: f32-exact;
  * the kernel's plain version against the JAX kernel in interpret mode on
    the same operands: <= 1e-5 (on the mild surface with forced
    breakdowns, see torch_parity), and against the JAX f64 engine: <= 1e-4,
    the bar of the JAX kernel (tests/test_pallas_kernel.py).  The famod
    mode's operands are packed from the JAX package's own f64 famod prep
    (torch_parity.famod_state), carried across by interop.famod_from_numpy.
Errors are relative, on bins >= 1e-4 of their species' peak.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from is3d2_tpu.core.spectra_fast import fold_eta_quadrature as j_fold  # noqa: E402
from is3d2_tpu.core.spectra_feqmod import _spectra_feqmod_jit  # noqa: E402
from is3d2_tpu.core.spectra_feqmod_fast import (  # noqa: E402
    _pack_famod_fast, _pack_feqmod_fast)
from is3d2_tpu.ops.cooper_frye_feqmod_pallas import (  # noqa: E402
    cooper_frye_feqmod_pallas, pack_feqmod_pallas)
from is3d2_tpu.physics import lrf as j_lrf  # noqa: E402
from is3d2_tpu.physics import thermal as j_thermal  # noqa: E402
from is3d2_tpu.report import RunReport as JRunReport  # noqa: E402

from torch_parity import (BLOCK, CHOSEN, MILD_SHEAR, build_workdir,  # noqa: E402
                          famod_state, feqmod_state, max_rel_err,
                          numpy_fields, port_config)

from is3d2_tpu_torch import interop  # noqa: E402
from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core.feqmod import FeqmodCellData, prepare_feqmod  # noqa: E402
from is3d2_tpu_torch.core.spectra import PREFACTOR  # noqa: E402
from is3d2_tpu_torch.core.spectra_feqmod import spectra_feqmod  # noqa: E402
from is3d2_tpu_torch.io.deltaf_tables import DeltafTables  # noqa: E402
from is3d2_tpu_torch.io.pdg import read_pdg  # noqa: E402
from is3d2_tpu_torch.io.tables import GaussLaguerre  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.physics import lrf, thermal  # noqa: E402
from is3d2_tpu_torch.physics.deltaf import DeltafData  # noqa: E402
from is3d2_tpu_torch.report import RunReport  # noqa: E402

torch.set_num_threads(1)

S = len(CHOSEN)

# name -> (df_mode, include_baryon, extra cfg)
CASES = {
    "df3": (3, False, {}),
    "df4": (4, False, {}),
    "df3-outflow-regulate": (3, False, {"outflow": 1, "regulate_deltaf": 1}),
    "df4-regulate": (4, False, {"regulate_deltaf": 1}),
    "df3-baryon-diffusion": (3, True, {}),
}
KERNEL_CASES = ["df3", "df4", "famod", "df3-outflow-regulate", "df4-regulate"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("torch_feqmod"),
                         include_baryon=True)


@pytest.fixture(scope="module")
def states(workdir):
    """The large-viscosity state of each case, and the JAX f64 engine's
    spectra for it, computed once."""
    out = {}
    for name, (df_mode, baryon, kw) in CASES.items():
        st = feqmod_state(workdir, df_mode, baryon, **kw)
        out[name] = (st, _jax_f64(st))
    return out


@pytest.fixture(scope="module")
def mild(workdir):
    """The mild surface with forced breakdowns, per kernel case (famod: the
    EOS-consistent surface at MILD_SHEAR)."""
    out = {}
    for name in KERNEL_CASES:
        if name == "famod":
            out[name] = famod_state(workdir, shear_scale=MILD_SHEAR,
                                    force_breaks=True)
            continue
        df_mode, baryon, kw = CASES[name]
        out[name] = feqmod_state(workdir, df_mode, baryon,
                                 shear_scale=MILD_SHEAR, force_breaks=True, **kw)
    return out


@pytest.fixture(scope="module")
def famod(workdir):
    """The famod state of the EOS-consistent surface at FAMOD_SHEAR."""
    return famod_state(workdir)


def _jax_f64(st):
    return np.asarray(_spectra_feqmod_jit(st.j_cells, st.j_fq, st.j_species,
                                          st.j_grid, st.cfg,
                                          st.j_cells.n_padded // BLOCK))


def _rel(ours, ref):
    """Max |ours - ref| / max |ref|, with equal non-finite entries."""
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(ours[~fin], ref[~fin])
    assert np.isfinite(ours[fin]).all()
    if not fin.any():
        return 0.0
    return float(np.abs(ours[fin] - ref[fin]).max()
                 / max(np.abs(ref[fin]).max(), 1e-300))


def _jax_operands(st, kind):
    j_cells, j_grid, _ = j_fold(st.j_cells, st.j_grid, st.cfg, strict=True)
    if kind == "famod":
        data = _pack_famod_fast(j_cells, st.j_fm, S)
    else:
        data = _pack_feqmod_fast(j_cells, st.j_fq, st.cfg)
    return pack_feqmod_pallas(data, st.j_species, j_grid, 256, 512)


def _port_operands(st, kind):
    cfg = port_config(st.cfg)
    if kind == "famod":
        return fk.famod_operands(st.cells, st.fm, st.species, st.grid, cfg)
    return fk.feqmod_operands(st.cells, st.fq, st.species, st.grid, cfg)


def _jax_kernel(st, kind, operands=None):
    cols, P, renorm, red, eta_pack, M, Ne = operands or _jax_operands(st, kind)
    out = cooper_frye_feqmod_pallas(cols, P, renorm, red, eta_pack, st.cfg,
                                    kind, Ne, interpret=True)
    return np.asarray(out)[:, :M]


def _plain(st, kind, ops=None):
    ops = ops or _port_operands(st, kind)
    out = fk.cooper_frye_feqmod_plain(*ops.args(), port_config(st.cfg), kind)
    return out.numpy().reshape(S, -1)


def _plain_spectra(st):
    return fk.compute_spectra_feqmod_kernel(
        st.cells, st.fq, st.species, st.grid, port_config(st.cfg)).numpy()


# ----------------------------------------------------------------------
# physics
# ----------------------------------------------------------------------

def test_thermal_integrals_match_jax(workdir):
    lag = GaussLaguerre.from_file(workdir / "tables/gauss/gla_roots_weights.txt")
    rng = np.random.default_rng(4)
    n = 300
    mbar = rng.uniform(0.5, 60.0, n)
    alphaB = rng.uniform(-1.0, 1.0, n)
    b = rng.integers(-1, 2, n).astype(np.float64)
    sgn = rng.choice([-1.0, 1.0], n)
    lam = rng.uniform(-0.9, 2.0, n)
    for name, a in (("neq_integral", 1), ("J10_integral", 1),
                    ("J11_integral", 1), ("J20_integral", 2),
                    ("J30_integral", 3), ("J31_integral", 3)):
        r, w = lag.roots[a], lag.weights[a]
        ours = getattr(thermal, name)(r, w, torch.from_numpy(mbar),
                                      torch.from_numpy(alphaB),
                                      torch.from_numpy(b), torch.from_numpy(sgn))
        ref = getattr(j_thermal, name)(jnp.asarray(r), jnp.asarray(w), mbar,
                                       alphaB, b, sgn)
        assert _rel(ours, ref) <= 1e-12, name
    for name in ("E_mod_integral", "P_mod_integral"):
        r, w = lag.roots[2], lag.weights[2]
        ours = getattr(thermal, name)(r, w, torch.from_numpy(mbar),
                                      torch.from_numpy(lam), torch.from_numpy(sgn))
        ref = getattr(j_thermal, name)(jnp.asarray(r), jnp.asarray(w), mbar,
                                       lam, sgn)
        assert _rel(ours, ref) <= 1e-12, name


def _port_df_data(workdir, st, df_mode, baryon):
    """The port's DeltafData from the workdir's tables, with the Jonah
    splines of the same surface average as the JAX state's."""
    tables = DeltafTables.load(3, baryon, workdir / "deltaf_coefficients/vh")
    df_data = DeltafData(tables, df_mode, baryon)
    if not baryon:
        lag = GaussLaguerre.from_file(
            workdir / "tables/gauss/gla_roots_weights.txt")
        df_data.compute_jonah_coefficients(read_pdg(3, workdir / "PDG"), lag,
                                           st.plasma)
    return df_data


def test_jonah_coefficients_match_jax(workdir, states):
    st, _ = states["df4"]
    ours = _port_df_data(workdir, st, 4, False)
    ref = st.j_df_data
    assert abs(ours.bulkPi_over_Peq_max - ref.bulkPi_over_Peq_max) \
        <= 1e-12 * abs(ref.bulkPi_over_Peq_max)
    x = np.linspace(-1.0, ref.bulkPi_over_Peq_max, 401)
    for name in ("_lambda_squared_spline", "_z_spline"):
        o = getattr(ours, name)
        r = getattr(ref, name)
        np.testing.assert_allclose(o.x, r.x, rtol=1e-12, atol=1e-14)
        assert _rel(o(torch.from_numpy(x)), r(jnp.asarray(x))) <= 1e-12, name


@pytest.mark.parametrize("case", ["df3", "df4", "df3-baryon-diffusion"])
def test_deltaf_evaluate_matches_jax(workdir, states, case):
    st, _ = states[case]
    df_mode, baryon, _ = CASES[case]
    ours_data = _port_df_data(workdir, st, df_mode, baryon)
    c, jc = st.cells, st.j_cells
    bulkPi = c.bulkPi
    j_bulkPi = jc.bulkPi
    if df_mode == 4:
        bulkPi = ours_data.regulate_bulkPi_ptb(bulkPi, c.P)
        j_bulkPi = st.j_df_data.regulate_bulkPi_ptb(j_bulkPi, jc.P)
        assert _rel(bulkPi, j_bulkPi) <= 1e-15
    ours = ours_data.evaluate(c.T, c.muB, c.E, c.P, bulkPi)
    ref = st.j_df_data.evaluate(jc.T, jc.muB, jc.E, jc.P, j_bulkPi)
    for f in dataclasses.fields(ours):
        assert _rel(getattr(ours, f.name), getattr(ref, f.name)) <= 1e-12, f.name


def test_boost_shear_matches_jax(states):
    st, _ = states["df3"]
    c, jc = st.cells, st.j_cells
    ours = lrf.boost_shear(lrf.milne_basis(c.tau, c.ux, c.uy, c.un), c.tau,
                           c.pitt, c.pitx, c.pity, c.pitn, c.pixx, c.pixy,
                           c.pixn, c.piyy, c.piyn, c.pinn)
    ref = j_lrf.boost_shear(j_lrf.milne_basis(jc.tau, jc.ux, jc.uy, jc.un),
                            jc.tau, jc.pitt, jc.pitx, jc.pity, jc.pitn,
                            jc.pixx, jc.pixy, jc.pixn, jc.piyy, jc.piyn,
                            jc.pinn)
    for f in dataclasses.fields(ours):
        assert _rel(getattr(ours, f.name), getattr(ref, f.name)) <= 1e-12, f.name


@pytest.mark.parametrize("case", ["df3", "df4", "df3-baryon-diffusion"])
def test_prepare_feqmod_matches_jax(workdir, states, case):
    """The port's own prep, from the same cells, tables and quadrature."""
    st, _ = states[case]
    df_mode, baryon, _ = CASES[case]
    lag = GaussLaguerre.from_file(workdir / "tables/gauss/gla_roots_weights.txt")
    fq = prepare_feqmod(st.cells, st.species,
                        _port_df_data(workdir, st, df_mode, baryon),
                        port_config(st.cfg), lag)
    ref = numpy_fields(st.j_fq)
    live = st.cells.mask.numpy() > 0
    n_break = int((fq.breaks_down.numpy() & live).sum())
    assert 0 < n_break < live.sum()
    np.testing.assert_array_equal(fq.breaks_down.numpy(), ref["breaks_down"])
    for f in dataclasses.fields(FeqmodCellData):
        if f.name != "breaks_down":
            assert _rel(getattr(fq, f.name), ref[f.name]) <= 1e-12, f.name


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_torch_f64_engine_vs_jax_f64_engine(states, case):
    st, ref = states[case]
    out = spectra_feqmod(st.cells, st.fq, st.species, st.grid,
                         port_config(st.cfg)).numpy()
    err = max_rel_err(out, ref)
    assert err <= 1e-10, f"{case}: torch f64 vs JAX f64 {err:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernel_vs_jax_f64_engine(states, case):
    st, ref = states[case]
    out = _plain_spectra(st)
    assert np.isfinite(out).all()
    err = max_rel_err(out, ref)
    assert err <= 1e-4, f"{case}: plain B3 vs JAX f64 {err:.3e}"


def test_regulation_and_outflow_change_the_result(states):
    """The clip and the Theta really act on this surface, so the cases
    above test them."""
    assert max_rel_err(states["df3-outflow-regulate"][1],
                       states["df3"][1]) > 1e-6
    assert max_rel_err(states["df4-regulate"][1], states["df4"][1]) > 1e-6


def test_factored_E_mod_keeps_the_accuracy_the_quadratic_form_loses(states):
    """ROADMAP C4: on the large-viscosity surface some cells have a nearly
    singular A, and the JAX kernel's expanded quadratic form for E_mod^2
    cancels: its f32 result is ~1e-4 off the f64 engine.  The port sums
    |A^-1 p|^2 as three squares and stays within 5e-6."""
    st, ref = states["df3"]
    deg = PREFACTOR * np.asarray(st.j_species.degeneracy)[:, None]
    jax_f32 = _jax_kernel(st, "feqmod") * deg
    assert max_rel_err(jax_f32, ref) > 2e-5
    assert max_rel_err(_plain_spectra(st), ref) <= 5e-6


# ----------------------------------------------------------------------
# kernel B3 against the JAX kernel
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["df3", "df4"])
def test_pack_matches_jax_pack(states, case):
    st, _ = states[case]
    ops = _port_operands(st, "feqmod")
    _assert_pack_equal(ops, _jax_operands(st, "feqmod"))


def test_famod_pack_matches_jax_pack(famod):
    st = famod
    assert (st.fm.breaks_down & (st.cells.mask > 0)).any()
    ops = _port_operands(st, "famod")
    _assert_pack_equal(ops, _jax_operands(st, "famod"))


def _assert_pack_equal(ops, jax_ops):
    cols, P, renorm, red, eta_pack, M, Ne = (
        np.asarray(a) if hasattr(a, "shape") else a for a in jax_ops)
    C = ops.cols.shape[0]
    assert (ops.n_per_species, ops.eta.shape[0]) == (M, Ne) == (128, 12)
    for i in range(fk.N_COLS):
        np.testing.assert_array_equal(ops.cols[:, i].numpy(), cols[:C, i],
                                      err_msg=f"column {i}")
    np.testing.assert_array_equal(ops.mom.numpy().reshape(12, S, M),
                                  P[:, :12, :M].transpose(1, 0, 2))
    np.testing.assert_array_equal(ops.renorm.numpy(), renorm[:C, :S])
    np.testing.assert_array_equal(ops.red.numpy(), red[:C, :S])
    np.testing.assert_array_equal(ops.eta.numpy().T, eta_pack[:4, :Ne])


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_plain_kernel_vs_jax_kernel_interpret(mild, case):
    st = mild[case]
    kind = "famod" if case == "famod" else "feqmod"
    live = st.cells.mask.numpy() > 0
    prep = st.fm if kind == "famod" else st.fq
    assert (prep.breaks_down.numpy() & live).sum() > 0
    err = max_rel_err(_plain(st, kind), _jax_kernel(st, kind))
    assert err <= 1e-5, f"{case}: plain B3 vs JAX B3 (interpret) {err:.3e}"


def test_unfolded_case_with_dan_keeps_the_unweighted_dan_term(workdir, states,
                                                              mild):
    """dan != 0 refuses the strict fold (24 eta nodes), and p.dsigma keeps
    the reference's unweighted dan term (MomentumSpectra.cpp:936).  The dan
    term is odd in eta, so it cancels over the symmetric nodes unless the
    outflow Theta(p.dsigma) makes the integrand nonlinear in it: the case
    has outflow on."""
    rng = np.random.default_rng(8)

    def with_dan(st):
        live = np.asarray(st.j_cells.mask) > 0
        dan = rng.uniform(-0.02, 0.02, st.j_cells.n_padded) * live
        j_cells = dataclasses.replace(st.j_cells, dan=jnp.asarray(dan))
        return dataclasses.replace(st, j_cells=j_cells,
                                   cells=dataclasses.replace(
                                       st.cells, dan=torch.from_numpy(dan)))

    base, base_ref = states["df3-outflow-regulate"]
    st = with_dan(base)
    ops = _port_operands(st, "feqmod")
    assert ops.eta.shape[0] == 24
    ref = _jax_f64(st)
    out = spectra_feqmod(st.cells, st.fq, st.species, st.grid,
                         port_config(st.cfg)).numpy()
    assert max_rel_err(out, ref) <= 1e-10
    assert max_rel_err(_plain_spectra(st), ref) <= 1e-4
    assert max_rel_err(ref, base_ref) > 1e-6
    m = with_dan(mild["df3-outflow-regulate"])
    assert max_rel_err(_plain(m, "feqmod"), _jax_kernel(m, "feqmod")) <= 1e-5


def test_nonfinite_renorm_skips_the_species(states, mild):
    """A nan/inf renorm drops that (cell, species) from the sum in every
    engine (MomentumSpectra.cpp:828-832)."""
    def inject(st):
        renorm = np.array(st.j_fq.renorm)
        renorm[::7, 2] = np.nan
        renorm[3::11, 5] = np.inf
        j_fq = dataclasses.replace(st.j_fq, renorm=jnp.asarray(renorm))
        fq = dataclasses.replace(st.fq, renorm=torch.from_numpy(renorm))
        return dataclasses.replace(st, j_fq=j_fq, fq=fq)

    st = inject(states["df3"][0])
    ref = _jax_f64(st)
    assert max_rel_err(ref, states["df3"][1]) > 1e-6
    out = spectra_feqmod(st.cells, st.fq, st.species, st.grid,
                         port_config(st.cfg)).numpy()
    assert max_rel_err(out, ref) <= 1e-10
    assert max_rel_err(_plain_spectra(st), ref) <= 1e-4
    m = inject(mild["df3"])
    assert max_rel_err(_plain(m, "feqmod"), _jax_kernel(m, "feqmod")) <= 1e-5


def test_breakdown_cells_follow_where_semantics(mild):
    """A breakdown cell's modified branch never reaches the sum, even when
    it is not finite: the port selects per cell, as the f64 engines do.
    The JAX kernel blends the branches arithmetically, so there a nan in
    the modified branch of a breakdown cell poisons the sum."""
    st = mild["df3"]
    ops = _port_operands(st, "feqmod")
    ref = _plain(st, "feqmod", ops)
    broken = ops.cols[:, fk.BREAKS] != 0
    cols = ops.cols.clone()
    cols[broken, fk.INVTEFF] = float("nan")
    cols[broken, fk.MINV:fk.MINV + 9] = float("inf")
    out = _plain(st, "feqmod", dataclasses.replace(ops, cols=cols))
    np.testing.assert_array_equal(out, ref)

    j_ops = list(_jax_operands(st, "feqmod"))
    j_cols = np.array(j_ops[0])
    C = cols.shape[0]
    j_cols[:C][broken.numpy(), fk.INVTEFF] = np.nan
    j_cols[:C][broken.numpy(), fk.MINV:fk.MINV + 9] = np.inf
    j_ops[0] = jnp.asarray(j_cols)
    assert np.isnan(_jax_kernel(st, "feqmod", j_ops)).any()


def test_wrapper_checks_operands(states):
    st, _ = states["df4"]
    cfg = port_config(st.cfg)
    ops = _port_operands(st, "feqmod")
    args = ops.args()
    with pytest.raises(ValueError, match="cols"):
        fk.cooper_frye_feqmod(ops.cols.double(), *args[1:], cfg, "feqmod")
    with pytest.raises(ValueError, match="contiguous"):
        fk.cooper_frye_feqmod(ops.cols, ops.mom.t().contiguous().t(),
                              *args[2:], cfg, "feqmod")
    with pytest.raises(ValueError, match="red"):
        fk.cooper_frye_feqmod(*args[:3], ops.red[:-1], *args[4:], cfg,
                              "feqmod")
    with pytest.raises(ValueError, match="do not fit"):
        fk.cooper_frye_feqmod(*args[:5], 16, cfg, "feqmod")
    # a block may span many species (16 momenta each here, one each at
    # worst): their renorm always fits the block's shared memory
    few = fk.cooper_frye_feqmod(ops.cols, ops.mom[:, :S * 16].contiguous(),
                                *args[2:5], 16, cfg, "feqmod")
    assert few.shape == (S * 16,) and bool(torch.isfinite(few).all())
    distinct = torch.arange(12 * 2000, dtype=torch.float32).reshape(12, 2000)
    worst = fk.geometry(distinct, 1, 2000, 100, fk.ETA_CHUNK)
    assert worst.span == 256 and worst.smem <= fk.MAX_SMEM
    with pytest.raises(ValueError, match="kernel mode"):
        fk.cooper_frye_feqmod(*args, dataclasses.replace(cfg, df_mode=2),
                              "feqmod")
    with pytest.raises(ValueError, match="no kernel"):
        fk.cooper_frye_feqmod(*(a.to("meta") for a in args[:5]), args[5],
                              cfg, "feqmod")
    # CPU tensors take the plain version and never count as a launch
    before = fk.cooper_frye_feqmod.launches
    out = fk.cooper_frye_feqmod(*args, cfg, "feqmod")
    assert fk.cooper_frye_feqmod.launches == before
    torch.testing.assert_close(
        out, fk.cooper_frye_feqmod_plain(*args, cfg, "feqmod"), rtol=0, atol=0)


# ----------------------------------------------------------------------
# configuration and report
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw,match,exc", [
    ({"df_mode": 5, "compute_dtype": "f32", "use_pallas": 0}, "A9",
     NotImplementedError),
    ({"df_mode": 4, "include_baryon": 1}, "does not support nonzero muB",
     ValueError),
    ({"df_mode": 3, "compute_dtype": "f32", "use_pallas": 0}, "A9",
     NotImplementedError),
    ({"df_mode": 4, "dimension": 3}, "A9", NotImplementedError),
])
def test_validate_slice_rejects_what_df345_do_not_run(kw, match, exc):
    with pytest.raises(exc, match=match):
        Config(**kw).validate_slice()


@pytest.mark.parametrize("kw", [
    {"df_mode": 3}, {"df_mode": 4, "compute_dtype": "f32"},
    {"df_mode": 3, "compute_dtype": "f32c"},
    {"df_mode": 4, "compute_dtype": "f64", "use_pallas": 1},
    {"df_mode": 3, "include_baryon": 1, "include_baryondiff_deltaf": 1},
])
def test_validate_slice_lets_df34_through(kw):
    Config(**kw).validate_slice()


def test_breakdown_report_line_matches_jax(states):
    st, _ = states["df3"]
    ours, ref = RunReport(n_cells=500), JRunReport(n_cells=500)
    ours.record_breakdown(st.fq.breaks_down, st.cells.tau, st.cells.mask)
    ref.record_breakdown(st.j_fq.breaks_down, st.j_cells.tau, st.j_cells.mask)
    assert ours.breakdown_cells > 0
    assert ours.lines() == ref.lines()
