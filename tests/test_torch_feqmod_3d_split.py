"""B3's 3+1d mode split by cell, on the CPU: the pack's partition of the
live cells into clean cells (no breakdown, no narrow window: no y row takes
the linearised branch) and touched ones, and the plain versions of the two
kernels that sum them.

Inputs are built in code (tests/torch_parity.py): 512 cells of
make_surface(dimension=3), 8 species, 16 pT x 8 phi and a 9-point y table;
the feqmod cases (df 3, df 4) on shear 0.2, bulk 0.1, the famod case on an
EOS-consistent surface (shear 0.1, bulk 0.05).
  * the partition: every live cell in exactly one set, each set in live
    order, the clean cells first; clean cells neither break down nor have
    a window; ``clean_count`` (what the route hands the kernels) is the
    pack's count;
  * the clean kernel's plain version on the clean cells plus the mixed
    kernel's (``cooper_frye_feqmod_3d_plain``) on the touched ones equals
    the plain version on all cells within 1e-12 (only the order of the f64
    additions moves), for PTM, PTB and famod x outflow x regulation;
  * the clean kernel drops the red table: on the packs red is 0 or 1 and
    renorm is 0 wherever red is 0, so the clean plain version with and
    without the red multiply gives the same bits;
  * the port's IS3D (its plain versions on the CPU) still meets the JAX
    package's IS3D f64 route at B3's bar (1e-4) on 3+1d df 4 and df 5;
  * the pack scales the modified branch's 1/T_eff and alphaB_eff by
    log2(e) in f64, rounding each once, and the plain version, whose
    modified branch then takes 2^x of the argument in f32 as the kernels
    do, meets the f64 feqmod and famod engines at B3's bar on every case of
    kernel_check's FEQMOD_3D_CASES (512 cells of its 3+1d surfaces, 9 y).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import (BLOCK, CHOSEN, FAMOD_BULK, FAMOD_SHEAR,  # noqa: E402
                          FEQMOD_BULK, FEQMOD_SHEAR, build_workdir,
                          famod_state, feqmod_state, max_rel_err,
                          port_config, run_drivers)

from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import write_workdir  # noqa: E402

torch.set_num_threads(1)

N_Y = 9
S = len(CHOSEN)
SPLIT_TOL = 1e-12     # clean + touched vs all cells: the f64 sum's order
KINDS = ("df3", "df4", "famod")
FLAGS = [(0, 0), (1, 0), (0, 1), (1, 1)]     # (outflow, regulate_deltaf)


@pytest.fixture(scope="module")
def wd3(tmp_path_factory):
    return build_workdir(tmp_path_factory.mktemp("feqmod_3d_split"),
                         dimension=3, n_y=N_Y)


@pytest.fixture(scope="module")
def packs(wd3):
    """Each kind's port state, config and 3+1d operands."""
    out = {}
    for kind in KINDS:
        if kind == "famod":
            st = famod_state(wd3, dimension=3)
            cfg = port_config(st.cfg)
            ops = fk.famod_operands_3d(st.cells, st.fm, st.species, st.grid,
                                       cfg)
        else:
            st = feqmod_state(wd3, int(kind[-1]), dimension=3)
            cfg = port_config(st.cfg)
            ops = fk.feqmod_operands_3d(st.cells, st.fq, st.species,
                                        st.grid, cfg)
        out[kind] = (st, cfg, ops)
    return out


def _touched(ops) -> torch.Tensor:
    return ((ops.cols[:, fk.BREAKS_3] != 0)
            | (ops.cold[:, fk.WINDOW_3] != 0))


def _cfg(cfg, outflow, regulate):
    import dataclasses
    return dataclasses.replace(cfg, outflow=outflow,
                               regulate_deltaf=regulate)


@pytest.mark.parametrize("kind", KINDS)
def test_partition_puts_each_live_cell_in_one_set(packs, kind):
    st, _, ops = packs[kind]
    live = torch.nonzero(st.cells.mask > 0).squeeze(1)
    C = live.shape[0]
    n = int(ops.n_clean)
    order = ops.order
    assert ops.cols.shape[0] == C
    assert sorted(order.tolist()) == list(range(C))
    # each set keeps the live order
    assert torch.all(order[1:n] > order[:n - 1])
    assert torch.all(order[n + 1:] > order[n:-1])
    # the operands are the live cells in that order
    np.testing.assert_array_equal(ops.cold[:, fk.ETA_3].numpy(),
                                  st.cells.eta[live][order].numpy())
    touched = _touched(ops)
    assert not touched[:n].any() and touched[n:].all()
    assert 0 < n < C, "the surface has both clean and touched cells"
    assert int(fk.clean_count(ops.cols, ops.cold)) == n


@pytest.mark.parametrize("kind", KINDS)
def test_clean_cells_take_no_linearised_branch(packs, kind):
    _, _, ops = packs[kind]
    n = int(ops.n_clean)
    assert not (ops.cols[:n, fk.BREAKS_3] != 0).any()
    assert not ops.window()[:n].any()
    assert not (ops.cold[:n, fk.WINDOW_3] != 0).any()


def test_partition_clean_is_a_stable_sort():
    rng = np.random.default_rng(7)
    for p in (0.0, 0.08, 0.5, 1.0):
        touched = torch.as_tensor(rng.random(1000) < p)
        order, n_clean = fk.partition_clean(touched)
        want = torch.sort(touched.to(torch.int8), stable=True).indices
        assert torch.equal(order, want)
        assert n_clean.dtype == torch.int32
        assert int(n_clean) == int((~touched).sum())


def test_clean_count_is_the_leading_run():
    """On operands in any order the clean kernel takes the leading run of
    clean cells only; the mixed kernel takes every cell after it."""
    cols = torch.zeros((6, fk.N_COLS_3D), dtype=torch.float32)
    cold = torch.zeros((6, fk.N_COLD_3D), dtype=torch.float64)
    assert int(fk.clean_count(cols, cold)) == 6
    cols[4, fk.BREAKS_3] = 1.0
    assert int(fk.clean_count(cols, cold)) == 4
    cold[1, fk.WINDOW_3] = 0.005
    assert int(fk.clean_count(cols, cold)) == 1
    assert int(fk.clean_count(cols[:0], cold[:0])) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_first_cuts_the_live_order(packs, kind):
    """``first(n)``: the first n live cells before the partition, clean
    ones first, with their own count."""
    _, _, ops = packs[kind]
    n = 300
    cut = ops.first(n)
    assert sorted(cut.order.tolist()) == list(range(n))
    k = int(cut.n_clean)
    assert k == int(fk.clean_count(cut.cols, cut.cold))
    assert not _touched(cut)[:k].any() and _touched(cut)[k:].all()
    idx = torch.nonzero(ops.order < n).squeeze(1)
    assert torch.equal(cut.renorm, ops.renorm[idx])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("outflow,regulate", FLAGS)
def test_clean_plus_touched_is_the_plain_version(packs, kind, outflow,
                                                 regulate):
    _, cfg, ops = packs[kind]
    cfg = _cfg(cfg, outflow, regulate)
    n = int(ops.n_clean)
    args = ops.args()
    whole = fk.cooper_frye_feqmod_3d_plain(*args, cfg, ops.kind,
                                           **ops.layout())
    clean = fk.cooper_frye_feqmod_3d_clean_plain(
        ops.cols[:n], ops.cold[:n], ops.mom, ops.renorm[:n],
        ops.n_per_species, cfg)
    touched = fk.cooper_frye_feqmod_3d_plain(
        ops.cols[n:], ops.cold[n:], ops.mom, ops.y, ops.renorm[n:],
        ops.red[n:], ops.n_per_species, cfg, ops.kind, **ops.layout())
    split = (clean + touched).numpy().reshape(S, -1)
    whole = whole.numpy().reshape(S, -1)
    assert np.isfinite(split).all()
    assert max_rel_err(split, whole) <= SPLIT_TOL
    # the wrapper's CPU route is the plain version on all cells
    route = fk.cooper_frye_feqmod_3d(*args, cfg, ops.kind, **ops.layout())
    np.testing.assert_array_equal(route.numpy().reshape(S, -1), whole)


@pytest.mark.parametrize("kind", KINDS)
def test_red_is_a_mask_with_renorm_zero_where_it_is_zero(packs, kind):
    _, _, ops = packs[kind]
    assert bool(((ops.red == 0) | (ops.red == 1)).all())
    assert bool((ops.renorm[ops.red == 0] == 0).all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("outflow", [0, 1])
def test_dropping_red_is_exact(packs, kind, outflow):
    """The clean kernel multiplies by renorm alone: with red multiplied in
    as the mixed kernel does, its plain version gives the same bits.  The
    pack's red is all ones here, so a species with a non-finite renorm
    (red 0, renorm 0) is made on the copy."""
    _, cfg, ops = packs[kind]
    cfg = _cfg(cfg, outflow, 0)
    n = int(ops.n_clean)
    renorm, red = ops.renorm[:n].clone(), ops.red[:n].clone()
    renorm[::7, 2] = 0.0
    red[::7, 2] = 0.0
    args = (ops.cols[:n], ops.cold[:n], ops.mom, renorm, ops.n_per_species,
            cfg)
    without = fk.cooper_frye_feqmod_3d_clean_plain(*args)
    with_red = fk.cooper_frye_feqmod_3d_clean_plain(*args, red=red)
    assert torch.equal(without, with_red)
    assert bool((without != 0).any())


@pytest.mark.parametrize("df_mode", [4, 5])
def test_is3d_meets_the_jax_f64_route(tmp_path_factory, df_mode):
    """IS3D on a 3+1d workdir (B3's 3+1d plain version on the partitioned
    operands) against the JAX package's IS3D f64 route, at B3's bar."""
    if df_mode == 5:
        wd = build_workdir(tmp_path_factory.mktemp("split_df5"), dimension=3,
                           n_y=N_Y, eos_consistent=True,
                           shear_scale=FAMOD_SHEAR, bulk_scale=FAMOD_BULK,
                           params={"cell_block": BLOCK})
    else:
        wd = build_workdir(tmp_path_factory.mktemp("split_df4"), dimension=3,
                           n_y=N_Y, shear_scale=FEQMOD_SHEAR,
                           bulk_scale=FEQMOD_BULK,
                           params={"cell_block": BLOCK})
    ref, ours = run_drivers(wd, df_mode=df_mode, compute_dtype="f32")
    out, want = np.asarray(ours.spectra), np.asarray(ref.spectra)
    assert out.shape == want.shape == (S, 16, 8, N_Y)
    assert np.isfinite(out).all() and ours.report.breakdown_cells > 0
    assert max_rel_err(out, want) <= kc.FEQMOD_TOL_F64


@pytest.fixture(scope="module")
def wd_cases(tmp_path_factory):
    """kernel_check's 3+1d workdir of the card's tests: 8 species with
    baryons, 16 pT x 8 phi x 9 y."""
    return write_workdir(tmp_path_factory.mktemp("feqmod_3d_cases"),
                         n_cells=16,
                         chosen_mcids=(211, -211, 111, 321, -321, 2212,
                                       -2212, 3122),
                         n_pT=16, n_phi=8, n_y=9, dimension=3,
                         include_baryon=True, n_T=21, n_muB=9)


@pytest.mark.parametrize("kind", KINDS)
def test_pack_scales_the_exponent_columns_by_log2e_in_f64(packs, kind):
    """The modified branch's 1/T_eff and alphaB_eff (the famod prep's
    1/lambda and upsilonB) times log2(e), each rounded to f32 once from
    f64, and the species' baryon numbers whole, so that -(b alphaB_eff
    log2(e)) takes no rounding in the kernels."""
    st, _, ops = packs[kind]
    live = torch.nonzero(st.cells.mask > 0).squeeze(1)[ops.order]
    if kind == "famod":
        inv_t, alpha = 1.0 / st.fm.lam, st.fm.upsilonB
    else:
        inv_t, alpha = 1.0 / st.fq.T_mod, st.fq.alphaB_mod
    for col, want in ((fk.INVTEFF_3, inv_t), (fk.ALPHAB_EFF_3, alpha)):
        want = (fk.LOG2E * want.to(torch.float64))[live].to(torch.float32)
        assert torch.equal(ops.cols[:, col], want)
    b = ops.mom[fk.MOM_ROWS_3D.index("b")]
    assert torch.equal(b, torch.round(b)) and bool((b.abs() <= 1).all())


@pytest.mark.parametrize("case", list(kc.FEQMOD_3D_CASES))
def test_prescaled_exp2_meets_the_f64_engine(wd_cases, case):
    """The modified branch's exponential as the kernels take it, 2^x of
    E_mod log2(e) / T_eff - b alphaB_eff log2(e) in f32 from the pack's
    pre-scaled columns, on clean and touched cells: the plain version
    against the f64 engine within FEQMOD_TOL_F64."""
    cfg, state, ops = kc.feqmod_3d_operands(wd_cases, case, 512, 3, "cpu",
                                            cell_block=512)
    assert 0 < int(ops.n_clean) < ops.cols.shape[0]
    plain = fk.cooper_frye_feqmod_3d_plain(*ops.args(), cfg, ops.kind,
                                           **ops.layout())
    out = kc.spectra_units(state, plain)
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, kc.f64_3d(state, cfg)) <= kc.FEQMOD_TOL_F64
