"""The CUDA kernels B1, B2, B3 and P1 on the card, against their plain
torch versions and the port's f64 engines, through the shared harness
tools/kernel_check.py.

Imports nothing of JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: tests/conftest.py imports jax).  Without a CUDA device the
`gpu` tests skip; the CPU test runs the same harness through the kernel's
plain version.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_comp as ck  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_f32 as b2  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.ops import polarization_f32 as pz  # noqa: E402
from is3d2_tpu_torch.ops.launch_geometry import df12_flags  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import (  # noqa: E402
    comp_operands, f32_operands)
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import make_surface, write_workdir  # noqa: E402

CHOSEN = (211, -211, 111, 321, -321, 2212, -2212, 3122)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return write_workdir(tmp_path_factory.mktemp("torch_gpu"), n_cells=16,
                         chosen_mcids=CHOSEN, n_pT=16, n_phi=8, n_eta=24,
                         include_baryon=True, n_T=21, n_muB=9)


@pytest.fixture(scope="module")
def ragged_workdir(tmp_path_factory):
    """3 pT x 7 phi: a phi count no register tile divides, and 168 momenta
    in all, fewer than one block's share."""
    return write_workdir(tmp_path_factory.mktemp("torch_gpu_ragged"),
                         n_cells=16, chosen_mcids=CHOSEN, n_pT=3, n_phi=7,
                         n_eta=24, include_baryon=True, n_T=21, n_muB=9)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(kc.CASES))
def test_cuda_kernel_vs_plain_and_f64(workdir, case):
    _needs_cuda()
    r = kc.check_case(workdir, case, 512, 3, "cuda", cell_block=512)
    assert r.launches == 1
    assert np.isfinite(r.kernel).all()
    assert r.vs_plain <= kc.TOL
    assert r.vs_f64 <= kc.TOL
    # deterministic: no atomics, the same bits on every launch
    assert r.repeats


@pytest.mark.gpu
def test_cuda_kernel_ragged_tiles(workdir):
    """Cell and momentum counts that fill neither the last 64-cell tile nor
    the last 256-thread block."""
    _needs_cuda()
    cfg = Config(compute_dtype="f32c", df_mode=1, cell_block=512)
    state = kc.engine_state(workdir, cfg, make_surface(512, seed=5), "cuda")
    ops = comp_operands(*state, cfg)
    args = (ops.cell[:100].contiguous(), ops.qm[:100].contiguous(), ops.eta,
            ops.eta_w, ops.mom[:, :1000].contiguous(), cfg)
    out = ck.cooper_frye_comp(*args).cpu().numpy()[None]
    plain = ck.cooper_frye_comp_plain(*args).cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.TOL


def _b1_operands(workdir, n_surface=512, device="cuda", **cfg_fields):
    cfg = Config(compute_dtype="f32c", cell_block=512,
                 **{"df_mode": 1, **cfg_fields})
    surf = make_surface(n_surface, seed=5,
                        include_baryon=bool(cfg.include_baryon))
    return comp_operands(*kc.engine_state(workdir, cfg, surf, device),
                         cfg), cfg


def _b1_agrees(args):
    out = ck.cooper_frye_comp(*args)
    again = ck.cooper_frye_comp(*args)
    plain = ck.cooper_frye_comp_plain(*args).cpu().numpy()[None]
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n_cells,n_mom", [(100, 168), (70, 100), (333, 165),
                                           (1, 7), (512, 5)])
def test_cuda_kernel_ragged_rows_and_splits(ragged_workdir, n_cells, n_mom):
    """Rows of 7 phi under a register tile of 4, a momentum count that stops
    inside a row and stays below one block, and cell counts that fill
    neither the last 64-cell tile nor the last split."""
    _needs_cuda()
    ops, cfg = _b1_operands(ragged_workdir)
    g = ck.geometry(ops.mom[:, :n_mom].contiguous(), n_cells)
    assert g.row_len == min(7, n_mom) and g.blocks == 1
    _b1_agrees((ops.cell[:n_cells].contiguous(), ops.qm[:n_cells].contiguous(),
                ops.eta, ops.eta_w, ops.mom[:, :n_mom].contiguous(), cfg))


def _b1_eta_args(ops, cfg, n_eta):
    """B1's arguments on an eta table of n_eta nodes: the 12 folded nodes
    repeated (another quadrature, as good as any for a comparison)."""
    reps = -(-n_eta // ops.eta.shape[0])
    return (ops.cell, ops.qm.repeat(1, reps, 1)[:, :n_eta].contiguous(),
            ops.eta.repeat(reps, 1)[:n_eta].contiguous(),
            ops.eta_w.repeat(reps)[:n_eta].contiguous(), ops.mom, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("n_eta", [1, 32, 33, 80])
def test_cuda_kernel_eta_counts(workdir, n_eta):
    """One eta node, the most one launch takes, and more: one launch per
    chunk of at most 32 nodes."""
    _needs_cuda()
    ops, cfg = _b1_operands(workdir)
    before = ck.cooper_frye_comp.launches
    _b1_agrees(_b1_eta_args(ops, cfg, n_eta))
    assert ck.cooper_frye_comp.launches - before == 2 * -(-n_eta // 32)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", range(32))
def test_cuda_kernel_every_template_combination(workdir, flags):
    """Each of the 32 instantiations (shear, diffusion, regulate, outflow,
    df 2) launches and agrees with the plain version."""
    _needs_cuda()
    shear, diffusion, regulate, outflow, df2 = ((flags >> i) & 1
                                                for i in range(5))
    ops, cfg = _b1_operands(
        workdir, 200, df_mode=2 if df2 else 1, include_shear_deltaf=shear,
        include_baryon=1, include_baryondiff_deltaf=diffusion,
        regulate_deltaf=regulate, outflow=outflow)
    assert df12_flags(cfg) == flags
    _b1_agrees((*ops.args(), cfg))


@pytest.mark.parametrize("case", list(kc.CASES))
def test_kernel_check_plain_on_cpu(workdir, case):
    """The harness on the CPU: the wrapper takes the plain version (no
    launch) and it meets the f64 engine within TOL."""
    r = kc.check_case(workdir, case, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0
    assert r.vs_plain == 0.0
    assert r.ok, (r.vs_f64, r.plain_vs_f64)


# ----------------------------------------------------------------------
# kernel B3
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", list(kc.FEQMOD_CASES))
def test_feqmod_kernel_vs_plain_and_f64(workdir, case):
    _needs_cuda()
    r = kc.check_feqmod_case(workdir, case, 512, 3, "cuda", cell_block=512)
    assert r.launches == 1
    assert r.breakdown_cells > 0
    assert np.isfinite(r.kernel).all()
    assert r.vs_plain <= kc.FEQMOD_TOL_PLAIN
    assert r.vs_f64 <= kc.FEQMOD_TOL_F64
    assert r.repeats


@pytest.mark.gpu
def test_feqmod_kernel_famod_mode(workdir):
    """B3's famod mode on the real famod prep (the VAH reconstruction of
    an EOS-consistent surface, 2,048 cells): <= 1e-5 against its plain
    version and <= 1e-4 against the f64 famod engine."""
    _needs_cuda()
    r = kc.check_famod_case(workdir, 2048, 3, "cuda", cell_block=512)
    assert r.launches == 1 and r.repeats and r.breakdown_cells > 0
    assert np.isfinite(r.kernel).all()
    assert r.vs_plain <= kc.FEQMOD_TOL_PLAIN
    assert r.vs_f64 <= kc.FEQMOD_TOL_F64


@pytest.mark.gpu
def test_famod_kernel_ragged_case(workdir):
    """The famod operands cut to kc.RAGGED (rows of 7 phi, 105 momenta,
    1,000 cells)."""
    _needs_cuda()
    r = kc.check_famod_ragged_case(workdir, 2048, 3, "cuda")
    assert r.ok and r.launches == 1, (r.vs_plain, r.breakdown_cells)


@pytest.fixture(scope="module")
def workdir_eta80(workdir, tmp_path_factory):
    """The workdir with an eta table of kc.ETA_NODES nodes."""
    import shutil
    from is3d2_tpu_torch.tools.synthetic import write_quadrature_tables
    wd = shutil.copytree(workdir, tmp_path_factory.mktemp("gpu_eta") / "wd")
    write_quadrature_tables(wd, 16, 8, kc.ETA_NODES)
    return wd


@pytest.mark.gpu
def test_famod_kernel_80_eta_nodes_unfolded(workdir_eta80):
    """80 eta nodes, not folded: three launches of at most 32 nodes, held
    to the plain version and the f64 famod engine."""
    _needs_cuda()
    r = kc.check_famod_case(workdir_eta80, 2048, 3, "cuda", cell_block=512,
                            eta_fold=0)
    assert r.launches == -(-kc.ETA_NODES // fk.ETA_CHUNK) and r.repeats
    assert r.vs_plain <= kc.FEQMOD_TOL_PLAIN
    assert r.vs_f64 <= kc.FEQMOD_TOL_F64


@pytest.mark.gpu
def test_famod_kernel_on_a_mode3_surface(workdir, tmp_path):
    """A mode-3 surface (its own Lambda, aT, aL: no Newton) through the
    kernel: <= 1e-5 against the plain version, <= 1e-4 against f64."""
    _needs_cuda()
    from is3d2_tpu_torch.io.surface import read_surface
    from is3d2_tpu_torch.tools.synthetic import write_vah_surface
    from is3d2_tpu_torch.io.pdg import read_pdg
    surf = kc.famod_surface(workdir, 2048, 3, "cuda")
    path = tmp_path / "surface_mode3.dat"
    write_vah_surface(surf, path, 3, read_pdg(3, workdir / "PDG"), "cuda")
    surf3 = read_surface(path, 3, 2, False)
    assert surf3.has_aniso_variables
    r = kc.check_famod_case(workdir, 2048, 3, "cuda", surf=surf3,
                            cell_block=512, mode=3)
    assert r.launches == 1 and r.repeats and np.isfinite(r.kernel).all()
    assert r.vs_plain <= kc.FEQMOD_TOL_PLAIN
    assert r.vs_f64 <= kc.FEQMOD_TOL_F64


def test_famod_kernel_check_plain_on_cpu(workdir):
    """The famod harness on the CPU: the wrapper takes the plain version
    (no launch), which meets the f64 famod engine on the real prep."""
    r = kc.check_famod_case(workdir, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0 and r.vs_plain == 0.0
    assert r.ok, (r.vs_f64, r.breakdown_cells)


@pytest.mark.gpu
def test_feqmod_kernel_ragged_tiles(workdir):
    """100 cells and 1,000 momenta: neither the last 16-cell tile nor the
    last 256-thread block is full, and M stops inside the last species."""
    _needs_cuda()
    cfg = Config(compute_dtype="f32", df_mode=3, cell_block=512)
    surf = make_surface(512, seed=5, **kc.FEQMOD_SURFACE)
    state = kc.feqmod_engine_state(workdir, cfg, surf, "cuda")
    ops = fk.feqmod_operands(*state, cfg)
    args = (ops.cols[:100].contiguous(), ops.mom[:, :1000].contiguous(),
            ops.renorm[:100].contiguous(), ops.red[:100].contiguous(),
            ops.eta, ops.n_per_species, cfg, ops.kind)
    assert bool(state[1].breaks_down[:100].any())
    out = fk.cooper_frye_feqmod(*args).cpu().numpy()[None]
    plain = fk.cooper_frye_feqmod_plain(*args).cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.FEQMOD_TOL_PLAIN


def _b3_operands(workdir, df_mode=3, device="cuda", **cfg_fields):
    cfg = Config(compute_dtype="f32", df_mode=df_mode, cell_block=512,
                 **cfg_fields)
    surf = make_surface(512, seed=5, **kc.FEQMOD_SURFACE)
    state = kc.feqmod_engine_state(workdir, cfg, surf, device)
    return fk.feqmod_operands(*state, cfg), cfg


def _b3_eta_args(ops, cfg, n_eta):
    """B3's arguments on the folded nodes repeated to n_eta nodes."""
    reps = -(-n_eta // ops.eta.shape[0])
    return (ops.cols, ops.mom, ops.renorm, ops.red,
            ops.eta.repeat(reps, 1)[:n_eta].contiguous(), ops.n_per_species,
            cfg, ops.kind)


def _b3_agrees(args):
    out = fk.cooper_frye_feqmod(*args)
    again = fk.cooper_frye_feqmod(*args)
    plain = fk.cooper_frye_feqmod_plain(*args).cpu().numpy()[None]
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.FEQMOD_TOL_PLAIN


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode", [3, 4])
@pytest.mark.parametrize("n_cells,n_mom", [(100, 168), (70, 100), (333, 165),
                                           (1, 7), (512, 26)])
def test_feqmod_kernel_ragged_rows_and_splits(ragged_workdir, df_mode,
                                              n_cells, n_mom):
    """As for B1: rows of 7 phi, a momentum count that stops inside a row
    (and inside a species) below one block, ragged cell tiles and splits;
    one block spans all eight species."""
    _needs_cuda()
    ops, cfg = _b3_operands(ragged_workdir, df_mode)
    mom = ops.mom[:, :n_mom].contiguous()
    fg = fk.geometry(mom, ops.n_per_species, ops.renorm.shape[1], n_cells,
                     ops.eta.shape[0])
    assert fg.grid.row_len == 7 and fg.grid.blocks == 1
    _b3_agrees((ops.cols[:n_cells].contiguous(), mom,
                ops.renorm[:n_cells].contiguous(),
                ops.red[:n_cells].contiguous(), ops.eta, ops.n_per_species,
                cfg, ops.kind))


@pytest.mark.gpu
@pytest.mark.parametrize("n_eta", [1, 32, 33, 80])
def test_feqmod_kernel_eta_counts(workdir, n_eta):
    """One eta node, the most one launch takes, and more: one launch per
    chunk of at most 32 nodes."""
    _needs_cuda()
    ops, cfg = _b3_operands(workdir, 4)
    assert bool((ops.cols[:, fk.BREAKS] != 0).any())
    before = fk.cooper_frye_feqmod.launches
    _b3_agrees(_b3_eta_args(ops, cfg, n_eta))
    assert fk.cooper_frye_feqmod.launches - before == 2 * -(-n_eta // 32)


@pytest.mark.gpu
def test_feqmod_kernel_hands_a_nan_on(workdir):
    """A NaN effective temperature on a cell that takes the modified branch
    reaches the sum, as in the plain version: the clamp of exp + sign must
    not swallow it."""
    _needs_cuda()
    ops, cfg = _b3_operands(workdir, 4)
    cols = ops.cols.clone()
    cell = int(torch.nonzero(cols[:, fk.BREAKS] == 0)[0])
    cols[cell, fk.INVTEFF] = float("nan")
    args = (cols, ops.mom, ops.renorm, ops.red, ops.eta, ops.n_per_species,
            cfg, ops.kind)
    assert bool(torch.isnan(fk.cooper_frye_feqmod(*args)).all())
    assert bool(torch.isnan(fk.cooper_frye_feqmod_plain(*args)).all())


@pytest.mark.parametrize("case", list(kc.FEQMOD_CASES))
def test_feqmod_kernel_check_plain_on_cpu(workdir, case):
    """The B3 harness on the CPU: the wrapper takes the plain version (no
    launch), it meets the f64 engine, and the surface breaks down."""
    r = kc.check_feqmod_case(workdir, case, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0
    assert r.vs_plain == 0.0
    assert r.ok, (r.vs_f64, r.breakdown_cells)


# ----------------------------------------------------------------------
# kernel B2
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", list(kc.F32_CASES))
def test_f32_kernel_vs_plain_and_f64(workdir, case):
    _needs_cuda()
    r = kc.check_f32_case(workdir, case, 512, 3, "cuda", cell_block=512)
    assert r.launches == 1
    assert np.isfinite(r.kernel).all()
    assert r.vs_plain <= kc.F32_TOL_PLAIN
    assert r.vs_f64 <= kc.F32_TOL_F64
    assert r.repeats


@pytest.mark.gpu
def test_f32_kernel_ragged_tiles(workdir):
    """100 cells and 1,000 momenta: neither the last 64-cell tile nor the
    last 256-thread block is full."""
    _needs_cuda()
    cfg = Config(compute_dtype="f64", use_pallas=1, df_mode=2,
                 include_baryon=1, include_baryondiff_deltaf=1,
                 cell_block=512)
    surf = make_surface(512, seed=5, include_baryon=True)
    ops = f32_operands(*kc.engine_state(workdir, cfg, surf, "cuda"), cfg)
    args = (ops.cell[:100].contiguous(), ops.eta, ops.eta_w,
            ops.mom[:, :1000].contiguous(), cfg)
    out = b2.cooper_frye_f32(*args).cpu().numpy()[None]
    plain = b2.cooper_frye_f32_plain(*args).cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.F32_TOL_PLAIN


def _b2_operands(workdir, n_surface=512, device="cuda", **cfg_fields):
    cfg = Config(compute_dtype="f64", use_pallas=1, cell_block=512,
                 **{"df_mode": 2, **cfg_fields})
    surf = make_surface(n_surface, seed=5,
                        include_baryon=bool(cfg.include_baryon))
    return f32_operands(*kc.engine_state(workdir, cfg, surf, device),
                        cfg), cfg


def _b2_eta_args(ops, cfg, n_eta):
    """B2's arguments on the folded nodes repeated to n_eta nodes."""
    reps = -(-n_eta // ops.eta.shape[0])
    return (ops.cell, ops.eta.repeat(reps, 1)[:n_eta].contiguous(),
            ops.eta_w.repeat(reps)[:n_eta].contiguous(), ops.mom, cfg)


def _b2_agrees(args):
    out = b2.cooper_frye_f32(*args)
    again = b2.cooper_frye_f32(*args)
    plain = b2.cooper_frye_f32_plain(*args).cpu().numpy()[None]
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.F32_TOL_PLAIN


@pytest.mark.gpu
@pytest.mark.parametrize("n_cells,n_mom", [(100, 168), (70, 100), (333, 165),
                                           (1, 7), (512, 5)])
def test_f32_kernel_ragged_rows_and_splits(ragged_workdir, n_cells, n_mom):
    """As for B1: rows of 7 phi under a register tile of 4, a momentum
    count that stops inside a row and stays below one block, and cell
    counts that fill neither the last 64-cell tile nor the last split."""
    _needs_cuda()
    ops, cfg = _b2_operands(ragged_workdir)
    g = b2.geometry(ops.mom[:, :n_mom].contiguous(), n_cells)
    assert g.row_len == min(7, n_mom) and g.blocks == 1
    _b2_agrees((ops.cell[:n_cells].contiguous(), ops.eta, ops.eta_w,
                ops.mom[:, :n_mom].contiguous(), cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("n_eta", [1, 32, 33, 80])
def test_f32_kernel_eta_counts(workdir, n_eta):
    """One eta node, the most one launch takes, and more: one launch per
    chunk of at most 32 nodes."""
    _needs_cuda()
    ops, cfg = _b2_operands(workdir)
    before = b2.cooper_frye_f32.launches
    _b2_agrees(_b2_eta_args(ops, cfg, n_eta))
    assert b2.cooper_frye_f32.launches - before == 2 * -(-n_eta // 32)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", range(32))
def test_f32_kernel_every_template_combination(workdir, flags):
    """Each of the 32 instantiations (shear, diffusion, regulate, outflow,
    df 2) launches and agrees with the plain version."""
    _needs_cuda()
    shear, diffusion, regulate, outflow, df2 = ((flags >> i) & 1
                                                for i in range(5))
    ops, cfg = _b2_operands(
        workdir, 200, df_mode=2 if df2 else 1, include_shear_deltaf=shear,
        include_baryon=1, include_baryondiff_deltaf=diffusion,
        regulate_deltaf=regulate, outflow=outflow)
    assert df12_flags(cfg) == flags
    _b2_agrees((*ops.args(), cfg))


@pytest.mark.gpu
def test_f32_kernel_hands_a_nan_on(workdir):
    """A NaN temperature on a live cell reaches the sum, as in the plain
    version: the clamp of exp + sign must not swallow it."""
    _needs_cuda()
    ops, cfg = _b2_operands(workdir)
    cell = ops.cell.clone()
    live = int(torch.nonzero(cell[:, b2.CELL_COLS.index("qd0")] != 0)[0])
    cell[live, b2.CELL_COLS.index("invT")] = float("nan")
    args = (cell, ops.eta, ops.eta_w, ops.mom, cfg)
    assert bool(torch.isnan(b2.cooper_frye_f32(*args)).all())
    assert bool(torch.isnan(b2.cooper_frye_f32_plain(*args)).all())


@pytest.mark.parametrize("case", list(kc.F32_CASES))
def test_f32_kernel_check_plain_on_cpu(workdir, case):
    """The B2 harness on the CPU: the wrapper takes the plain version (no
    launch) and it meets the f64 engine within F32_TOL_F64."""
    r = kc.check_f32_case(workdir, case, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0
    assert r.vs_plain == 0.0
    assert r.ok, r.vs_f64


# ----------------------------------------------------------------------
# more eta nodes than one launch takes
# ----------------------------------------------------------------------

def _eta_args(workdir, kernel, n_eta, device):
    """(wrapper, plain version, chunk, arguments on n_eta eta nodes) of one
    kernel, on 128 cells."""
    if kernel == "b1":
        ops, cfg = _b1_operands(workdir, 128, device)
        return (ck.cooper_frye_comp, ck.cooper_frye_comp_plain, ck.ETA_CHUNK,
                _b1_eta_args(ops, cfg, n_eta))
    if kernel == "b2":
        ops, cfg = _b2_operands(workdir, 128, device)
        return (b2.cooper_frye_f32, b2.cooper_frye_f32_plain, b2.ETA_CHUNK,
                _b2_eta_args(ops, cfg, n_eta))
    ops, cfg = _b3_operands(workdir, 4, device)
    return (fk.cooper_frye_feqmod, fk.cooper_frye_feqmod_plain, fk.ETA_CHUNK,
            _b3_eta_args(ops, cfg, n_eta))


def _eta_slice(kernel, args, e0, e1):
    """The arguments of one chunk [e0, e1) of the eta table."""
    if kernel == "b1":
        cell, qm, eta, eta_w, mom, cfg = args
        return (cell, qm[:, e0:e1].contiguous(), eta[e0:e1], eta_w[e0:e1],
                mom, cfg)
    if kernel == "b2":
        cell, eta, eta_w, mom, cfg = args
        return cell, eta[e0:e1], eta_w[e0:e1], mom, cfg
    return (*args[:4], args[4][e0:e1], *args[5:])


@pytest.mark.parametrize("kernel", ["b1", "b2", "b3"])
def test_chunked_plain_version_is_the_sum_of_its_chunks(workdir, kernel):
    """On 80 eta nodes the plain version is, bit for bit, the sum in chunk
    order of its calls on nodes 0-31, 32-63 and 64-79, and the wrapper on
    CPU tensors gives the same bits without a launch."""
    wrapper, plain, chunk, args = _eta_args(workdir, kernel, 80, "cpu")
    assert chunk == 32
    by_hand = plain(*_eta_slice(kernel, args, 0, 32))
    by_hand = by_hand + plain(*_eta_slice(kernel, args, 32, 64))
    by_hand = by_hand + plain(*_eta_slice(kernel, args, 64, 80))
    assert torch.equal(plain(*args), by_hand)
    before = wrapper.launches
    assert torch.equal(wrapper(*args), by_hand)
    assert wrapper.launches == before


# ----------------------------------------------------------------------
# the sampler (operation 2) on the card
# ----------------------------------------------------------------------

def _sampler_run(tmp_path, device, df_mode=1):
    """A set-up driver on the 60-cell sampler workdir (pi+, K+, p)."""
    from is3d2_tpu_torch.driver import IS3D
    wd = write_workdir(tmp_path / f"sampler_{device}_{df_mode}", n_cells=60,
                       chosen_mcids=(211, 321, 2212), n_pT=8, n_phi=8,
                       n_T=21, shear_scale=0.2 if df_mode > 2 else 0.03,
                       bulk_scale=0.1 if df_mode > 2 else 0.01,
                       params={"operation": 2, "df_mode": df_mode,
                               "cell_block": 64})
    run = IS3D(wd, device=device)
    run.load_surface_from_file()
    run._setup()
    return run


def _campaign(run, n_events, seed, **kw):
    from is3d2_tpu_torch.core import sampler as ps
    return ps.sample_particles(run.surface, run.species, run.chosen_idx,
                               run.df_data, run.cfg, run.laguerre, n_events,
                               run.device, seed=seed, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode", [1, 4])
def test_sampler_repeats_its_bits_on_cuda(tmp_path, df_mode):
    _needs_cuda()
    run = _sampler_run(tmp_path, "cuda", df_mode)
    a, b = _campaign(run, 2000, 5), _campaign(run, 2000, 5)
    assert a["kept"] == b["kept"] > 0
    for k in ("event", "sp_idx", "px", "py", "pz", "E", "eta", "x"):
        assert a[k].is_cuda and torch.equal(a[k], b[k]), k
    c = _campaign(run, 2000, 6)
    assert c["kept"] != a["kept"] or not torch.equal(c["px"], a["px"])


@pytest.mark.gpu
def test_sampler_cuda_and_cpu_agree_on_dN_dy(tmp_path):
    """The card's and the CPU's campaigns (different generators) give the
    same dN/dy per species within 5 sigma of the difference."""
    _needs_cuda()
    from is3d2_tpu_torch.core.sampler_hist import bin_sampled_particles
    n_events = 20000
    counts = {}
    for device in ("cuda", "cpu"):
        run = _sampler_run(tmp_path, device)
        out = _campaign(run, n_events, 3)
        counts[device] = bin_sampled_particles(out, 3, run.cfg,
                                               n_events).dN_dy.sum(axis=1)
    a, b = counts["cuda"].astype(float), counts["cpu"].astype(float)
    assert (a > 3000).all()
    assert (np.abs(a - b) < 5.0 * np.sqrt(a + b)).all(), (a, b)


@pytest.mark.gpu
def test_alias_draw_on_cuda_reproduces_the_categorical():
    """draw_species on the card: the species frequencies of hadrons drawn
    in each of 4 cells match the cells' rates within 5 sigma."""
    _needs_cuda()
    from is3d2_tpu_torch.core import sampler as ps
    rng = np.random.default_rng(0)
    C, S, per_cell = 4, 37, 400_000
    rates = torch.as_tensor(rng.lognormal(0.0, 1.5, (C, S)) *
                            (rng.random((C, S)) > 0.3), device="cuda")
    prob, alias = ps.species_alias(rates)
    camp = types.SimpleNamespace(prob=prob, alias=alias, n_species=S)
    cell_idx = torch.arange(C, device="cuda").repeat_interleave(per_cell)
    gen = ps.chunk_generator(1, 0, "cuda")
    sp = ps.draw_species(camp, cell_idx, gen)
    counts = torch.bincount(cell_idx * S + sp, minlength=C * S).reshape(C, S)
    p = (rates / rates.sum(dim=1, keepdim=True)).cpu().numpy()
    expect = p * per_cell
    got = counts.cpu().numpy()
    assert (got[p == 0] == 0).all()
    sigma = np.sqrt(np.maximum(expect * (1 - p), 1.0))
    assert (np.abs(got - expect) < 5.0 * sigma).all()


# ----------------------------------------------------------------------
# operation 0 (dN/dX): B1 and B3's dan-weighted convention on bins
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cfg_fields,surface_kw", [
    ({"df_mode": 1, "compute_dtype": "f32c"}, {}),
    ({"df_mode": 2, "compute_dtype": "f32c", "outflow": 1}, {}),
    ({"df_mode": 4, "compute_dtype": "f32"}, kc.FEQMOD_SURFACE),
    ({"df_mode": 3, "compute_dtype": "f32", "outflow": 1},
     kc.FEQMOD_SURFACE)])
def test_dX_kernel_route_vs_plain_and_f64(workdir, cfg_fields, surface_kw):
    """Operation 0 at 2,048 cells with dsigma_eta != 0: the kernel on every
    non-empty bin against its plain version and the f64 engines' binned
    per-cell sums (B1 <= 1e-6 both; B3 <= 1e-5 and <= 1e-4)."""
    _needs_cuda()
    from is3d2_tpu_torch.config import Config as C
    cfg = C(operation=0, cell_block=512, **cfg_fields)
    r = kc.check_dX_case(workdir, cfg, 2048, 3, "cuda", **surface_kw)
    assert r.launches == r.bins > 0
    assert r.ok, (r.vs_plain, r.vs_f64)
    if cfg.df_mode in (3, 4):
        assert r.breakdown_cells > 0


def _dX_b1_slice(workdir, n_cells=300):
    """B1's operand rows of the first n_cells cells of the fullest of 20
    tau bins (sorted by bin as the route does), on the card."""
    from is3d2_tpu_torch.config import Config as C
    from is3d2_tpu_torch.core import spacetime
    from is3d2_tpu_torch.tools.synthetic import add_dsigma_eta
    cfg = C(operation=0, df_mode=1, compute_dtype="f32c", cell_block=512,
            tau_bins=20)
    surf = add_dsigma_eta(make_surface(8192, seed=3), 3, kc.DX_DAN)
    state = kc.engine_state(workdir, cfg, surf, "cuda")
    ops = spacetime.kernel_operands(*state, cfg)
    idx, n = spacetime.bin_indices(state[0], cfg)[0]
    rows, runs = spacetime.binned_cells(idx, n, state[0].mask.cpu().numpy())
    b, begin, end = max(runs, key=lambda r: r[2] - r[1])
    assert end - begin >= n_cells
    sorted_ops = spacetime.cell_rows(ops, torch.as_tensor(rows,
                                                          device="cuda"))
    return spacetime.cell_rows(sorted_ops, slice(begin, begin + n_cells)), cfg


@pytest.mark.gpu
def test_b1_on_a_300_cell_bin_slice(workdir):
    """300 cells of one bin, all momenta: one launch, <= 1e-6 against the
    plain version, the same bits twice."""
    _needs_cuda()
    from is3d2_tpu_torch.core import spacetime
    ops, cfg = _dX_b1_slice(workdir)
    assert ops.cell.shape[0] == 300 and ops.cell.is_contiguous()
    before = ck.cooper_frye_comp.launches
    out = spacetime.run_kernel(ops, cfg)
    assert ck.cooper_frye_comp.launches - before == 1
    assert torch.equal(out, spacetime.run_kernel(ops, cfg))
    plain = spacetime.run_kernel(ops, cfg, plain=True)
    S = 8
    assert kc.max_rel_err(out.reshape(S, -1).cpu().numpy(),
                          plain.reshape(S, -1).cpu().numpy()) <= kc.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n_eta", [33, 80])
def test_feqmod_kernel_dan_weighted_flag(workdir, n_eta):
    """B3's dan-weighted variant on a surface with dsigma_eta != 0 (the
    strict fold refuses it: 24 nodes repeated to n_eta) and outflow, where
    the convention decides the number: each variant against its plain
    version (<= 1e-5), and the two variants apart."""
    _needs_cuda()
    from is3d2_tpu_torch.tools.synthetic import add_dsigma_eta
    cfg = Config(compute_dtype="f32", df_mode=4, outflow=1, cell_block=512)
    surf = add_dsigma_eta(make_surface(512, seed=5, **kc.FEQMOD_SURFACE), 5,
                          kc.DX_DAN)
    state = kc.feqmod_engine_state(workdir, cfg, surf, "cuda")
    outs = {}
    for dan in (False, True):
        ops = fk.feqmod_operands(*state, cfg, dan_weighted=dan)
        assert ops.eta.shape[0] == 24 and ops.dan_weighted == dan
        args = _b3_eta_args(ops, cfg, n_eta)
        out = fk.cooper_frye_feqmod(*args, dan_weighted=dan)
        plain = fk.cooper_frye_feqmod_plain(*args, dan_weighted=dan)
        assert kc.max_rel_err(out.cpu().numpy()[None],
                              plain.cpu().numpy()[None]) \
            <= kc.FEQMOD_TOL_PLAIN
        outs[dan] = out.cpu().numpy()[None]
    assert kc.max_rel_err(outs[True], outs[False]) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode,dtype", [(1, "f32c"), (4, "f32"),
                                           (2, "f64")])
def test_grouped_equals_ungrouped_on_exact_multiplets(workdir, df_mode,
                                                      dtype):
    """group_particles on the card (B1, B3, B2 with use_pallas = 1): the
    species whose (mass, sign, baryon) equal their representative's match
    the ungrouped run to 1e-12."""
    _needs_cuda()
    from is3d2_tpu_torch.core.spectra import compute_spectra
    from is3d2_tpu_torch.driver import IS3D
    chosen = (2212, 2224, 2214, 2114, 1114, 3224, 3214, 3114, 211, -211)
    wd = write_workdir(workdir.parent / f"group_{df_mode}", n_cells=16,
                       chosen_mcids=chosen, n_pT=16, n_phi=8, n_T=21)
    cfg = Config(df_mode=df_mode, compute_dtype=dtype, cell_block=512,
                 use_pallas=1 if dtype == "f64" else -1)
    run = IS3D(wd, cfg=cfg, device="cuda")
    run.surface = make_surface(2048, seed=3, **(kc.FEQMOD_SURFACE
                                                if df_mode == 4 else {}))
    run._setup()
    idx = run.chosen_idx
    args = (run.surface, run.species, idx, run.grids, run.df_data)
    plain_run = compute_spectra(*args, cfg, "cuda", run.laguerre)
    grouped = compute_spectra(*args, dataclasses.replace(
        cfg, group_particles=1), "cuda", run.laguerre)
    rep, group_of = run.species.group_species(idx, 0.01, False)
    key = np.stack([run.species.mass, run.species.sign,
                    run.species.baryon], axis=1)
    exact = [i for i in range(len(idx))
             if (key[idx[i]] == key[idx[rep[group_of[i]]]]).all()]
    # the representatives, pi-, 3 more Deltas and 2 more Sigma*s
    assert len(exact) == len(rep) + 6
    assert kc.max_rel_err(grouped[exact], plain_run[exact]) <= 1e-12


# ----------------------------------------------------------------------
# kernel P1 (spin polarization, mode 5)
# ----------------------------------------------------------------------

def _polarization_operands(workdir, n_surface=512, device="cuda"):
    cfg = Config(compute_dtype="f32c", mode=5, cell_block=512)
    state = kc.polarization_engine_state(
        workdir, cfg, make_surface(n_surface, seed=5, vorticity=True),
        device)
    return pz.pack_inputs(*state)


def _p1_agrees(args):
    out = pz.polarization_f32(*args)
    again = pz.polarization_f32(*args)
    plain = pz.polarization_f32_plain(*args).cpu().numpy()
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()
    assert np.isfinite(out).all()
    assert max(kc.polarization_errors(out, plain)) <= kc.POLZN_TOL_PLAIN


@pytest.mark.gpu
def test_polarization_kernel_vs_plain_and_f64(workdir):
    """P1 at 512 cells: <= 1e-5 against its plain version on both metrics,
    Snorm <= 2e-5 and P <= 1e-5 of max |P| against the f64 engine, one
    launch, the same bits twice."""
    _needs_cuda()
    r = kc.check_polarization_case(workdir, 512, 3, "cuda", cell_block=512)
    assert r.launches == 1 and r.repeats
    assert r.ok, (r.vs_plain, r.vs_f64)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cells,n_mom", [(100, 168), (70, 100), (333, 165),
                                           (1, 7), (512, 5)])
def test_polarization_kernel_ragged_rows_and_splits(ragged_workdir, n_cells,
                                                    n_mom):
    """Rows of 7 phi under a register tile of 4, momentum counts that stop
    inside a row, cell counts that fill neither the last tile nor the last
    split."""
    _needs_cuda()
    ops = _polarization_operands(ragged_workdir)
    g = pz.geometry(ops.mom[:, :n_mom].contiguous(), n_cells)
    assert g.row_len == min(7, n_mom) and g.blocks == 1
    _p1_agrees((ops.cell[:n_cells].contiguous(), ops.eta, ops.eta_w,
                ops.mom[:, :n_mom].contiguous(), ops.inv_T))


@pytest.mark.gpu
@pytest.mark.parametrize("n_eta", [1, 32, 33, 80])
def test_polarization_kernel_eta_counts(workdir, n_eta):
    """One eta node, the most one launch takes, and more (the 24 nodes
    repeated): one launch per chunk of at most 32 nodes."""
    _needs_cuda()
    ops = _polarization_operands(workdir)
    reps = -(-n_eta // ops.eta.shape[0])
    args = (ops.cell, ops.eta.repeat(reps, 1)[:n_eta].contiguous(),
            ops.eta_w.repeat(reps)[:n_eta].contiguous(), ops.mom, ops.inv_T)
    before = pz.polarization_f32.launches
    _p1_agrees(args)
    assert pz.polarization_f32.launches - before == 2 * -(-n_eta // 32)


@pytest.mark.gpu
def test_polarization_kernel_ragged_case(workdir):
    """The operands cut to kc.RAGGED (rows of 7 phi, 105 momenta, 1,000
    cells)."""
    _needs_cuda()
    r = kc.check_polarization_ragged_case(workdir, 2048, 7, "cuda")
    assert r.launches == 1 and r.ok, r.vs_plain


@pytest.mark.gpu
def test_polarization_kernel_overflowing_exponential(workdir):
    """A heavy species at high pT on a cold surface, where expf overflows:
    f0 is 0 to f32's range, never NaN, and the sums stay finite."""
    _needs_cuda()
    ops = _polarization_operands(workdir)
    args = (ops.cell, ops.eta, ops.eta_w, ops.mom, 1.0 / 0.002)
    # u.p >= m, so expf(u.p / T) overflows (past 88.7) for these species
    assert (0.25 / ops.mom[4] * args[-1] > 88.8).any()
    assert torch.isfinite(pz.polarization_f32(*args)).all()
    assert torch.isfinite(pz.polarization_f32_plain(*args)).all()


def test_polarization_check_plain_on_cpu(workdir):
    """The P1 harness on the CPU: the wrapper takes the plain version (no
    launch), which meets the f64 engine at the JAX package's bars."""
    r = kc.check_polarization_case(workdir, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0
    assert r.vs_plain == (0.0, 0.0)
    assert r.ok, (r.vs_f64, r.plain_vs_f64)
