"""The CUDA kernels B1 and B3 (both modes each, 2+1d and 3+1d), B2 and P1
on the card, against their plain torch versions and the port's f64
engines, through the shared harness tools/kernel_check.py.

Imports nothing of JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: tests/conftest.py imports jax).  Without a CUDA device the
`gpu` tests skip; the CPU test runs the same harness through the kernel's
plain version.
"""

import dataclasses
import hashlib
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.ops import _build  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_comp as ck  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_f32 as b2  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.ops import polarization_f32 as pz  # noqa: E402
from is3d2_tpu_torch.ops.launch_geometry import df12_flags  # noqa: E402
from is3d2_tpu_torch.ops.spectra_fast_common import (  # noqa: E402
    comp_operands, comp_operands_3d, f32_operands)
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


@pytest.mark.parametrize("case", ["df1", "df2"])
def test_kernel_check_plain_on_cpu_without_shear(workdir, case):
    """The cases chip_smoke.py's phase 3 adds for B1's kShear = false
    instantiations (include_shear_deltaf 0), on the CPU: the plain version
    meets the f64 engine within TOL."""
    r = kc.check_case(workdir, case, 512, 3, "cpu", cell_block=512,
                      include_shear_deltaf=0)
    assert r.launches == 0
    assert r.vs_plain == 0.0
    assert r.ok, (r.vs_f64, r.plain_vs_f64)


# ----------------------------------------------------------------------
# kernel B1's 3+1d mode
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir_3d(tmp_path_factory):
    """A 3+1d workdir: 8 species, 16 pT x 8 phi x 9 y, baryons."""
    return write_workdir(tmp_path_factory.mktemp("torch_gpu_3d"), n_cells=16,
                         chosen_mcids=CHOSEN, n_pT=16, n_phi=8, n_y=9,
                         dimension=3, include_baryon=True, n_T=21, n_muB=9)


@pytest.fixture(scope="module")
def ragged_workdir_3d(tmp_path_factory):
    """3 pT x 7 phi x 3 y: rows of 7 phi no register tile divides."""
    return write_workdir(tmp_path_factory.mktemp("torch_gpu_3d_ragged"),
                         n_cells=16, chosen_mcids=CHOSEN, n_pT=3, n_phi=7,
                         n_y=3, dimension=3, include_baryon=True, n_T=21,
                         n_muB=9)


def _b1_3d_operands(workdir, n_surface=512, device="cuda", **cfg_fields):
    cfg = Config(compute_dtype="f32c", dimension=3, cell_block=512,
                 **{"df_mode": 1, **cfg_fields})
    surf = make_surface(n_surface, seed=5, dimension=3,
                        include_baryon=bool(cfg.include_baryon))
    return comp_operands_3d(*kc.engine_state(workdir, cfg, surf, device),
                            cfg), cfg


def _b1_3d_agrees(args, **layout):
    out = ck.cooper_frye_comp_3d(*args, **layout)
    again = ck.cooper_frye_comp_3d(*args, **layout)
    plain = ck.cooper_frye_comp_3d_plain(*args).cpu().numpy()[None]
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.TOL
    assert kc.peak_err(out, plain) <= kc.ABS_TOL_3D


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(kc.CASES))
def test_3d_kernel_vs_plain_and_f64(workdir_3d, case):
    _needs_cuda()
    r = kc.check_3d_case(workdir_3d, case, 512, 3, "cuda", cell_block=512)
    assert r.launches == 1
    assert r.ok, (r.vs_plain, r.vs_f64, kc.peak_err(r.kernel, r.f64))


@pytest.mark.gpu
def test_3d_kernel_runs_the_f32_route(workdir_3d):
    """compute_dtype f32 in 3+1d runs the same kernel: the same bits."""
    _needs_cuda()
    a = kc.check_3d_case(workdir_3d, "df2", 512, 3, "cuda", cell_block=512)
    b = kc.check_3d_case(workdir_3d, "df2", 512, 3, "cuda", cell_block=512,
                         compute_dtype="f32")
    np.testing.assert_array_equal(a.kernel, b.kernel)


@pytest.mark.gpu
def test_3d_kernel_ragged_case(workdir_3d):
    _needs_cuda()
    r = kc.check_3d_ragged_case(workdir_3d, 2048, 7, "cuda")
    assert r.launches == 1 and r.ok, r.vs_plain


@pytest.mark.gpu
@pytest.mark.parametrize("n_y", [5, 1])
def test_3d_kernel_ragged_y(workdir_3d, n_y):
    """The ragged case on rapidity counts that the y tile does not divide
    (5), and fewer than one tile (1)."""
    _needs_cuda()
    r = kc.check_3d_ragged_case(workdir_3d, 2048, 7, "cuda", n_y=n_y)
    g = ck.cooper_frye_comp_3d.last_geometry
    assert (g.n_y, g.row_len) == (n_y, kc.RAGGED["phi"])
    assert r.launches == 1 and r.ok, r.vs_plain


@pytest.mark.gpu
@pytest.mark.parametrize("n_y", [5, 1])
@pytest.mark.parametrize("n_cells,stop_short", [(100, 0), (333, 3), (1, 9)])
def test_3d_kernel_ragged_y_groups_and_splits(workdir_3d, n_y, n_cells,
                                              stop_short):
    """2 species x 3 pT x n_y y x 7 phi: y tiles cut short by the group's
    end, a last group that stops inside a row, cells that fill neither the
    last tile nor the last split."""
    _needs_cuda()
    ops, cfg = _b1_3d_operands(workdir_3d)
    full = ops.mom.reshape(ops.mom.shape[0], len(CHOSEN), 16, 9, 8)
    mom = full[:, :2, :3, :n_y, :7].reshape(ops.mom.shape[0], -1)
    mom = mom[:, :mom.shape[1] - stop_short].contiguous()
    _b1_3d_agrees((ops.cell[:n_cells].contiguous(), mom, cfg), row_len=7,
                  n_y=n_y)
    assert ck.cooper_frye_comp_3d.last_geometry.n_y == n_y


@pytest.mark.gpu
@pytest.mark.parametrize("n_cells,n_mom", [(100, 504), (70, 100), (333, 165),
                                           (1, 7), (512, 5), (0, 21)])
def test_3d_kernel_ragged_rows_and_splits(ragged_workdir_3d, n_cells, n_mom):
    """Rows of 7 phi under a register tile of 4, momentum counts that stop
    inside a row, cell counts that fill neither the last tile nor the last
    split, and no cell at all."""
    _needs_cuda()
    ops, cfg = _b1_3d_operands(ragged_workdir_3d)
    mom = ops.mom[:, :n_mom].contiguous()
    g = ck.geometry_3d(mom, n_cells, 3)
    assert g.row_len == min(7, n_mom) and g.blocks <= 2
    args = (ops.cell[:n_cells].contiguous(), mom, cfg)
    if n_cells == 0:
        assert not ck.cooper_frye_comp_3d(*args, n_y=3).any()
        return
    _b1_3d_agrees(args, n_y=3)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", range(32))
def test_3d_kernel_every_template_combination(workdir_3d, flags):
    """Each of the 3+1d mode's 32 instantiations launches and agrees with
    the plain version."""
    _needs_cuda()
    shear, diffusion, regulate, outflow, df2 = ((flags >> i) & 1
                                                for i in range(5))
    ops, cfg = _b1_3d_operands(
        workdir_3d, 200, df_mode=2 if df2 else 1, include_shear_deltaf=shear,
        include_baryon=1, include_baryondiff_deltaf=diffusion,
        regulate_deltaf=regulate, outflow=outflow)
    assert df12_flags(cfg) == flags
    _b1_3d_agrees((*ops.args(), cfg), **ops.layout())


@pytest.mark.parametrize("case", list(kc.CASES))
def test_kernel_check_3d_plain_on_cpu(workdir_3d, case):
    """The 3+1d harness on the CPU: the wrapper takes the plain version (no
    launch) and it meets the f64 engine within TOL and ABS_TOL_3D."""
    r = kc.check_3d_case(workdir_3d, case, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0
    assert r.vs_plain == 0.0
    assert r.ok, (r.vs_f64, kc.peak_err(r.plain, r.f64))


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
# kernel B3's 3+1d mode
# ----------------------------------------------------------------------

def _b3_3d_operands(workdir, df_mode=4, n_surface=512, **cfg_fields):
    cfg = Config(compute_dtype="f32", dimension=3, cell_block=512,
                 df_mode=df_mode, **cfg_fields)
    if df_mode == 5:
        surf = kc.famod_surface(workdir, n_surface, 5, "cuda", 3)
        state = kc.famod_engine_state(workdir, cfg, surf, "cuda")
        return fk.famod_operands_3d(*state, cfg), cfg
    surf = make_surface(n_surface, seed=5, dimension=3, **kc.FEQMOD_SURFACE)
    state = kc.feqmod_engine_state(workdir, cfg, surf, "cuda")
    return fk.feqmod_operands_3d(*state, cfg), cfg


def _b3_3d_agrees(args, **layout):
    out = fk.cooper_frye_feqmod_3d(*args, **layout)
    again = fk.cooper_frye_feqmod_3d(*args, **layout)
    plain = fk.cooper_frye_feqmod_3d_plain(*args, **layout)
    assert torch.equal(out, again)        # no atomics: the same bits
    out, plain = out.cpu().numpy()[None], plain.cpu().numpy()[None]
    assert np.isfinite(out).all()
    assert kc.max_rel_err(out, plain) <= kc.FEQMOD_TOL_PLAIN


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(kc.FEQMOD_3D_CASES))
def test_feqmod_3d_kernel_vs_plain_and_f64(workdir_3d, case):
    """B3's 3+1d mode against its plain version (<= 1e-5) and the f64
    engines (<= 1e-4) over its modes and flags, with breakdown cells."""
    _needs_cuda()
    r = kc.check_feqmod_3d_case(workdir_3d, case, 512, 3, "cuda",
                                cell_block=512)
    assert r.launches == 1
    assert r.ok, (r.vs_plain, r.vs_f64, r.breakdown_cells)


@pytest.mark.gpu
def test_feqmod_3d_kernel_narrow_window(workdir_3d):
    """Cells with detA < 0.01 within detA of a y node: the kernel takes
    the linearised branch on exactly the (cell, y) pairs the f64 engine
    does."""
    _needs_cuda()
    r = kc.check_feqmod_3d_case(workdir_3d, "df4", 512, 4, "cuda",
                                narrow=True, cell_block=512)
    assert r.narrow_pairs > 0 and r.launches == 1
    assert r.ok, (r.vs_plain, r.vs_f64)


@pytest.mark.gpu
@pytest.mark.parametrize("n_y", kc.RAGGED_Y)
def test_feqmod_3d_kernel_ragged_y(workdir_3d, n_y):
    """RAGGED's grid on 3, 5 and 1 rapidities: y counts the y tile does
    not divide, and fewer than one tile."""
    _needs_cuda()
    r = kc.check_feqmod_3d_ragged_case(workdir_3d, 1100, 7, "cuda", n_y=n_y)
    g = fk.cooper_frye_feqmod_3d.last_geometry
    assert (g.n_y, g.row_len) == (n_y, kc.RAGGED["phi"])
    assert r.launches == 1 and r.ok, r.vs_plain


@pytest.mark.gpu
@pytest.mark.parametrize("n_y", [5, 1])
@pytest.mark.parametrize("n_cells,stop_short", [(100, 0), (333, 3), (1, 9)])
def test_feqmod_3d_kernel_ragged_groups_and_splits(workdir_3d, n_y, n_cells,
                                                   stop_short):
    """2 species x 3 pT x n_y y x 7 phi: y tiles cut short by the group's
    end, a last group that stops inside a row, cells that fill neither the
    last tile nor the last split (the first live cells, clean and
    touched)."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d)
    full = ops.mom.reshape(ops.mom.shape[0], len(CHOSEN), 16, 9, 8)
    mom = full[:, :2, :3, :n_y, :7].reshape(ops.mom.shape[0], -1)
    mom = mom[:, :mom.shape[1] - stop_short].contiguous()
    cut = ops.first(n_cells)
    _b3_3d_agrees((cut.cols, cut.cold, mom, ops.y[:n_y].contiguous(),
                   cut.renorm[:, :2].contiguous(),
                   cut.red[:, :2].contiguous(), 3 * n_y * 7, cfg, ops.kind),
                  row_len=7, n_y=n_y)
    assert fk.cooper_frye_feqmod_3d.last_geometry.n_y == n_y


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode", [3, 4, 5])
@pytest.mark.parametrize("outflow", [0, 1])
@pytest.mark.parametrize("regulate", [0, 1])
def test_feqmod_3d_kernel_every_template_combination(workdir_3d, df_mode,
                                                     outflow, regulate):
    """Each of the 3+1d mode's 12 instantiations launches and agrees with
    the plain version."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d, df_mode, 200, outflow=outflow,
                               regulate_deltaf=regulate)
    _b3_3d_agrees((*ops.args(), cfg, ops.kind), **ops.layout())


@pytest.mark.gpu
def test_feqmod_3d_kernel_hands_a_nan_on(workdir_3d):
    """A NaN effective temperature on a cell that takes the modified branch
    at every y reaches every sum, as in the plain version."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d)
    cols = ops.cols.clone()
    cell = int(torch.nonzero((cols[:, fk.BREAKS_3] == 0)
                             & (ops.cold[:, fk.WINDOW_3] == 0))[0])
    cols[cell, fk.INVTEFF_3] = float("nan")
    args = (cols, *ops.args()[1:], cfg, ops.kind)
    assert bool(torch.isnan(fk.cooper_frye_feqmod_3d(
        *args, **ops.layout())).all())
    assert bool(torch.isnan(fk.cooper_frye_feqmod_3d_plain(
        *args, **ops.layout())).all())


def _route_geometries(args, layout):
    """The route's result on ``args`` and its (mixed, clean) geometries."""
    out = fk.cooper_frye_feqmod_3d(*args, **layout)
    return (out, fk.cooper_frye_feqmod_3d.last_geometry,
            fk.cooper_frye_feqmod_3d.last_clean_geometry)


def _one_split(g, n):
    return dataclasses.replace(g, n_split=1, cells_per_split=n)


def _vs_mixed(out, mixed, n_species) -> float:
    """The route against the mixed kernel on every cell: relative on bins
    >= 1e-4 of each species' peak."""
    return kc.max_rel_err(out.cpu().numpy().reshape(n_species, -1),
                          mixed.cpu().numpy().reshape(n_species, -1))


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode", [4, 5])
def test_feqmod_3d_split_equals_the_mixed_kernel_on_clean_cells(workdir_3d,
                                                                df_mode):
    """On operands whose cells are all clean the route's clean kernel sums
    what the mixed kernel sums, each term with the same bits: equal bits
    at one split, and at the clean kernel's own split."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d, df_mode)
    n = int(ops.n_clean)
    assert n > 0
    args = (ops.cols[:n].contiguous(), ops.cold[:n].contiguous(), ops.mom,
            ops.y, ops.renorm[:n].contiguous(), ops.red[:n].contiguous(),
            ops.n_per_species, cfg, ops.kind)
    out, g, g_clean = _route_geometries(args, ops.layout())
    one = fk.launch_3d_split(*args, _one_split(g_clean, n), _one_split(g, n))
    assert torch.equal(one, fk.launch_3d(*args, _one_split(g, n)))
    same = dataclasses.replace(g, n_split=g_clean.n_split,
                               cells_per_split=g_clean.cells_per_split)
    assert torch.equal(out, fk.launch_3d(*args, same))


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode", [3, 4, 5])
@pytest.mark.parametrize("outflow", [0, 1])
@pytest.mark.parametrize("regulate", [0, 1])
def test_feqmod_3d_split_every_template_combination(workdir_3d, df_mode,
                                                    outflow, regulate):
    """The route (both kernels, each instantiation) against the mixed
    kernel on every cell within 1e-10 (only the order of the f64 additions
    moves), two launches equal bits, and its plain version within B3's
    bar."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d, df_mode, outflow=outflow,
                               regulate_deltaf=regulate)
    n = int(ops.n_clean)
    assert 0 < n and (df_mode == 5 or n < ops.cols.shape[0])
    args = (*ops.args(), cfg, ops.kind)
    out, g, _ = _route_geometries(args, ops.layout())
    assert _vs_mixed(out, fk.launch_3d(*args, g), len(CHOSEN)) <= 1e-10
    _b3_3d_agrees(args, **ops.layout())


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["all touched", "none touched",
                                   "unordered"])
def test_feqmod_3d_split_edge_sets(workdir_3d, which):
    """A surface on which every cell is touched (the clean kernel sums
    nothing), one with no touched cell (the mixed kernel sums nothing), and
    operands not in the pack's order (clean cells after a touched one take
    the mixed kernel): each against the mixed kernel and the plain
    version."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d)
    n = int(ops.n_clean)
    cols, cold = ops.cols, ops.cold
    renorm, red = ops.renorm, ops.red
    if which == "all touched":
        cols = cols.clone()
        cols[:, fk.BREAKS_3] = 1.0
    elif which == "none touched":
        cols, cold = cols[:n].contiguous(), cold[:n].contiguous()
        renorm, red = renorm[:n].contiguous(), red[:n].contiguous()
    else:
        flip = torch.arange(cols.shape[0] - 1, -1, -1, device=cols.device)
        cols, cold = cols[flip].contiguous(), cold[flip].contiguous()
        renorm, red = renorm[flip].contiguous(), red[flip].contiguous()
    args = (cols, cold, ops.mom, ops.y, renorm, red, ops.n_per_species, cfg,
            ops.kind)
    want = {"all touched": 0, "none touched": n, "unordered": 0}[which]
    assert int(fk.clean_count(cols, cold)) == want
    out, g, _ = _route_geometries(args, ops.layout())
    assert _vs_mixed(out, fk.launch_3d(*args, g), len(CHOSEN)) <= 1e-10
    _b3_3d_agrees(args, **ops.layout())


def _cell_args(ops, cfg, at, cols=None, renorm=None):
    """The route's arguments on the cells ``at`` (an index or a slice) of
    ``ops``, with ``cols`` and ``renorm`` in place of its own."""
    cols = ops.cols if cols is None else cols
    renorm = ops.renorm if renorm is None else renorm
    return (cols[at].contiguous(), ops.cold[at].contiguous(), ops.mom, ops.y,
            renorm[at].contiguous(), ops.red[at].contiguous(),
            ops.n_per_species, cfg, ops.kind)


@pytest.mark.gpu
@pytest.mark.parametrize("outflow", [0, 1])
def test_feqmod_3d_clean_kernel_runs_that_end_short(workdir_3d, outflow):
    """97 clean cells (no whole number of 32-cell tiles) over splits of 48:
    runs of 32 and 16 cells, and a last split of one cell, whose run ends
    after one term.  The clean kernel gives the mixed kernel's bits at that
    split, meets the plain version, and with touched cells after it the
    route meets the mixed kernel on every cell (<= 1e-10)."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d, outflow=outflow)
    n, split = 97, 48
    assert int(ops.n_clean) >= n
    args = _cell_args(ops, cfg, slice(0, n))
    _, g, g_clean = _route_geometries(args, ops.layout())
    cut = dataclasses.replace(g_clean, n_split=3, cells_per_split=split)
    assert fk.cell_ranges_3d(cut, g, n, n)[:3] == [(0, 48), (48, 96),
                                                   (96, 97)]
    out = fk.launch_3d_split(*args, cut, g)
    same = dataclasses.replace(g, n_split=3, cells_per_split=split)
    assert torch.equal(out, fk.launch_3d(*args, same))
    plain = fk.cooper_frye_feqmod_3d_plain(*args, **ops.layout())
    assert kc.max_rel_err(out.cpu().numpy()[None],
                          plain.cpu().numpy()[None]) <= kc.FEQMOD_TOL_PLAIN
    # the clean run, then touched cells: the route's splits as above
    touched = torch.arange(int(ops.n_clean), ops.cols.shape[0],
                           device=ops.cols.device)[:3 * split - n]
    both = _cell_args(ops, cfg, torch.cat(
        [torch.arange(n, device=touched.device), touched]))
    assert touched.numel() > 0 and int(fk.clean_count(*both[:2])) == n
    _, g, _ = _route_geometries(both, ops.layout())
    out = fk.launch_3d_split(*both, cut, g)
    assert _vs_mixed(out, fk.launch_3d(*both, g), len(CHOSEN)) <= 1e-10
    _b3_3d_agrees(both, **ops.layout())


@pytest.mark.gpu
def test_feqmod_3d_clean_kernel_sums_terms_of_either_sign_and_any_size(
        workdir_3d):
    """Outflow 0, p.dsigma negated on every third cell (27 % of the terms
    negative) and each cell's renorm scaled by 10^u, u uniform in
    [-15, 15]: terms across ~1e30 (down to subnormals) whose bins cancel up
    to ~800-fold.  A signed sum is held to its error scale, the sum of its
    terms' magnitudes, per momentum: the route within FEQMOD_TOL_PLAIN of
    the plain version, and within 1e-12 of the f64 sum, term by term in
    cell order, of its own terms (each a one-cell launch, whose run is one
    term and exact)."""
    _needs_cuda()
    ops, cfg = _b3_3d_operands(workdir_3d)
    n = 97
    gen = torch.Generator().manual_seed(24)
    scale = 10.0 ** (30.0 * torch.rand(n, generator=gen,
                                       dtype=torch.float64) - 15.0)
    renorm = (ops.renorm[:n].double()
              * scale.to(ops.renorm.device)[:, None]).float()
    cols = ops.cols[:n].clone()
    cols[::3, fk.QDF_3:fk.QDF_3 + 4] *= -1.0
    args = _cell_args(ops, cfg, slice(0, n), cols, renorm)
    out = fk.cooper_frye_feqmod_3d(*args, **ops.layout()).cpu().numpy()
    plain = fk.cooper_frye_feqmod_3d_plain(*args, **ops.layout())
    terms = np.stack([fk.cooper_frye_feqmod_3d(
        *_cell_args(ops, cfg, slice(c, c + 1), cols, renorm),
        **ops.layout()).cpu().numpy() for c in range(n)])
    assert (terms < 0).any() and (terms > 0).any()
    magnitude = np.abs(terms).sum(axis=0)
    live = magnitude > 0
    per_term = np.zeros_like(out)
    for row in terms:       # f64, one term at a time, in cell order
        per_term += row
    assert np.isfinite(out).all()
    assert (np.abs(out - plain.cpu().numpy())[live]
            / magnitude[live]).max() <= kc.FEQMOD_TOL_PLAIN
    assert (np.abs(out - per_term)[live] / magnitude[live]).max() <= 1e-12


def test_feqmod_3d_kernel_check_plain_on_cpu(workdir_3d):
    """The B3 3+1d harness on the CPU: the wrapper takes the plain version
    (no launch), it meets the f64 engine, and the surface breaks down."""
    r = kc.check_feqmod_3d_case(workdir_3d, "df4", 512, 3, "cpu",
                                cell_block=512)
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


# ----------------------------------------------------------------------
# operation 0: B1's per-cell mode
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_workdir(tmp_path_factory):
    """40 pT x 30 phi, 3 species: 320 register tiles a species (rows of 30
    phi under a tile of 4), more than one block's threads, so that the
    per-cell mode's block walks them in passes, the last one short."""
    return write_workdir(tmp_path_factory.mktemp("torch_gpu_wide"),
                         n_cells=16, chosen_mcids=CHOSEN[:3], n_pT=40,
                         n_phi=30, n_eta=24, include_baryon=True, n_T=21,
                         n_muB=9)


def _cells_weights(ops, n_species):
    """f64 weights of one species' momenta (any positive ones serve a
    comparison with the plain version)."""
    per = ops.mom.shape[1] // n_species
    return torch.linspace(0.5, 1.5, per, dtype=torch.float64,
                          device=ops.mom.device)


def _cells_agree(args, n_species):
    out = ck.cooper_frye_comp_cells(*args)
    assert out.shape == (args[0].shape[0], n_species)
    assert torch.equal(out, ck.cooper_frye_comp_cells(*args))   # no atomics
    plain = ck.cooper_frye_comp_cells_plain(*args)
    out = out.cpu().numpy()
    assert np.isfinite(out).all()
    assert kc.max_scaled_err(out, plain.cpu().numpy(),
                             kc.cells_scale(*args)) <= kc.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(kc.CASES))
def test_dX_per_cell_mode_vs_plain_per_bin_and_f64(workdir, case):
    """Operation 0 at 2,048 cells with dsigma_eta != 0 through the per-cell
    route: one launch; per (cell, species) within 1e-6 of the plain
    version in units of the cell's sum of |terms|; the bins <= 1e-12 of
    the per-bin kernel route (the same f32 terms) and <= 1e-6 of the f64
    engines; two runs give the same bits, per cell and binned."""
    _needs_cuda()
    fields, surface_kw = kc.CASES[case]
    cfg = Config(operation=0, compute_dtype="f32c", cell_block=512, **fields)
    r = kc.check_dX_cells_case(workdir, cfg, 2048, 3, "cuda", **surface_kw)
    assert r.launches == 1
    assert r.repeats
    assert r.ok, (r.vs_plain, r.vs_per_bin, r.vs_f64)


@pytest.mark.parametrize("case", ["df1", "df2-clip-outflow",
                                  "df1-baryon-diffusion"])
def test_dX_cells_check_plain_on_cpu(workdir, case):
    """The per-cell check on the CPU: the wrapper takes the plain version
    (no launch), and its bins meet the per-bin route's and the f64
    engines' within TOL."""
    fields, surface_kw = kc.CASES[case]
    cfg = Config(operation=0, compute_dtype="f32c", cell_block=512, **fields)
    r = kc.check_dX_cells_case(workdir, cfg, 512, 3, "cpu", **surface_kw)
    assert r.launches == 0 and r.repeats
    assert r.vs_plain == 0.0
    assert r.ok, (r.vs_per_bin, r.vs_f64)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", range(32))
def test_per_cell_mode_every_template_combination(workdir, flags):
    """Each of the per-cell mode's 32 instantiations launches and agrees
    with its plain version."""
    _needs_cuda()
    shear, diffusion, regulate, outflow, df2 = ((flags >> i) & 1
                                                for i in range(5))
    ops, cfg = _b1_operands(
        workdir, 200, df_mode=2 if df2 else 1, include_shear_deltaf=shear,
        include_baryon=1, include_baryondiff_deltaf=diffusion,
        regulate_deltaf=regulate, outflow=outflow)
    assert df12_flags(cfg) == flags
    _cells_agree((*ops.args(), _cells_weights(ops, len(CHOSEN)), cfg),
                 len(CHOSEN))


@pytest.mark.gpu
@pytest.mark.parametrize("which,n_pT,n_phi,n_species", [
    ("ragged", 3, 7, len(CHOSEN)), ("wide", 40, 30, 3)])
@pytest.mark.parametrize("n_cells", [1, 100, 333])
def test_per_cell_mode_ragged_rows_and_passes(ragged_workdir, wide_workdir,
                                              which, n_pT, n_phi, n_species,
                                              n_cells):
    """Rows of 7 or 30 phi under a register tile of 4; 6 tiles a species
    (one pass, most lanes idle) or 320 (passes, the last short); cell
    counts that fill neither the last 64-cell tile nor the last run."""
    _needs_cuda()
    wd = ragged_workdir if which == "ragged" else wide_workdir
    ops, cfg = _b1_operands(wd)
    w = _cells_weights(ops, n_species)
    assert w.shape[0] == n_pT * n_phi
    g = ck.geometry_cells(ops.mom, n_cells, w.shape[0],
                          ck.CellsTile.of(_build.load("cooper_frye_comp")))
    assert (g.row_len, g.per_species) == (n_phi, n_pT * n_phi)
    _cells_agree((ops.cell[:n_cells].contiguous(),
                  ops.qm[:n_cells].contiguous(), ops.eta, ops.eta_w, ops.mom,
                  w, cfg), n_species)


@pytest.mark.gpu
@pytest.mark.parametrize("n_eta", [1, 33, 80])
def test_per_cell_mode_eta_counts(workdir, n_eta):
    """One launch per chunk of at most 32 eta nodes, the chunks added."""
    _needs_cuda()
    ops, cfg = _b1_operands(workdir)
    cell, qm, eta, eta_w, mom, _ = _b1_eta_args(ops, cfg, n_eta)
    before = ck.cooper_frye_comp_cells.launches
    _cells_agree((cell, qm, eta, eta_w, mom,
                  _cells_weights(ops, len(CHOSEN)), cfg), len(CHOSEN))
    assert ck.cooper_frye_comp_cells.launches - before == 2 * -(-n_eta // 32)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:24]


# The op-1 kernel's (M,) result on _b1_operands(workdir) (df 1 f32c, 512
# cells), bit for bit: recorded on an NVIDIA H100 80GB HBM3 from the op-1
# kernel as it was before it shared its evaluation (cell_terms) with the
# per-cell mode.  The operands' own digest pins down what was run.
B1_OP1_OPERANDS = "bcb0a0edcc81e8b5ad0efbb8"
B1_OP1_RESULT = "6556016496545a29a75e6a88"


@pytest.mark.gpu
def test_op1_kernel_bits_unchanged(workdir):
    _needs_cuda()
    ops, cfg = _b1_operands(workdir)
    assert _digest(*ops.args()) == B1_OP1_OPERANDS, \
        "the operands differ from the recorded set"
    assert _digest(ck.cooper_frye_comp(*ops.args(), cfg)) == B1_OP1_RESULT


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

# the two instantiations: the route's fold gate picks the folded one with
# the default eta_fold on a boost-invariant surface, the general one with
# eta_fold = 0
P1_FOLD = {"folded": -1, "general": 0}


def _polarization_operands(workdir, which, n_surface=512, device="cuda",
                           T=None):
    cfg = Config(compute_dtype="f32c", mode=5, cell_block=512,
                 eta_fold=P1_FOLD[which])
    state = kc.polarization_engine_state(
        workdir, cfg, make_surface(n_surface, seed=5, vorticity=True),
        device)
    if T is not None:
        state = (*state[:3], T, state[4])
    ops = kc.polarization_operands(state, cfg)
    assert ops.folded == (which == "folded")
    return ops


def _p1_agrees(args):
    out = pz.polarization_f32(*args)
    again = pz.polarization_f32(*args)
    plain = pz.polarization_f32_plain(*args).cpu().numpy()
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()
    assert np.isfinite(out).all()
    assert max(kc.polarization_errors(out, plain)) <= kc.POLZN_TOL_PLAIN


# (fold gate settings and odd sources, the instantiation they give)
P1_CASES = {"folded": ({}, True),
            "general eta_fold 0": ({"eta_fold": 0}, False),
            "general un": ({"un_scale": 0.05}, False),
            "general dsigma_eta": ({"dan_scale": 0.05}, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(P1_CASES))
def test_polarization_kernel_vs_plain_and_f64(workdir, case):
    """P1 at 512 cells, both instantiations: <= 1e-5 against its plain
    version on both metrics, Snorm <= 2e-5 and P <= 1e-5 of max |P|
    against the f64 engine (never folded), one launch, the same bits
    twice."""
    _needs_cuda()
    kw, folded = P1_CASES[case]
    r = kc.check_polarization_case(workdir, 512, 3, "cuda", cell_block=512,
                                   **kw)
    assert r.folded == folded
    assert r.launches == 1 and r.repeats
    assert r.ok, (r.vs_plain, r.vs_f64)


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(P1_FOLD))
@pytest.mark.parametrize("n_cells,n_mom", [(100, 168), (70, 100), (333, 165),
                                           (1, 7), (512, 5)])
def test_polarization_kernel_ragged_rows_and_splits(ragged_workdir, n_cells,
                                                    n_mom, which):
    """Rows of 7 phi under a register tile of 4, momentum counts that stop
    inside a row, cell counts that fill neither the last tile nor the last
    split."""
    _needs_cuda()
    ops = _polarization_operands(ragged_workdir, which)
    g = pz.geometry(ops.mom[:, :n_mom].contiguous(), n_cells)
    assert g.row_len == min(7, n_mom) and g.blocks == 1
    _p1_agrees((ops.cell[:n_cells].contiguous(), ops.eta,
                ops.mom[:, :n_mom].contiguous(), ops.folded))


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(P1_FOLD))
@pytest.mark.parametrize("n_eta", [1, 32, 33, 80])
def test_polarization_kernel_eta_counts(workdir, n_eta, which):
    """One eta node, the most one launch takes, and more (the table
    repeated): one launch per chunk of at most 32 nodes."""
    _needs_cuda()
    ops = _polarization_operands(workdir, which)
    reps = -(-n_eta // ops.eta.shape[0])
    args = (ops.cell, ops.eta.repeat(reps, 1)[:n_eta].contiguous(),
            ops.mom, ops.folded)
    before = pz.polarization_f32.launches
    _p1_agrees(args)
    assert pz.polarization_f32.launches - before == 2 * -(-n_eta // 32)


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(P1_FOLD))
def test_polarization_kernel_ragged_case(workdir, which):
    """The operands cut to kc.RAGGED (rows of 7 phi, 105 momenta, 1,000
    cells)."""
    _needs_cuda()
    r = kc.check_polarization_ragged_case(workdir, 2048, 7, "cuda",
                                          eta_fold=P1_FOLD[which])
    assert r.folded == (which == "folded")
    assert r.launches == 1 and r.ok, r.vs_plain


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(P1_FOLD))
def test_polarization_kernel_overflowing_exponential(workdir, which):
    """A heavy species at high pT on a cold surface, where 2^x overflows:
    f0 is 0 to f32's range, never NaN, and the sums stay finite."""
    _needs_cuda()
    T = 0.002
    ops = _polarization_operands(workdir, which, T=T)
    # u.p >= m, so 2^(u.p log2(e) / T) overflows (past 128) for these
    assert (0.25 / ops.mom[4] * math.log2(math.e) / T > 128.5).any()
    assert torch.isfinite(pz.polarization_f32(*ops.args())).all()
    assert torch.isfinite(pz.polarization_f32_plain(*ops.args())).all()


@pytest.mark.gpu
def test_polarization_kernel_takes_live_rows_only(workdir):
    """The pack hands P1 the real cells only: 500 cells padded to 512 give
    the bits of the same cells with no padding (cell_block 4), within the
    bars of the f64 engine on the padded cells (pad_mask)."""
    _needs_cuda()
    surf = make_surface(500, seed=9, vorticity=True)
    out = {}
    for block in (512, 4):
        cfg = Config(compute_dtype="f32c", mode=5, cell_block=block)
        state = kc.polarization_engine_state(workdir, cfg, surf, "cuda")
        assert state[0].tau.shape[0] == (512 if block == 512 else 500)
        ops = kc.polarization_operands(state, cfg)
        assert ops.cell.shape[0] == 500 and ops.folded
        out[block] = pz.polarization_f32(*ops.args())
        if block == 512:
            ref = kc.polarization_f64(*state).reshape(5, -1).cpu().numpy()
    assert torch.equal(out[512], out[4])
    norm, p = kc.polarization_errors(out[512].cpu().numpy(), ref)
    assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


def test_polarization_check_plain_on_cpu(workdir):
    """The P1 harness on the CPU: the wrapper takes the plain version (no
    launch), which meets the f64 engine at the JAX package's bars."""
    r = kc.check_polarization_case(workdir, 512, 3, "cpu", cell_block=512)
    assert r.launches == 0
    assert r.vs_plain == (0.0, 0.0)
    assert r.ok, (r.vs_f64, r.plain_vs_f64)


# ----------------------------------------------------------------------
# kernel P1's 3+1d mode (spin polarization, mode 5, dimension 3)
# ----------------------------------------------------------------------

def _p1_3d_operands(workdir, n_surface=512, device="cuda", T=None,
                    seed=5):
    cfg = Config(compute_dtype="f32c", mode=5, dimension=3, cell_block=512)
    state = kc.polarization_engine_state(
        workdir, cfg, make_surface(n_surface, seed=seed, dimension=3,
                                   vorticity=True), device)
    if T is not None:
        state = (*state[:3], T, state[4])
    return kc.polarization_operands_3d(state)


def _p1_3d_agrees(args, **layout):
    out = pz.polarization_f32_3d(*args, **layout)
    again = pz.polarization_f32_3d(*args, **layout)
    plain = pz.polarization_f32_3d_plain(*args, **layout).cpu().numpy()
    assert torch.equal(out, again)        # no atomics: the same bits
    out = out.cpu().numpy()
    assert np.isfinite(out).all()
    assert max(kc.polarization_errors(out, plain)) <= kc.POLZN_TOL_PLAIN
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("near", [False, True], ids=["surface", "near"])
def test_polarization_3d_kernel_vs_plain_and_f64(workdir_3d, near):
    """P1's 3+1d mode at 512 cells (and with half of them within 1e-4 of a
    y node): <= 1e-5 against its plain version on both metrics, the JAX
    bars against the f64 engine, one launch, the same bits twice."""
    _needs_cuda()
    r = kc.check_polarization_3d_case(workdir_3d, 512, 3, "cuda",
                                      near=near, cell_block=512)
    assert r.launches == 1 and r.repeats
    assert r.ok, (r.vs_plain, r.vs_f64)
    assert pz.polarization_f32_3d.last_launch == {
        "cells": 512, "momenta": r.kernel.shape[1], "n_y": 9,
        "dimension": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("n_y", kc.RAGGED_Y)
def test_polarization_3d_kernel_ragged_case(workdir_3d, n_y):
    """The operands cut to kc.RAGGED (rows of 7 phi, 1,000 cells) and to
    3, 5 and 1 rapidities: y counts the 3-row tile does not divide."""
    _needs_cuda()
    r = kc.check_polarization_3d_ragged_case(workdir_3d, 2048, 7, "cuda",
                                             n_y=n_y)
    assert r.launches == 1 and r.ok, r.vs_plain


@pytest.mark.gpu
@pytest.mark.parametrize("n_cells,n_groups", [(1, 1), (63, 2), (65, 9),
                                              (333, 5), (512, 9)])
def test_polarization_3d_kernel_ragged_groups_and_cells(ragged_workdir_3d,
                                                        n_cells, n_groups):
    """Rows of 7 phi x 3 y under a tile of 4 x 3, groups that do not fill
    a block, cell counts that fill neither the last 64-cell tile, the last
    256-cell run nor the last split, and a last group cut short."""
    _needs_cuda()
    ops = _p1_3d_operands(ragged_workdir_3d)
    n_mom = n_groups * 3 * 7 - (5 if n_groups > 1 else 0)
    _p1_3d_agrees((ops.cell[:n_cells].contiguous(),
                   ops.ytab[:n_cells].contiguous(),
                   ops.mom[:, :n_mom].contiguous()), **ops.layout())


@pytest.mark.gpu
def test_polarization_3d_kernel_splits_the_cells(workdir_3d):
    """A few momenta over many cells: the wrapper splits the cells across
    blockIdx.y (partials added in a fixed order), and the sums equal the
    plain version's runs of RUN_CELLS_3D cells within its bar."""
    _needs_cuda()
    ops = _p1_3d_operands(workdir_3d, n_surface=4096)
    mom = ops.mom[:, :21 * 8].contiguous()
    g = pz.geometry_3d(mom.shape[1], ops.cell.shape[0], ops.row_len,
                       ops.n_y, pz.TILE_3D, mom.device)
    assert g.n_split > 1 and g.cells_per_split % pz.RUN_CELLS_3D == 0
    _p1_3d_agrees((ops.cell, ops.ytab, mom), **ops.layout())
    assert pz.polarization_f32_3d.last_geometry.n_split == g.n_split


@pytest.mark.gpu
def test_polarization_3d_kernel_more_y_than_one_launch(tmp_path):
    """300 rapidities, more than one launch takes (kMaxY): the wrapper
    runs chunks of rows, one launch each, with the plain version's sums."""
    _needs_cuda()
    wd = write_workdir(tmp_path / "y300", n_cells=16, chosen_mcids=(211, 2212),
                       n_pT=3, n_phi=7, n_T=21, dimension=3, n_y=300)
    ops = _p1_3d_operands(wd, n_surface=200)
    lib = _build.load("polarization_f32")
    assert ops.n_y == 300 > lib.is3d2_polarization_f32_3d_max_y()
    before = pz.polarization_f32_3d.launches
    _p1_3d_agrees(ops.args(), **ops.layout())
    assert pz.polarization_f32_3d.launches - before == 2 * 2


@pytest.mark.gpu
def test_polarization_3d_kernel_overflowing_exponential(workdir_3d):
    """A cold surface, where 2^x overflows for heavy species at high pT:
    f0 is 0 to f32's range, never NaN, and the sums stay finite."""
    _needs_cuda()
    ops = _p1_3d_operands(workdir_3d, T=0.002)
    assert torch.isfinite(pz.polarization_f32_3d(*ops.args(),
                                                 **ops.layout())).all()


@pytest.mark.gpu
def test_polarization_3d_kernel_fast_cold_cells(workdir_3d):
    """kernel_check.fast_flow_surface (|u_perp| ~ 3, T = 0.08 GeV, pT up
    to 3 GeV), where the factored exponential's two factors would be inf
    and 0 without the shift: every sum finite, <= 1e-5 against the plain
    version, kc.FAST_FLOW_TOL against the f64 engine, the same bits
    twice."""
    _needs_cuda()
    r = kc.check_polarization_3d_case(workdir_3d, 512, 3, "cuda",
                                      fast_flow=True, cell_block=512)
    assert r.launches == 1 and r.repeats
    assert r.ok, (r.vs_plain, r.vs_f64)


@pytest.mark.gpu
def test_polarization_3d_route_takes_real_cells_without_a_read_back(
        workdir_3d):
    """compute_polarization_kernel_3d on 500 cells padded to 512: the real
    rows only, the same bits as with no padding (cell_block 4), within the
    bars of the f64 engine on the padded cells."""
    _needs_cuda()
    surf = make_surface(500, seed=9, dimension=3, vorticity=True)
    out = {}
    for block in (512, 4):
        cfg = Config(compute_dtype="f32c", mode=5, dimension=3,
                     cell_block=block)
        state = kc.polarization_engine_state(workdir_3d, cfg, surf, "cuda")
        out[block] = pz.compute_polarization_kernel_3d(*state[:4])
        if block == 512:
            ref = kc.polarization_f64(*state, dimension=3).cpu().numpy()
    assert pz.polarization_f32_3d.last_launch["cells"] == 500
    assert torch.equal(out[512], out[4])
    norm, p = kc.polarization_errors(out[512].cpu().numpy(), ref)
    assert norm <= kc.POLZN_TOL_NORM and p <= kc.POLZN_TOL_P, (norm, p)


def test_polarization_3d_check_plain_on_cpu(workdir_3d):
    """The 3+1d P1 harness on the CPU: the wrapper takes the plain version
    (no launch), which meets the f64 engine at the JAX package's bars."""
    r = kc.check_polarization_3d_case(workdir_3d, 256, 3, "cpu",
                                      cell_block=256)
    assert r.launches == 0 and r.vs_plain == (0.0, 0.0)
    assert r.ok, (r.vs_f64, r.plain_vs_f64)


# ----------------------------------------------------------------------
# the multi-surface ensemble (core/ensemble.py) on the card
# ----------------------------------------------------------------------

ENSEMBLE_CELLS = (2048, 2048, 1500, 2048)    # the third: a ragged block
# route -> (cfg fields, surfaces, bar against the f64 engine's ensemble)
ENSEMBLE_ROUTES = {
    "B1": ({"df_mode": 1, "compute_dtype": "f32c"}, "mild", kc.TOL),
    "B2": ({"df_mode": 2, "compute_dtype": "f64", "use_pallas": 1}, "mild",
           kc.F32_TOL_F64),
    "B3": ({"df_mode": 4, "compute_dtype": "f32"}, "feqmod",
           kc.FEQMOD_TOL_F64),
    "B3-famod": ({"df_mode": 5, "compute_dtype": "f32"}, "eos",
                 kc.FEQMOD_TOL_F64),
    # the JAX package's 3+1d budget (kernel_check.Case3dResult)
    "B1-3d": ({"df_mode": 1, "compute_dtype": "f32c", "dimension": 3},
              "3d", kc.TOL),
    "B3-3d": ({"df_mode": 4, "compute_dtype": "f32", "dimension": 3},
              "feqmod", kc.FEQMOD_TOL_F64),
    "B3-3d-famod": ({"df_mode": 5, "compute_dtype": "f32", "dimension": 3},
                    "eos", kc.FEQMOD_TOL_F64),
}


def _ensemble_run(tmp_path, route):
    """The route's config, surfaces and a driver whose setup (species,
    grids, delta-f data with the Jonah splines of surface 0) they share."""
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.io.pdg import read_pdg
    from is3d2_tpu_torch.io.tables import GaussLaguerre
    from is3d2_tpu_torch.tools.synthetic import make_eos_consistent
    fields, kind, _ = ENSEMBLE_ROUTES[route]
    dim = fields.get("dimension", 2)
    wd = write_workdir(tmp_path / route, n_cells=16, chosen_mcids=CHOSEN,
                       n_pT=16, n_phi=8, n_eta=24, n_T=21, dimension=dim)
    cfg = Config(cell_block=512, **fields)
    kw = {"feqmod": kc.FEQMOD_SURFACE, "eos": kc.FAMOD_SURFACE}.get(kind, {})
    surfs = [make_surface(n, seed=70 + i, dimension=dim, **kw)
             for i, n in enumerate(ENSEMBLE_CELLS)]
    if kind == "eos":
        species = read_pdg(3, wd / "PDG")
        lag = GaussLaguerre.from_file(wd / "tables/gauss/gla_roots_weights.txt")
        surfs = [make_eos_consistent(s, species, lag, "cuda") for s in surfs]
    run = IS3D(wd, cfg=cfg, device="cuda")
    run.surface = surfs[0]
    run._setup()
    return cfg, surfs, run


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ENSEMBLE_ROUTES))
def test_ensemble_equals_single_runs_and_the_f64_engine(tmp_path, route):
    """Each route's ensemble on the card: every surface bit-equal to its
    single compute_spectra run, with one launch of the route's kernel per
    surface, and within the kernel's bar of the f64 engine's ensemble."""
    _needs_cuda()
    from is3d2_tpu_torch.core.ensemble import compute_spectra_ensemble
    from is3d2_tpu_torch.core.spectra import compute_spectra
    cfg, surfs, run = _ensemble_run(tmp_path, route)
    args = (run.species, run.chosen_idx, run.grids, run.df_data)
    kernel = {"B1": ck.cooper_frye_comp, "B2": b2.cooper_frye_f32,
              "B3": fk.cooper_frye_feqmod, "B3-famod": fk.cooper_frye_feqmod,
              "B1-3d": ck.cooper_frye_comp_3d,
              "B3-3d": fk.cooper_frye_feqmod_3d,
              "B3-3d-famod": fk.cooper_frye_feqmod_3d}[route]
    before = kernel.launches
    out = compute_spectra_ensemble(surfs, *args, cfg, run.laguerre,
                                   surface_chunk=3)
    assert kernel.launches - before == len(surfs)
    assert out.shape == (len(surfs), len(CHOSEN), 16, 8,
                         21 if cfg.dimension == 3 else 1)
    assert np.isfinite(out).all()
    for i, surf in enumerate(surfs):
        one = compute_spectra(surf, *args, cfg, "cuda", run.laguerre)
        np.testing.assert_array_equal(out[i], one, err_msg=str(i))
    f64 = compute_spectra_ensemble(
        surfs, *args, dataclasses.replace(cfg, compute_dtype="f64",
                                          use_pallas=-1), run.laguerre)
    bar = ENSEMBLE_ROUTES[route][2]
    for i in range(len(surfs)):
        if cfg.dimension == 3 and cfg.df_mode in (1, 2):
            assert kc.global_rel_err(out[i], f64[i]) <= bar
            assert kc.peak_err(out[i], f64[i]) <= kc.ABS_TOL_3D
        else:
            assert kc.max_rel_err(out[i], f64[i]) <= bar, i


def _queued_route(tmp_path, route):
    """A call of the route on its first surface: spectra_on_device, or for
    P1-3d the 3+1d polarization route on cells prepared on the card."""
    if route == "P1-3d":
        wd = write_workdir(tmp_path / route, n_cells=16, chosen_mcids=CHOSEN,
                           n_pT=16, n_phi=8, n_T=21, dimension=3,
                           surface_mode=5)
        cfg = Config(compute_dtype="f32c", mode=5, dimension=3,
                     cell_block=512)
        state = kc.polarization_engine_state(
            wd, cfg, make_surface(ENSEMBLE_CELLS[2], seed=70, dimension=3,
                                  vorticity=True), "cuda")
        return lambda: pz.compute_polarization_kernel_3d(*state[:4])
    from is3d2_tpu_torch.core.spectra import spectra_on_device
    cfg, surfs, run = _ensemble_run(tmp_path, route)
    args = (run.species, run.chosen_idx, run.grids, run.df_data, cfg,
            "cuda", run.laguerre)
    return lambda: spectra_on_device(surfs[0], *args)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["B1", "B2", "B3", "B1-3d", "B3-3d",
                                   "P1-3d"])
def test_device_route_queues_no_synchronization(tmp_path, route):
    """spectra_on_device on df 1-4 (3+1d too), and the 3+1d polarization
    route, queue a surface's work without waiting for the card: the
    uploads go through pinned memory and the fold gate, the skipped count,
    the 3+1d live cells and the real cells come from the host columns.
    Under torch's sync debug mode "error" any synchronizing operation
    raises."""
    _needs_cuda()
    call = _queued_route(tmp_path, route)
    want = call()      # builds and loads
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# use_pallas = 0 (ROADMAP A7e / A9b) and the sweep tool on the card
# ----------------------------------------------------------------------

def _route_workdir(root, df_mode: int, dtype: str):
    """512 cells, CHOSEN, 16 pT x 8 phi x 24 eta; df 3-5 on shear 0.1,
    bulk 0.05 (an EOS-consistent surface for df 5), so that cells break
    down."""
    feqmod = df_mode in (3, 4, 5)
    return write_workdir(root, n_cells=512, chosen_mcids=CHOSEN, n_pT=16,
                         n_phi=8, n_T=21, eos_consistent=df_mode == 5,
                         shear_scale=0.1 if feqmod else 0.02,
                         bulk_scale=0.05 if feqmod else 0.01,
                         params={"cell_block": 512, "df_mode": df_mode,
                                 "compute_dtype": dtype})


@pytest.mark.gpu
@pytest.mark.parametrize("df_mode,dtype,kernel", [
    (1, "f32c", "B1"), (2, "f32", "B1"), (4, "f32", "B3"),
    (3, "f32c", "B3"), (5, "f32", "B3 famod")])
def test_use_pallas0_runs_the_kernel_on_the_card(tmp_path, df_mode, dtype,
                                                kernel):
    """use_pallas = 0 with f32/f32c launches the kernel that use_pallas =
    -1 launches, once, and gives its bits."""
    import io
    from contextlib import redirect_stdout

    from is3d2_tpu_torch.driver import IS3D
    _needs_cuda()
    wd = _route_workdir(tmp_path, df_mode, dtype)
    fn = ck.cooper_frye_comp if kernel == "B1" else fk.cooper_frye_feqmod
    out = {}
    for use_pallas in (0, -1):
        cfg = dataclasses.replace(Config.from_file(wd / "iS3D_parameters.dat"),
                                  use_pallas=use_pallas)
        before = fn.launches
        with redirect_stdout(io.StringIO()):
            run = IS3D(wd, cfg=cfg, device="cuda")
            run.run_particlization(write=False)
        assert fn.launches - before == 1, use_pallas
        out[use_pallas] = run.spectra
    assert np.isfinite(out[0]).all() and (out[0] > 0).any()
    np.testing.assert_array_equal(out[0], out[-1])


@pytest.mark.gpu
def test_sweep_on_the_card(tmp_path):
    """A 2 x 2 sweep (grad, ptb x none, shear) on the card against the same
    sweep on the CPU (the kernels' plain versions): the same archive, B1's
    files within 1e-6 and B3's within 1e-5 on bins >= 1e-4 of their
    peak."""
    import io
    from contextlib import redirect_stdout

    from is3d2_tpu_torch.tools.sweep import run_sweep
    _needs_cuda()
    wd = _route_workdir(tmp_path / "wd", 4, "f32")
    with redirect_stdout(io.StringIO()):
        gpu = run_sweep(wd, ("grad", "ptb"), ("none", "shear"),
                        tmp_path / "gpu", device="cuda")
        cpu = run_sweep(wd, ("grad", "ptb"), ("none", "shear"),
                        tmp_path / "cpu", device="cpu")
    assert sorted(gpu) == sorted(cpu) and len(gpu) == 4
    for key, d in gpu.items():
        tol = kc.TOL if key[0] == "grad" else kc.FEQMOD_TOL_PLAIN
        names = sorted(p.name for p in d.iterdir())
        assert names == sorted(p.name for p in cpu[key].iterdir())
        for name in names:
            if not name.startswith("dN_pTdpTdphidy"):
                continue
            a = np.loadtxt(d / name, skiprows=1)[:, 3]
            b = np.loadtxt(cpu[key] / name, skiprows=1)[:, 3]
            assert np.isfinite(a).all()
            assert kc.max_rel_err(a[None], b[None]) <= tol, (key, name)


# ----------------------------------------------------------------------
# the multi-device path (parallel/sharding.py)
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("devices", ["cuda:0,cuda:0", "cuda:0,cuda:1"])
def test_meshed_b1_route_on_the_card(workdir, devices):
    """sharded_spectra_fast over a 2-device mesh against B1 on one device:
    a launch a shard, the result on the run's device, <= 1e-12 (B1 adds
    each cell's term into its f64 sums, so a whole-block cut moves only
    the order of those additions).  On cuda:0 + cuda:1 the second shard
    launches on cuda:1 with its own geometry; skipped below two cards."""
    from is3d2_tpu_torch.parallel import sharding as sh
    _needs_cuda()
    names = devices.split(",")
    if len(set(names)) > torch.cuda.device_count():
        pytest.skip(f"needs {len(set(names))} CUDA devices")
    cfg = Config(compute_dtype="f32c", df_mode=1, cell_block=128)
    state = kc.engine_state(workdir, cfg, make_surface(512, seed=5),
                            "cuda:0")
    ref = ck.cooper_frye_comp(*comp_operands(*state, cfg).args(), cfg)
    before = ck.cooper_frye_comp.launches
    out = sh.sharded_spectra_fast(*state, cfg, sh.make_mesh(2, 1, names))
    assert ck.cooper_frye_comp.launches - before == 2
    assert [s["device"] for s in sh.last_shards] == names
    assert all(s["geometry"] is not None for s in sh.last_shards)
    assert out.device == torch.device("cuda:0")
    ref = kc.spectra_units(state, ref)
    assert kc.max_rel_err(out.reshape(ref.shape).cpu().numpy(), ref) \
        <= 1e-12
