"""Operation 0 through kernel B1's per-cell mode, on the CPU.

The 2+1d df-1/2 f32/f32c route evaluates each cell once
(ops/cooper_frye_comp.py::cooper_frye_comp_cells, whose plain version runs
here) and bins the per-cell dN/dy of the three axes by contractions
(core/spacetime.py::comp_cell_bins).  Held here to the per-bin route
(``kernel_bins`` with the plain version of the op-1 kernel on each
non-empty bin), which sums the same f32 terms in f64 in another order:
<= 1e-12 relative on every bin of the three axes, for df 1 and df 2 with
each delta-f switch on and off.  Also: the driver's route launches the
per-cell mode once and the per-bin route never, the binning drops what
``_scatter`` drops, and the launch geometry of the full grid.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.core import spacetime  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_comp as ck  # noqa: E402
from is3d2_tpu_torch.ops.launch_geometry import (  # noqa: E402
    launch_geometry_cells)
from is3d2_tpu_torch.tools import kernel_check as kc  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import (add_dsigma_eta,  # noqa: E402
                                             make_surface, write_workdir)

torch.set_num_threads(1)

CHOSEN = (211, -211, 111, 321, -321, 2212, -2212, 3122)
N_CELLS = 384

# (shear, diffusion, regulate, outflow), each on and off
SWITCHES = list(itertools.product((0, 1), repeat=4))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return write_workdir(tmp_path_factory.mktemp("spacetime_cells"),
                         n_cells=16, chosen_mcids=CHOSEN, n_pT=12, n_phi=8,
                         n_eta=24, include_baryon=True, n_T=21, n_muB=9)


def _cfg(df_mode, shear=1, diffusion=0, regulate=0, outflow=0, **fields):
    return Config(operation=0, compute_dtype="f32c", cell_block=512,
                  df_mode=df_mode, include_shear_deltaf=shear,
                  include_baryon=1, include_baryondiff_deltaf=diffusion,
                  regulate_deltaf=regulate, outflow=outflow, **fields)


def _state(workdir, cfg, seed=3):
    """The df 1/2 engines' state of a surface with dsigma_eta != 0 (no eta
    fold) and baryons."""
    surf = add_dsigma_eta(make_surface(N_CELLS, seed=seed,
                                       include_baryon=True), seed, kc.DX_DAN)
    return kc.dX_state(workdir, cfg, surf, "cpu")


def _rel_every_bin(ours, ref) -> float:
    """Largest |ours - ref| / |ref| over every non-zero bin; the zero bins
    must agree."""
    ours, ref = ours.numpy(), ref.numpy()
    np.testing.assert_array_equal(ours == 0, ref == 0)
    nz = ref != 0
    return float((np.abs(ours - ref)[nz] / np.abs(ref)[nz]).max())


@pytest.mark.parametrize("df_mode", [1, 2])
@pytest.mark.parametrize("switches", SWITCHES,
                         ids=["shear{}-diff{}-reg{}-out{}".format(*s)
                              for s in SWITCHES])
def test_per_cell_route_equals_the_per_bin_route(workdir, df_mode, switches):
    shear, diffusion, regulate, outflow = switches
    cfg = _cfg(df_mode, shear, diffusion, regulate, outflow)
    state = _state(workdir, cfg)
    ours = spacetime.comp_cell_bins(*state, cfg)
    ref = spacetime.kernel_bins(
        state[0], spacetime.kernel_operands(*state, cfg), *state[2:], cfg,
        lambda o, c: spacetime.run_kernel(o, c, plain=True))
    assert [a.shape for a in ours] == [(len(CHOSEN), n)
                                       for n in (120, 60, 100)]
    for a, b in zip(ours, ref):
        assert torch.isfinite(a).all()
        assert _rel_every_bin(a, b) <= 1e-12


def test_compute_dN_dX_launches_the_per_cell_mode_once(workdir,
                                                       monkeypatch):
    """The driver's op-0 route (f32c, df 1) calls the per-cell wrapper once,
    on every cell some axis bins, and neither the per-bin route nor the
    op-1 kernel."""
    cfg = _cfg(1)
    surf = add_dsigma_eta(make_surface(N_CELLS, seed=3,
                                       include_baryon=True), 3, kc.DX_DAN)
    run = IS3D(workdir, cfg=cfg, device="cpu")
    run.surface = surf
    run._setup()
    handed = []
    per_cell = ck.cooper_frye_comp_cells

    def counted(*args, **kw):
        handed.append(args[0].shape[0])
        return per_cell(*args, **kw)

    def never(*args, **kw):
        raise AssertionError("the per-bin route ran")

    monkeypatch.setattr(ck, "cooper_frye_comp_cells", counted)
    for name in ("kernel_bins", "run_kernel"):
        monkeypatch.setattr(spacetime, name, never)
    for name in ("cooper_frye_comp", "cooper_frye_comp_plain"):
        monkeypatch.setattr(ck, name, never)
    dX = spacetime.compute_dN_dX(surf, run.species, run.chosen_idx,
                                 run.grids, run.df_data, cfg, "cpu")
    live = int((_state(workdir, cfg)[0].mask.numpy() > 0.0).sum())
    assert handed == [live] and live > 0
    for a in dX.normalized(cfg):
        assert np.isfinite(a).all() and (a != 0).any()


def test_bin_cells_drops_what_scatter_drops():
    """Cells out of an axis's range or with mask <= 0 are dropped on that
    axis; a cell in no axis is left out of the kept cells; the contraction
    equals _scatter's index_add_."""
    rng = np.random.default_rng(5)
    C, S = 200, 3
    bins = [(rng.integers(-3, 12, C), 10), (rng.integers(0, 8, C), 5),
            (rng.integers(0, 7, C), 7)]
    mask = np.where(rng.random(C) < 0.2, 0.0, 1.0)
    mask[:5] = -1.0
    bins[0][0][5:9] = 99       # out of every axis but one
    bins[1][0][5:9] = 99
    bins[2][0][5:9] = 7        # ... and that one too
    keep, rows, cols = spacetime.cell_bin_columns(bins, mask)
    assert not np.isin(np.arange(9), keep).any()
    assert np.all(mask[keep] > 0.0)
    dN = torch.as_tensor(rng.normal(size=(C, S)), dtype=torch.float64)
    ours = spacetime.bin_cells(dN[torch.as_tensor(keep)], rows, cols,
                               [n for _, n in bins])
    for a, (idx, n) in zip(ours, bins):
        ref = spacetime._scatter(dN, idx, n, mask)
        assert a.shape == ref.shape == (S, n)
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-13,
                                   atol=1e-13)


@pytest.mark.parametrize("block_cells", [1, 7, 64, 200])
def test_bin_cells_in_blocks_of_cells(monkeypatch, block_cells):
    """The one-hot contraction block by block of cells (blocks of 1, some,
    and all 200 cells, the last one short) meets _scatter's index_add_,
    and two runs give the same bits."""
    rng = np.random.default_rng(11)
    C, S = 200, 4
    bins = [(rng.integers(-2, 9, C), 8), (rng.integers(0, 6, C), 5)]
    mask = np.where(rng.random(C) < 0.1, 0.0, 1.0)
    keep, rows, cols = spacetime.cell_bin_columns(bins, mask)
    dN = torch.as_tensor(rng.normal(size=(C, S)), dtype=torch.float64)
    monkeypatch.setattr(spacetime, "_F64_BLOCK_ELEMENTS", block_cells * 13)
    ours = spacetime.bin_cells(dN[torch.as_tensor(keep)], rows, cols, [8, 5])
    again = spacetime.bin_cells(dN[torch.as_tensor(keep)], rows, cols, [8, 5])
    for a, b, (idx, n) in zip(ours, again, bins):
        assert torch.equal(a, b)
        np.testing.assert_allclose(
            a.numpy(), spacetime._scatter(dN, idx, n, mask).numpy(),
            rtol=1e-13, atol=1e-13)


def test_bin_cells_of_no_cell():
    keep, rows, cols = spacetime.cell_bin_columns(
        [(np.array([-1, 0]), 4), (np.array([2, 1]), 2)],
        np.array([1.0, 0.0]))
    assert keep.size == rows.size == cols.size == 0
    out = spacetime.bin_cells(torch.zeros((0, 3), dtype=torch.float64),
                              rows, cols, [4, 2])
    assert [tuple(a.shape) for a in out] == [(3, 4), (3, 2)]
    assert all((a == 0).all() for a in out)


def test_per_cell_plain_is_the_op1_plain_per_cell(workdir):
    """One cell's row of the per-cell plain version is the op-1 plain
    version on that cell alone, contracted with the (pT, phi) weights."""
    cfg = _cfg(2, diffusion=1)
    state = _state(workdir, cfg)
    ops = spacetime.kernel_operands(*state, cfg)
    grid = state[3]
    w = (grid.pT_weight[:, None] * grid.phi_weight[None, :]).reshape(-1)
    ours = ck.cooper_frye_comp_cells(*ops.args(), w, cfg,
                                     row_len=ops.row_len)
    S = len(CHOSEN)
    assert ours.shape == (ops.cell.shape[0], S)
    for i in (0, 7, ops.cell.shape[0] - 1):
        one = ck.cooper_frye_comp_plain(ops.cell[i:i + 1], ops.qm[i:i + 1],
                                        ops.eta, ops.eta_w, ops.mom, cfg)
        np.testing.assert_allclose(ours[i].numpy(),
                                   (one.reshape(S, -1) @ w).numpy(),
                                   rtol=1e-15, atol=0.0)


def test_per_cell_wrapper_checks_its_weights(workdir):
    cfg = _cfg(1)
    ops = spacetime.kernel_operands(*_state(workdir, cfg), cfg)
    n = ops.mom.shape[1] // len(CHOSEN)
    for bad in (torch.ones(n, dtype=torch.float32),
                torch.ones(n - 1, dtype=torch.float64),
                torch.ones((2, n), dtype=torch.float64)):
        with pytest.raises(ValueError):
            ck.cooper_frye_comp_cells(*ops.args(), bad, cfg)


def test_cells_geometry_of_the_full_grid():
    """371 species of 51 pT x 48 phi on 99,700 cells: 612 register tiles a
    species in 5 passes of 128 threads, and 7 runs of cells, which fill
    98 % of the card's block slots (371 x 7 blocks, 4 an SM)."""
    g = launch_geometry_cells(371 * 51 * 48, 51 * 48, 48, 99_700,
                              ck.TILE_CELLS, ck.TILE_CELLS_MODE.blocks_per_sm)
    tiles = g.per_species // g.row_len * -(-g.row_len // ck.R)
    threads = ck.TILE_CELLS_MODE.threads
    assert (g.n_species, tiles, -(-tiles // threads)) == (371, 612, 5)
    assert g.n_split == 7 and g.cells_per_split % ck.TILE_CELLS == 0
    assert g.n_split * g.cells_per_split >= 99_700


def test_cells_tile_matches_the_source():
    """The Python fallback of the per-cell mode's block shape is the one the
    CUDA source launches."""
    src = (Path(ck.__file__).parent.parent / "csrc"
           / "cooper_frye_comp.cu").read_text()
    m = re.search(r"constexpr int kThreadsC = (\d+), kMinBlocksC = (\d+);",
                  src)
    assert m is not None
    assert (int(m.group(1)), int(m.group(2))) == (
        ck.TILE_CELLS_MODE.threads, ck.TILE_CELLS_MODE.blocks_per_sm)
