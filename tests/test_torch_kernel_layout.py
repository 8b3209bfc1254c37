"""Launch geometry of kernels B1, B2, B3 and P1 (ops/launch_geometry.py and
the wrappers' ``geometry``): the host-side arithmetic the CUDA kernels
repeat.

Every momentum point must be owned by exactly one (block, thread, slot) and
every cell by exactly one split, for ragged shapes too; the phi count must
be read off the momentum rows; the split must depend on the shapes alone;
and a block of B3 must never span more species than it stages renorms for.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from is3d2_tpu_torch.ops import _build  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_comp as ck  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_f32 as b2  # noqa: E402
from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk  # noqa: E402
from is3d2_tpu_torch.ops import polarization_f32 as pz  # noqa: E402
from is3d2_tpu_torch.ops.launch_geometry import (  # noqa: E402
    BLOCKS_PER_SM, H100_SMS, MAX_SPLIT, THREADS, cell_ranges, fill,
    launch_geometry, launch_geometry_3d, momentum_index, momentum_index_3d,
    row_length)


_B1_SOURCE = (Path(ck.__file__).resolve().parent.parent / "csrc"
              / "cooper_frye_comp.cu")


def _rows(n_species, n_pT, n_phi, stop_short=0):
    """(mT, mass2, b, sgn) key rows of an (S, pT, phi) grid, phi fastest."""
    mass = 0.1 + 0.05 * np.arange(n_species)
    pT = 0.2 + 0.3 * np.arange(n_pT)
    mT = np.sqrt(mass[:, None] ** 2 + pT[None, :] ** 2)
    shape = (n_species, n_pT, n_phi)

    def flat(a):
        return np.broadcast_to(a, shape).reshape(-1)

    keys = np.stack([flat(mT[:, :, None]), flat((mass ** 2)[:, None, None]),
                     flat((np.arange(n_species) % 3 - 1.0)[:, None, None]),
                     flat((-1.0) ** np.arange(n_species)[:, None, None])])
    M = keys.shape[1] - stop_short
    return torch.from_numpy(keys[:, :M].astype(np.float32).copy())


@pytest.mark.parametrize("r", [1, 4, 6])
@pytest.mark.parametrize("n_phi", [1, 5, 7, 48])
@pytest.mark.parametrize("n_species,n_pT,stop_short", [
    (1, 1, 0), (3, 1, 0), (2, 5, 0), (4, 51, 0), (3, 4, 1), (5, 3, 2)])
def test_every_momentum_is_covered_exactly_once(n_species, n_pT, n_phi,
                                                stop_short, r):
    stop_short = min(stop_short, n_phi - 1)
    keys = _rows(n_species, n_pT, n_phi, stop_short)
    M = keys.shape[1]
    L = row_length(keys, divides=n_pT * n_phi)
    assert (n_pT * n_phi) % L == 0
    g = launch_geometry(M, L, 1000, r, 64)
    owner = momentum_index(g)
    assert owner.shape == (g.blocks, THREADS, r)
    owned = owner[owner >= 0]
    np.testing.assert_array_equal(np.sort(owned), np.arange(M))
    # a thread's momenta lie in one row: the row's key values are its own
    k = keys.numpy()
    for slots in owner.reshape(-1, r):
        mine = slots[slots >= 0]
        if mine.size:
            assert (k[:, mine] == k[:, mine[:1]]).all()
            assert slots[0] >= 0          # the kernel reads slot 0's row
    assert g.blocks == -(-g.rows * g.tiles_per_row // THREADS)


@pytest.mark.parametrize("n_phi", [1, 5, 7, 48])
def test_row_length_is_the_phi_count(n_phi):
    assert row_length(_rows(4, 6, n_phi)) == n_phi
    assert row_length(_rows(4, 6, n_phi, stop_short=n_phi // 2)) == n_phi
    # one row only: the whole of it
    assert row_length(_rows(1, 1, n_phi)) == n_phi


def test_row_length_with_equal_neighbouring_rows():
    """pi+ and pi- have equal masses: with one pT their rows have equal
    keys and merge, which is harmless for B1 (the values are shared) and
    which ``divides`` undoes for B3 (a row lies inside one species)."""
    keys = _rows(2, 1, 8)
    keys[:, 8:] = keys[:, :8]
    assert row_length(keys) == 16
    assert row_length(keys, divides=8) == 8
    # distinct momenta everywhere: rows of one
    assert row_length(torch.arange(40.0).reshape(4, 10)) == 1


@pytest.mark.parametrize("n_cells", [0, 1, 63, 64, 100, 2048, 102_400, 100_001])
@pytest.mark.parametrize("tile", [8, 16, 64])
@pytest.mark.parametrize("n_mom", [7, 1000, 39_168, 908_208])
def test_every_cell_is_in_exactly_one_split(n_cells, tile, n_mom):
    g = launch_geometry(n_mom, 8 if n_mom % 8 == 0 else 1, n_cells, 4, tile)
    ranges = cell_ranges(g, n_cells)
    assert 1 <= g.n_split <= MAX_SPLIT and len(ranges) == g.n_split
    covered = np.concatenate([np.arange(a, b) for a, b in ranges]
                             or [np.arange(0)])
    np.testing.assert_array_equal(covered, np.arange(n_cells))
    if g.n_split > 1:
        assert all(b > a for a, b in ranges)          # no empty split
        assert g.cells_per_split % tile == 0
    # what the launchers check
    assert g.n_split * g.cells_per_split >= n_cells


def test_the_split_depends_on_the_shape_alone_and_fills_the_card():
    """The main paths' shape: 887 blocks would be 3.36 waves of the 264
    resident blocks; two splits are 6.72 of 7."""
    a = launch_geometry(908_208, 48, 102_400, 4, 64)
    b = launch_geometry(908_208, 48, 102_400, 4, 64)
    assert a == b
    assert (a.tiles_per_row, a.blocks, a.n_split, a.cells_per_split) \
        == (12, 887, 2, 51_200)
    resident = BLOCKS_PER_SM * H100_SMS
    assert fill(a.blocks, resident) < 0.85
    assert fill(a.blocks * a.n_split, resident) > 0.95
    # another card, another split; a small problem is split to fill the card
    assert launch_geometry(908_208, 48, 102_400, 4, 64, sm_count=108) != a
    small = launch_geometry(39_168, 48, 2048, 4, 64)
    assert small.n_split > 1
    assert fill(small.blocks * small.n_split, resident) \
        > fill(small.blocks, resident)


@pytest.mark.parametrize("n_cells", [32, 300, 739, 1053, 1187, 1700, 3183])
@pytest.mark.parametrize("kernel", ["b1", "b3"])
def test_operation0_bin_slices_fill_the_card_from_the_momenta(kernel,
                                                              n_cells):
    """Operation 0 hands B1 and B3 the cells of one bin (32-3,183 on the
    1e5-cell main path, ~300-1,700 in most bins) and every momentum of the
    full grid (371 species x 51 x 48): the momentum axis alone gives more
    blocks than the card holds at once, every cell lies in one split, and
    the split keeps the waves full."""
    tile = ck.TILE_CELLS if kernel == "b1" else fk.TILE_CELLS
    g = launch_geometry(908_208, 48, n_cells, 4, tile)
    resident = BLOCKS_PER_SM * H100_SMS
    assert g.blocks == 887 > resident
    covered = np.concatenate([np.arange(a, b)
                              for a, b in cell_ranges(g, n_cells)])
    np.testing.assert_array_equal(covered, np.arange(n_cells))
    n_tiles = -(-n_cells // tile)
    assert g.n_split <= n_tiles
    assert fill(g.blocks * g.n_split, resident) >= fill(g.blocks, resident)
    if n_tiles >= 2:
        assert fill(g.blocks * g.n_split, resident) > 0.95


def _b2_mom(keys):
    """B2's (6, M) momentum rows with the key rows of ``_rows``."""
    mom = torch.zeros((len(b2.MOM_ROWS), keys.shape[1]))
    for name, row in zip(("mT", "mass2", "b", "sgn"), keys):
        mom[b2.MOM_ROWS.index(name)] = row
    return mom


@pytest.mark.parametrize("n_cells", [1, 63, 64, 100, 2048, 100_001])
@pytest.mark.parametrize("n_species,n_pT,n_phi,stop_short", [
    (1, 1, 1, 0), (3, 5, 7, 0), (5, 3, 7, 2), (2, 51, 48, 0), (4, 51, 48, 5),
    (371, 1, 5, 3)])
def test_b2_geometry_covers_every_momentum_and_cell_once(
        n_species, n_pT, n_phi, stop_short, n_cells):
    """Kernel B2's geometry on ragged shapes: rows that its register tile
    does not divide, momentum counts that stop inside a row, cell counts
    that fill neither the last tile nor the last split."""
    mom = _b2_mom(_rows(n_species, n_pT, n_phi, stop_short))
    M = mom.shape[1]
    g = b2.geometry(mom, n_cells)
    assert (g.row_len, g.r, g.tile_cells) == (min(n_phi, M), b2.R,
                                              b2.TILE_CELLS)
    owner = momentum_index(g)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    covered = np.concatenate([np.arange(a, b)
                              for a, b in cell_ranges(g, n_cells)])
    np.testing.assert_array_equal(covered, np.arange(n_cells))
    assert g.n_split * g.cells_per_split >= n_cells


def test_p1_split_counts_its_three_blocks_a_sm():
    """P1 keeps three blocks a SM resident (its kMinBlocks), B1-B3 two:
    on the mode-5 main path (the 100,000 real cells, 908,208 momenta)
    887 blocks are 2.24 waves of 396; three splits are 6.72 of 7."""
    mom = torch.zeros((len(pz.MOM_ROWS), 908_208))
    g = pz.geometry(mom, 100_000, row_len=48)
    assert pz.BLOCKS_PER_SM == 3 != BLOCKS_PER_SM
    assert (g.blocks, g.n_split, g.cells_per_split) == (887, 3, 33_344)
    resident = pz.BLOCKS_PER_SM * H100_SMS
    assert fill(g.blocks * g.n_split, resident) > 0.95
    assert g != launch_geometry(908_208, 48, 100_000, 4, pz.TILE_CELLS)


@pytest.mark.parametrize("n_cells", [1, 63, 64, 100, 2048, 102_400])
@pytest.mark.parametrize("n_species,n_pT,n_phi,stop_short", [
    (1, 1, 1, 0), (3, 5, 7, 0), (5, 3, 7, 2), (16, 51, 48, 0),
    (371, 51, 48, 0), (371, 1, 5, 3)])
def test_p1_geometry_covers_every_momentum_and_cell_once(
        n_species, n_pT, n_phi, stop_short, n_cells):
    """Kernel P1's geometry, read off its rows mT, sign and 1/(4m): every
    momentum owned once, every cell in one split, on ragged shapes and on
    the mode-5 main path's (371 x 51 x 48, 102,400 cells)."""
    keys = _rows(n_species, n_pT, n_phi, stop_short)
    mom = torch.zeros((len(pz.MOM_ROWS), keys.shape[1]))
    mom[pz.MOM_ROWS.index("mT")] = keys[0]
    mom[pz.MOM_ROWS.index("sgn")] = keys[3]
    mom[pz.MOM_ROWS.index("inv4m")] = 0.25 / keys[1].sqrt()
    M = mom.shape[1]
    g = pz.geometry(mom, n_cells)
    assert (g.row_len, g.r, g.tile_cells) == (min(n_phi, M), pz.R,
                                              pz.TILE_CELLS)
    assert pz.geometry(mom, n_cells, row_len=g.row_len) == g
    owner = momentum_index(g)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    covered = np.concatenate([np.arange(a, b)
                              for a, b in cell_ranges(g, n_cells)])
    np.testing.assert_array_equal(covered, np.arange(n_cells))


def test_wrappers_read_their_geometry_off_the_operands():
    n_species, n_pT, n_phi = 5, 16, 8
    keys = _rows(n_species, n_pT, n_phi)
    M = keys.shape[1]
    mom1 = torch.zeros((len(ck.MOM_ROWS), M))
    for name, row in zip(("mTf", "mass2", "b", "sgn"), keys):
        mom1[ck.MOM_ROWS.index(name)] = row
    g = ck.geometry(mom1, 300)
    assert (g.row_len, g.r, g.tile_cells) == (n_phi, ck.R, ck.TILE_CELLS)
    # a caller that knows the phi count hands it over: the same geometry,
    # and the momentum rows are not read
    assert ck.geometry(mom1, 300, row_len=n_phi) == g
    assert ck.geometry(torch.empty_like(mom1, device="meta"), 300,
                       row_len=n_phi) == g

    mom3 = torch.zeros((len(fk.MOM_ROWS), M))
    for name, row in zip(("mT", "mass2", "b", "sgn"), keys):
        mom3[fk.MOM_ROWS.index(name)] = row
    fg = fk.geometry(mom3, n_pT * n_phi, n_species, 300, 12)
    assert fg.grid.row_len == n_phi and fg.grid.r == fk.R
    assert fg.grid.tile_cells == fk.TILE_CELLS
    assert fg.smem == fk.smem_bytes(12, fg.span)
    assert fk.geometry(mom3, n_pT * n_phi, n_species, 300, 12,
                       row_len=n_phi) == fg
    # the most eta nodes and the widest span a block can have still leave
    # room for two blocks on an SM
    assert fk.smem_bytes(fk.ETA_CHUNK, 257) <= fk.MAX_SMEM

    mom2 = _b2_mom(keys)
    g2 = b2.geometry(mom2, 300)
    assert (g2.row_len, g2.r, g2.tile_cells) == (n_phi, b2.R, b2.TILE_CELLS)
    assert b2.geometry(mom2, 300, row_len=n_phi) == g2
    assert b2.geometry(torch.empty_like(mom2, device="meta"), 300,
                       row_len=n_phi) == g2


@pytest.mark.parametrize("n_species,n_pT,n_phi", [
    (8, 16, 8), (371, 51, 48), (40, 1, 1), (300, 1, 5), (6, 2, 7)])
def test_a_block_of_b3_spans_no_more_species_than_it_stages(n_species, n_pT,
                                                            n_phi):
    keys = _rows(n_species, n_pT, n_phi)
    mom = torch.zeros((len(fk.MOM_ROWS), keys.shape[1]))
    for name, row in zip(("mT", "mass2", "b", "sgn"), keys):
        mom[fk.MOM_ROWS.index(name)] = row
    nps = n_pT * n_phi
    fg = fk.geometry(mom, nps, n_species, 100, 12)
    owner = momentum_index(fg.grid)
    for block in owner:
        species = np.unique(block[block >= 0] // nps)
        assert species.size <= fg.span
        assert species.max() - species.min() + 1 <= fg.span
    assert fg.span <= n_species


def test_resource_usage_reads_the_ptxas_report(tmp_path):
    lib = tmp_path / "libk.so"
    lib.with_suffix(".ptxas").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aILb1EEvPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILb1EEvPf\n"
        "    16 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 25088 bytes smem, 416 bytes cmem[0]\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 31 registers, 376 bytes cmem[0]\n")
    assert _build.resource_usage(lib) == {
        "_Z1aILb1EEvPf": {"registers": 128, "smem": 25088, "stack": 16,
                          "spill_stores": 20, "spill_loads": 24},
        "_Z1bv": {"registers": 31, "smem": 0, "stack": 0, "spill_stores": 0,
                  "spill_loads": 0}}


def test_inner_loops_counts_the_eta_loop_by_pipe():
    """The innermost backward branch that holds an expf is the eta loop; an
    outer loop around it and a loop without an expf are not reported."""
    from is3d2_tpu_torch.tools.kernel_bench import inner_loops
    ops = ["LDS.128", "FFMA", "FADD", "MUFU.EX2", "FMUL", "MUFU.RCP", "FFMA",
           "FFMA", "DFMA", "F2F.F32.F64", "MUFU.EX2", "IADD3", "ISETP.NE.AND"]
    code = [(0x00, "MOV", "R1, c[0x0][0x28]"), (0x10, "LDS", "R2, [R0]")]
    code += [(0x20 + 0x10 * i, op, "R0, R1") for i, op in enumerate(ops)]
    code += [(0xf0, "BRA", "0x20"),          # the eta loop: two evaluations
             (0x100, "FADD", "R3, R3, R4"),
             (0x110, "BRA", "0x10"),         # the cell loop around it
             (0x120, "IADD3", "R5, R5, 0x1, RZ"),
             (0x130, "BRA", "0x120"),        # a loop without an expf
             (0x140, "BRA", "0x160"), (0x150, "EXIT", "")]
    (loop,) = inner_loops(code)
    assert loop["evaluations"] == 2 and loop["instructions"] == 14
    assert (loop["fp32"], loop["mufu"], loop["fp64"], loop["convert"]) \
        == (5, 3, 1, 1)
    assert loop["shared load"] == 1 and loop["branch/call"] == 1
    assert loop["other"] == 2
    assert loop["mufu kinds"] == ["MUFU.EX2", "MUFU.RCP"]


def test_inner_loops_counts_evaluations_by_their_unit():
    """A loop whose exponentials a register tile shares (P1's 3+1d mode:
    one MUFU.EX2 per row and per column, one MUFU.RCP per evaluation)
    counts its evaluations by the reciprocals; a loop without an expf is
    not reported whatever it holds."""
    from is3d2_tpu_torch.tools.kernel_bench import P1_3D_UNIT, inner_loops
    ops = ["MUFU.EX2", "MUFU.EX2", "FFMA", "MUFU.RCP", "FFMA", "MUFU.RCP",
           "FFMA", "MUFU.RCP", "FFMA", "MUFU.RCP"]
    code = [(0x10 * i, op, "R0, R1") for i, op in enumerate(ops)]
    code += [(0xa0, "BRA", "0x0"),
             (0xb0, "MUFU.RCP", "R2, R2"), (0xc0, "BRA", "0xb0")]
    (loop,) = inner_loops(code, P1_3D_UNIT)
    assert loop["evaluations"] == 4 and loop["mufu"] == 6
    assert inner_loops(code)[0]["evaluations"] == 2


def test_resources_reads_the_cuobjdump_report():
    from is3d2_tpu_torch.tools.kernel_bench import resources
    text = ("Fatbin elf code:\n================\narch = sm_90a\n\n"
            "Resource usage:\n Common:\n  GLOBAL:0\n"
            " Function _Z1aILb1EEvPf:\n"
            "  REG:128 STACK:16 SHARED:25088 LOCAL:0 CONSTANT[0]:416 "
            "TEXTURE:0 SURFACE:0 SAMPLER:0\n"
            " Function _Z1bv:\n"
            "  REG:31 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:376 TEXTURE:0 "
            "SURFACE:0 SAMPLER:0\n")
    assert resources(text) == {
        "_Z1aILb1EEvPf": {"REG": 128, "STACK": 16, "SHARED": 25088,
                          "LOCAL": 0},
        "_Z1bv": {"REG": 31, "STACK": 0, "SHARED": 0, "LOCAL": 0}}


def test_another_tree_loads_under_a_name_of_its_own():
    """kernel_bench times another version of the package beside this one:
    its modules are its own, not this tree's."""
    import is3d2_tpu_torch
    from is3d2_tpu_torch.tools.kernel_bench import KERNELS, load_tree
    root = Path(is3d2_tpu_torch.__file__).resolve().parent.parent
    other = load_tree(99, root)
    assert other.__name__ == "is3d2_tpu_torch_tree99"
    for kernel in KERNELS:
        theirs = kernel.wrapper(other.__name__)
        mine = kernel.wrapper("is3d2_tpu_torch")
        assert theirs is not mine and theirs.__name__ == mine.__name__
        assert theirs.__module__.startswith("is3d2_tpu_torch_tree99.")
        before = mine.launches
        theirs.launches += 1            # a counter of its own
        assert mine.launches == before


def test_disagreeing_species_are_those_furthest_from_this_tree():
    from is3d2_tpu_torch.tools.kernel_bench import (THIS_TREE,
                                                    disagreeing_species)
    mine = np.ones((6, 10))
    other = mine.copy()
    other[4, 3] += 1e-3
    other[1, 0] += 1e-5
    other[2, 9] -= 1e-4
    spectra = {THIS_TREE: mine, "plain version": mine, "other": other}
    assert disagreeing_species(spectra, 2) == [2, 4]
    assert disagreeing_species(spectra, 3) == [1, 2, 4]


def _light_cone_momenta(n_phi, n_y):
    """B1's 3+1d momentum rows of 3 species (pi+, pi-, p) x 3 pT x n_y y x
    n_phi phi, from the port's own momentum_matrix_3d_comp."""
    from is3d2_tpu_torch.core.spectra import MomentumGridDevice, SpeciesArrays
    from is3d2_tpu_torch.core.spectra_fast import momentum_matrix_3d_comp

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    phi = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    grid = MomentumGridDevice(
        pT=t([0.1, 0.7, 2.0]), pT_weight=t([1.0, 1.0, 1.0]),
        cos_phi=t(np.cos(phi)), sin_phi=t(np.sin(phi)),
        phi_weight=t(np.ones(n_phi)), y=t(np.linspace(-5.0, 5.0, n_y)),
        eta=t([0.0]), eta_weight=t([1.0]))
    species = SpeciesArrays(mass=t([0.139, 0.139, 0.938]),
                            sign=t([-1.0, -1.0, 1.0]),
                            degeneracy=t([1.0, 1.0, 2.0]),
                            baryon=t([0.0, 0.0, 1.0]))
    rows = momentum_matrix_3d_comp(species, grid)
    mom = torch.stack([rows[k].float() for k in ck.MOM_ROWS_3D]).contiguous()
    assert mom.shape[1] == 3 * 3 * n_y * n_phi
    return mom


@pytest.mark.parametrize("n_y", [1, 5, 21])
@pytest.mark.parametrize("n_phi", [1, 7, 48])
def test_3d_mode_reads_its_rows_off_the_light_cone_momenta(n_phi, n_y):
    """B1's 3+1d mode: its momenta run (species, pT, y, phi), so m+, m-,
    mass2, b and sign are constant along runs of n_phi; the geometry reads
    that off the rows, and every momentum is owned exactly once by a thread
    whose slots of one y row share those rows."""
    mom = _light_cone_momenta(n_phi, n_y)
    M = mom.shape[1]
    g = ck.geometry_3d(mom, 1000, n_y)
    # pi+ and pi- share their rows: one run may span both, as in 2+1d
    assert g.row_len % n_phi == 0
    g = ck.geometry_3d(mom, 1000, n_y, row_len=n_phi)
    assert (g.n_y, g.r, g.ty, g.threads) == (n_y, ck.TILE_3D.r,
                                             ck.TILE_3D.ty,
                                             ck.TILE_3D.threads)
    owner = momentum_index_3d(g)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    keys = mom[:9].numpy()
    for row in owner.reshape(-1, g.r):
        mine = row[row >= 0]
        if mine.size:
            assert (keys[:, mine] == keys[:, mine[:1]]).all()


def _tiles():
    from is3d2_tpu_torch.tools.kernel_bench import TILES_3D
    return [ck.Tile3d(*(int(v) for v in spec.split("x")))
            for spec in TILES_3D]


@pytest.mark.parametrize("tile", _tiles(), ids=str)
@pytest.mark.parametrize("n_phi", [1, 7, 48])
@pytest.mark.parametrize("n_y", [1, 2, 3, 5, 7, 21])
def test_3d_tile_stays_in_one_group_and_shares_its_columns(n_y, n_phi, tile):
    """The 2-D register tile of B1's 3+1d mode (r phi x ty y), for every
    tile the source may build and y counts the tile divides, does not
    divide, or exceeds: every momentum is owned once; a thread's slots
    never leave one (species, pT) group, so mass2, b and sign are equal
    across them; and the slots of one phi column share px and py across
    y, which the kernel forms once per (cell, phi)."""
    mom = _light_cone_momenta(n_phi, n_y)
    M = mom.shape[1]
    g = ck.geometry_3d(mom, 300, n_y, tile, row_len=n_phi)
    owner = momentum_index_3d(g)
    assert owner.shape == (g.blocks, tile.threads, tile.ty, tile.r)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    rows = dict(zip(ck.MOM_ROWS_3D, mom.numpy()))
    group = np.arange(M) // (n_y * n_phi)
    for slots in owner.reshape(-1, tile.ty, tile.r):
        mine = slots[slots >= 0]
        if not mine.size:
            continue
        assert slots[0, 0] >= 0           # the kernel reads slot 0's rows
        assert (group[mine] == group[mine[0]]).all()
        for key in ("mass2", "b", "sgn"):
            assert (rows[key][mine] == rows[key][mine[0]]).all()
        for col in slots.T:               # one phi column, its y rows
            col = col[col >= 0]
            for key in ("px1", "px2", "pxf", "py1", "py2", "pyf"):
                assert (rows[key][col] == rows[key][col[:1]]).all()
    assert g.blocks == -(-g.groups * g.y_tiles * g.tiles_per_row
                         // tile.threads)


def test_3d_wrapper_refuses_a_call_without_n_y():
    """The y tile cannot be read off the rows (pi+ and pi- may merge), so
    the caller names the rapidity count; without it the wrapper raises
    rather than take a tile of one y."""
    from is3d2_tpu_torch.config import Config
    mom = _light_cone_momenta(7, 5)
    cell = torch.zeros((3, len(ck.CELL_COLS_3D)))
    cfg = Config(compute_dtype="f32c", dimension=3)
    with pytest.raises(ValueError, match="n_y"):
        ck.cooper_frye_comp_3d(cell, mom, cfg)
    with pytest.raises(ValueError, match="n_y"):
        ck.cooper_frye_comp_3d(cell, mom, cfg, row_len=7)
    out = ck.cooper_frye_comp_3d(cell, mom, cfg, row_len=7, n_y=5)
    assert out.shape == (mom.shape[1],) and out.dtype == torch.float64


def test_3d_tile_of_the_source_is_the_default_and_fits_shared_memory():
    """TILE_3D is the source's kP3, kY3, kThreads3, kMinBlocks3; every
    raced tile keeps the mode's static shared memory (the cell tile and
    its rows' m+ and m-) under 48 KB and its threads a whole number of
    warps."""
    from is3d2_tpu_torch.tools.kernel_bench import TILE_LINE_3D, TILES_3D
    src = _B1_SOURCE.read_text()
    [line] = re.findall(TILE_LINE_3D, src)
    assert ck.Tile3d(*map(int, re.findall(r"\d+", line)[1::2])) == ck.TILE_3D
    assert "x".join(map(str, (ck.TILE_3D.r, ck.TILE_3D.ty, ck.TILE_3D.threads,
                              ck.TILE_3D.blocks_per_sm))) in TILES_3D
    for tile in _tiles():
        rows = 8 * 3 * tile.ty * tile.threads
        assert 4 * ck.TILE_CELLS_3D * len(ck.CELL_COLS_3D) + rows <= 48 * 1024
        assert tile.threads % 32 == 0


def test_3d_main_path_fills_the_card_without_a_split():
    """Phase 24's shape, 99,753 live cells x 371 x 51 x 21 y x 48 phi:
    18,921 groups of 7 y tiles x 12 phi tiles, whole waves of the card
    without a cell split, for the tile the source builds."""
    t = ck.TILE_3D
    g = launch_geometry_3d(19_072_368, 48, 21, 99_753, t.r, t.ty,
                           ck.TILE_CELLS_3D, t.threads, t.blocks_per_sm)
    assert (g.groups, g.tiles_per_row) == (18_921, 12)
    assert g.y_tiles == -(-21 // t.ty)
    assert g.n_split == 1 and g.cells_per_split == 99_753
    assert fill(g.blocks, t.blocks_per_sm * H100_SMS) > 0.95


def test_tile_tree_rewrites_only_the_3d_tile(tmp_path):
    """kernel_bench --tile3d races a copy of this tree whose source differs
    in the 3+1d mode's tile line alone."""
    from is3d2_tpu_torch.tools.kernel_bench import tile_tree
    root = tile_tree("4x7x128x2", tmp_path)
    new = (root / "is3d2_tpu_torch/csrc/cooper_frye_comp.cu").read_text()
    old = _B1_SOURCE.read_text()
    diff = [(a, b) for a, b in zip(old.splitlines(), new.splitlines())
            if a != b]
    assert diff == [(diff[0][0], "constexpr int kP3 = 4, kY3 = 7, "
                                 "kThreads3 = 128, kMinBlocks3 = 2;")]
    assert len(old.splitlines()) == len(new.splitlines())


# ----------------------------------------------------------------------
# kernel B3's 3+1d mode
# ----------------------------------------------------------------------

_B3_SOURCE = _B1_SOURCE.parent / "cooper_frye_feqmod.cu"


def _b3_momenta(n_phi, n_y):
    """B3's 3+1d f64 momentum rows of 3 species (pi+, pi-, p) x 3 pT x n_y
    y x n_phi phi, from the port's own momentum_matrix_3d."""
    from is3d2_tpu_torch.core.spectra import MomentumGridDevice, SpeciesArrays
    from is3d2_tpu_torch.core.spectra_fast import momentum_matrix_3d

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    phi = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    grid = MomentumGridDevice(
        pT=t([0.1, 0.7, 2.0]), pT_weight=t([1.0, 1.0, 1.0]),
        cos_phi=t(np.cos(phi)), sin_phi=t(np.sin(phi)),
        phi_weight=t(np.ones(n_phi)), y=t(np.linspace(-5.0, 5.0, n_y)),
        eta=t([0.0]), eta_weight=t([1.0]))
    species = SpeciesArrays(mass=t([0.139, 0.139, 0.938]),
                            sign=t([-1.0, -1.0, 1.0]),
                            degeneracy=t([1.0, 1.0, 2.0]),
                            baryon=t([0.0, 0.0, 1.0]))
    rows = momentum_matrix_3d(species, grid)
    return torch.stack([rows[k] for k in fk.MOM_ROWS_3D]).contiguous()


def test_b3_3d_tile_of_the_source_is_the_default_and_fits_shared_memory():
    """TILE_3D is the source's mixed kernel's kP3m, kY3m, kThreads3m,
    kMinBlocks3m and TILE_3D_CLEAN its clean kernel's kP3, kY3, kThreads3,
    kMinBlocks3; the cell tile (f32 and f64 columns) stays within 48 KB of
    static shared memory; the column counts are the source's."""
    src = _B3_SOURCE.read_text()
    for pattern, tile in ((r"constexpr int kP3m = .*;", fk.TILE_3D),
                          (r"constexpr int kP3 = .*;", fk.TILE_3D_CLEAN)):
        [line] = re.findall(pattern, src)
        assert ck.Tile3d(*map(int, re.findall(r"= (\d+)", line))) == tile
        assert tile.threads % 32 == 0
    for name, value in (("kCols3", fk.N_COLS_3D), ("kColsD3", fk.N_COLD_3D),
                        ("kTileCells3", fk.TILE_CELLS_3D)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert (4 * fk.N_COLS_3D + 8 * fk.N_COLD_3D) * fk.TILE_CELLS_3D \
        <= 48 * 1024


def test_b3_3d_sums_and_momenta_fit_shared_memory_at_the_tiles_blocks():
    """Both 3+1d kernels keep their f64 sums in shared memory, a column a
    thread: the mixed kernel's static arrays (cell tile and sums) stay
    within 48 KB, and the clean kernel's (its cell tile, then a thread's
    f64 and f32 momenta and its sums, dynamic) fit kMinBlocks3 blocks on
    an H100 SM (227 KB a block, 228 KB an SM with 1 KB reserved a block)."""
    src = _B3_SOURCE.read_text()
    assert re.search(r"__shared__ double s_acc\[kY3m \* kP3m\]\[kThreads3m\]",
                     src)
    t, tm = fk.TILE_3D_CLEAN, fk.TILE_3D
    tile = fk.TILE_CELLS_3D * (4 * fk.N_COLS_3D + 8 * fk.N_COLD_3D)
    assert tile + 8 * tm.r * tm.ty * tm.threads <= 48 * 1024
    clean_static = fk.TILE_CELLS_3D * (4 * fk.N_COLS_3D + 8 * 12)
    clean_dynamic = t.threads * ((t.r + t.ty) * (16 + 8) + 8 * t.r * t.ty)
    assert clean_static <= 48 * 1024 and clean_dynamic <= 227 * 1024
    assert t.blocks_per_sm * (clean_static + clean_dynamic + 1024) \
        <= 228 * 1024


@pytest.mark.parametrize("n_y", [1, 3, 5, 21])
@pytest.mark.parametrize("n_phi", [1, 7, 48])
def test_b3_3d_geometry_owns_every_momentum_once(n_phi, n_y):
    """B3's 3+1d mode takes B1's 3+1d geometry with its own tile: every
    momentum is owned once, a thread's slots stay in one (species, pT)
    group (its species' renorm, mass2, b and sign), the slots of a y row
    share m+ and m-, those of a phi column px and py; the row length is
    read off the rows where the caller leaves it out."""
    mom = _b3_momenta(n_phi, n_y)
    M = mom.shape[1]
    assert fk.geometry_3d(mom, 1000, n_y).row_len % n_phi == 0
    g = fk.geometry_3d(mom, 1000, n_y, row_len=n_phi)
    t = fk.TILE_3D
    assert (g.n_y, g.r, g.ty, g.threads, g.tile_cells) == (
        n_y, t.r, t.ty, t.threads, fk.TILE_CELLS_3D)
    owner = momentum_index_3d(g)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    rows = dict(zip(fk.MOM_ROWS_3D, mom.numpy()))
    species = np.arange(M) // (3 * n_y * n_phi)
    for slots in owner.reshape(-1, t.ty, t.r):
        mine = slots[slots >= 0]
        if not mine.size:
            continue
        assert slots[0, 0] >= 0
        assert (species[mine] == species[mine[0]]).all()
        for key in ("mass2", "b", "sgn"):
            assert (rows[key][mine] == rows[key][mine[0]]).all()
        for row in slots:
            row = row[row >= 0]
            for key in ("mp", "mm"):
                assert (rows[key][row] == rows[key][row[:1]]).all()
        for col in slots.T:
            col = col[col >= 0]
            for key in ("px", "py"):
                assert (rows[key][col] == rows[key][col[:1]]).all()


def test_b3_3d_main_path_fills_the_card_without_a_split():
    """Phase 31's shape, 99,753 live cells x 371 x 51 x 21 y x 48 phi:
    18,921 groups of 7 y tiles x 12 phi tiles, whole waves of the card
    without a cell split."""
    t = fk.TILE_3D
    g = launch_geometry_3d(19_072_368, 48, 21, 99_753, t.r, t.ty,
                           fk.TILE_CELLS_3D, t.threads, t.blocks_per_sm)
    assert (g.groups, g.tiles_per_row, g.y_tiles) == (18_921, 12, 7)
    assert g.n_split == 1 and g.cells_per_split == 99_753
    assert fill(g.blocks, t.blocks_per_sm * H100_SMS) > 0.95


@pytest.mark.parametrize("n_y", [1, 3, 5, 21])
@pytest.mark.parametrize("n_phi", [1, 7, 48])
def test_b3_3d_clean_geometry_owns_every_momentum_once(n_phi, n_y):
    """The clean kernel's tile: every momentum owned once, ragged y and
    phi masked, a thread's slots in one (species, pT) group, each y row of
    its slots on one (m+, m-) and each phi column on one (px, py)."""
    mom = _b3_momenta(n_phi, n_y)
    M = mom.shape[1]
    t = fk.TILE_3D_CLEAN
    g = fk.geometry_3d(mom, 1000, n_y, t, row_len=n_phi)
    assert (g.r, g.ty, g.threads) == (t.r, t.ty, t.threads)
    owner = momentum_index_3d(g)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    rows = dict(zip(fk.MOM_ROWS_3D, mom.numpy()))
    group = np.arange(M) // (n_y * n_phi)
    for slots in owner.reshape(-1, t.ty, t.r):
        mine = slots[slots >= 0]
        if not mine.size:
            continue
        assert slots[0, 0] >= 0 and (group[mine] == group[mine[0]]).all()
        for row in slots:
            row = row[row >= 0]
            for key in ("mp", "mm"):
                assert (rows[key][row] == rows[key][row[:1]]).all()
        for col in slots.T:
            col = col[col >= 0]
            for key in ("px", "py"):
                assert (rows[key][col] == rows[key][col[:1]]).all()


@pytest.mark.parametrize("n_cells", [1, 33, 1000, 4096])
@pytest.mark.parametrize("clean_share", [0.0, 0.3, 0.92, 1.0])
@pytest.mark.parametrize("n_species", [1, 3])
def test_b3_3d_split_route_sums_every_cell_once(n_cells, clean_share,
                                                n_species):
    """The split route's partial rows: the clean kernel's splits cover the
    clean cells [0, n_clean), the mixed kernel's the rest, every cell once
    and in order, whatever the two geometries' splits."""
    mom = _b3_momenta(7, 3)[:, :n_species * 3 * 3 * 7]
    n_clean = int(clean_share * n_cells)
    g_clean = fk.geometry_3d(mom, n_cells, 3, fk.TILE_3D_CLEAN, row_len=7)
    g = fk.geometry_3d(mom, n_cells, 3, fk.TILE_3D, row_len=7)
    for gg in (g_clean, g):
        assert gg.n_split * gg.cells_per_split >= n_cells
    ranges = fk.cell_ranges_3d(g_clean, g, n_clean, n_cells)
    assert len(ranges) == g_clean.n_split + g.n_split
    cells = np.concatenate([np.arange(a, b) for a, b in ranges])
    np.testing.assert_array_equal(cells, np.arange(n_cells))
    assert all(b <= n_clean for a, b in ranges[:g_clean.n_split] if a < b)
    assert all(a >= n_clean for a, b in ranges[g_clean.n_split:] if a < b)


def test_b3_3d_clean_kernel_fills_the_card_without_a_split():
    """Phase 31's shape through the clean kernel's tile: whole waves of
    the card without a cell split."""
    t = fk.TILE_3D_CLEAN
    g = launch_geometry_3d(19_072_368, 48, 21, 99_753, t.r, t.ty,
                           fk.TILE_CELLS_3D, t.threads, t.blocks_per_sm)
    assert g.groups == 18_921
    assert g.n_split == 1 and g.cells_per_split == 99_753
    assert fill(g.blocks, t.blocks_per_sm * H100_SMS) > 0.95


def test_b3_3d_wrapper_checks_its_operands():
    """The 3+1d wrapper needs n_y, f64 U / momenta / y and f32 columns of
    the layout's widths, and a species a whole number of groups."""
    from is3d2_tpu_torch.config import Config
    mom = _b3_momenta(7, 5)
    C, S, M = 3, 3, mom.shape[1]
    args = [torch.zeros((C, fk.N_COLS_3D)),
            torch.zeros((C, fk.N_COLD_3D), dtype=torch.float64), mom,
            torch.linspace(-5.0, 5.0, 5, dtype=torch.float64),
            torch.zeros((C, S)), torch.zeros((C, S)), M // S]
    cfg = Config(compute_dtype="f32", df_mode=4, dimension=3)
    with pytest.raises(ValueError, match="n_y"):
        fk.cooper_frye_feqmod_3d(*args, cfg, "feqmod", row_len=7)
    out = fk.cooper_frye_feqmod_3d(*args, cfg, "feqmod", row_len=7, n_y=5)
    assert out.shape == (M,) and out.dtype == torch.float64
    bad = list(args)
    bad[1] = bad[1].float()
    with pytest.raises(ValueError, match="cold"):
        fk.cooper_frye_feqmod_3d(*bad, cfg, "feqmod", row_len=7, n_y=5)
    with pytest.raises(ValueError, match="groups"):
        fk.cooper_frye_feqmod_3d(*args, cfg, "feqmod", row_len=6, n_y=5)


def test_tile_tree_rewrites_only_b3s_3d_tile(tmp_path):
    """kernel_bench --tile3d-b3 races a copy of this tree whose B3 source
    differs in the clean kernel's tile line alone; the tiles the source
    builds are among the raced ones."""
    from is3d2_tpu_torch.tools.kernel_bench import TILES_3D_B3, tile_tree
    for t in (fk.TILE_3D, fk.TILE_3D_CLEAN):
        assert f"{t.r}x{t.ty}x{t.threads}x{t.blocks_per_sm}" in TILES_3D_B3
    root = tile_tree("4x3x128x3", tmp_path, "cooper_frye_feqmod")
    new = (root / "is3d2_tpu_torch/csrc/cooper_frye_feqmod.cu").read_text()
    old = _B3_SOURCE.read_text()
    diff = [(a, b) for a, b in zip(old.splitlines(), new.splitlines())
            if a != b]
    assert diff == [(diff[0][0], "constexpr int kP3 = 4, kY3 = 3, "
                                 "kThreads3 = 128, kMinBlocks3 = 3;")]
    assert (root / "is3d2_tpu_torch/csrc/cooper_frye_comp.cu").read_text() \
        == _B1_SOURCE.read_text()


# ----------------------------------------------------------------------
# kernel P1's 3+1d mode
# ----------------------------------------------------------------------

_P1_SOURCE = _B1_SOURCE.parent / "polarization_f32.cu"


def _p1_tiles():
    from is3d2_tpu_torch.tools.kernel_bench import TILES_3D_P1
    return [ck.Tile3d(*(int(v) for v in spec.split("x")))
            for spec in TILES_3D_P1]


def _p1_3d_momenta(n_phi, n_y, n_pT=3):
    """P1's 3+1d momentum rows of 3 species (pi+, pi-, p) x n_pT pT x n_y
    y x n_phi phi, from the pack."""
    from is3d2_tpu_torch.core.cells import CellArrays
    from is3d2_tpu_torch.core.spectra import MomentumGridDevice, SpeciesArrays

    def t(a):
        return torch.tensor(a, dtype=torch.float64)
    phi = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    grid = MomentumGridDevice(
        pT=t(0.2 + 0.3 * np.arange(n_pT)), pT_weight=t(np.ones(n_pT)),
        cos_phi=t(np.cos(phi)), sin_phi=t(np.sin(phi)),
        phi_weight=t(np.ones(n_phi)), y=t(np.linspace(-5.0, 5.0, n_y)),
        eta=t([0.0]), eta_weight=t([1.0]))
    species = SpeciesArrays(mass=t([0.139, 0.139, 0.938]),
                            sign=t([-1.0, -1.0, 1.0]),
                            degeneracy=t([1.0, 1.0, 2.0]),
                            baryon=t([0.0, 0.0, 1.0]))
    one = torch.ones(1, dtype=torch.float64)
    cells = CellArrays(**{f.name: one.clone()
                          for f in dataclasses.fields(CellArrays)})
    return pz.pack_inputs_3d(cells, species, grid, 0.15).mom


@pytest.mark.parametrize("tile", _p1_tiles(), ids=str)
@pytest.mark.parametrize("n_phi", [1, 7, 48])
@pytest.mark.parametrize("n_y", [1, 2, 3, 5, 21])
def test_p1_3d_tile_stays_in_one_group(n_y, n_phi, tile):
    """P1's 3+1d register tile (r phi x ty y), for every raced tile: every
    momentum owned once; a thread's slots never leave one (species, pT)
    group, so mT, sign and 1/(4m) are equal across them; a phi column's
    slots share px and py across y; each slot's y is the row the kernel
    reads its (cosh, sinh) from."""
    mom = _p1_3d_momenta(n_phi, n_y)
    M = mom.shape[1]
    g = pz.geometry_3d(M, 300, n_phi, n_y, tile)
    owner = momentum_index_3d(g, strided=True)
    assert owner.shape == (g.blocks, tile.threads, tile.ty, tile.r)
    np.testing.assert_array_equal(np.sort(owner[owner >= 0]), np.arange(M))
    rows = dict(zip(pz.MOM_ROWS_3D, mom.numpy()))
    group = np.arange(M) // (n_y * n_phi)
    y_of = np.arange(M) // n_phi % n_y
    for slots in owner.reshape(-1, tile.ty, tile.r):
        mine = slots[slots >= 0]
        if not mine.size:
            continue
        assert slots[0, 0] >= 0
        assert (group[mine] == group[mine[0]]).all()
        for key in ("mT", "sgn", "inv4m", "pT"):
            assert (rows[key][mine] == rows[key][mine[0]]).all()
        for i, row in enumerate(slots):
            row = row[row >= 0]
            assert (y_of[row] == y_of[slots[0, 0]] + i).all()
        for col in slots.T:
            col = col[col >= 0]
            for key in ("px", "py"):
                assert (rows[key][col] == rows[key][col[:1]]).all()


@pytest.mark.parametrize("strided,least", [(True, 0.8), (False, 0.0)])
def test_p1_3d_warps_read_whole_sectors_of_the_sums(strided, least):
    """On phase 36's grid (48 phi, 21 y) the f64 sums a warp reads and
    writes together (one slot (i, j) of its 32 threads) fill at least 80 %
    of the 32-byte sectors they touch with P1's strided phi, and 25 % with
    a thread's phi consecutive (B1's layout): the reason for the stride."""
    t = pz.TILE_3D
    g = pz.geometry_3d(51 * 21 * 48 * 3, 300, 48, 21, t)
    owner = momentum_index_3d(g, strided=strided)
    warps = owner.reshape(-1, 32, t.ty, t.r)
    used = []
    for i in range(t.ty):
        for j in range(t.r):
            m = warps[:, :, i, j]
            for row in m:
                row = row[row >= 0]
                if row.size:
                    used.append(8 * row.size / (32 * np.unique(row // 4).size))
    share = float(np.mean(used))
    assert share >= least
    if not strided:
        assert share <= 1 / t.r + 1e-9


def _p1_source_int(src, name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                         src)[1])


def _p1_smem(src, n_y):
    """A block's shared memory in P1's 3+1d mode: the cell tile (static),
    each cell's columns staged at a stride of kCellStride3 floats, and the
    tile's y rows (dynamic); no tile shape enters it."""
    tile = _p1_source_int(src, "kTileCells3")
    return (4 * tile * _p1_source_int(src, "kCellStride3")
            + 8 * tile * n_y)


# the f64 sums the resident threads of P1's 3+1d mode keep in the
# launch's rows of its result, 5 per momentum, stay this far inside the
# H100's 50 MB L2 (kernel_bench races tiles past it)
L2_BYTES = 50 * 2**20
P1_SUMS_L2_SHARE = 0.8


def _p1_resident_sums(tile):
    return (tile.blocks_per_sm * H100_SMS * tile.threads * tile.r * tile.ty
            * pz.N_SUMS * 8)


def test_p1_3d_tile_of_the_source_is_the_default_and_fits_shared_memory():
    """TILE_3D is the source's kP3, kY3, kThreads3, kMinBlocks3 and among
    the raced tiles; a staged cell holds CELL_COLS_3D in whole 16-byte
    vectors; with 21 y rows its blocks_per_sm blocks fit an SM's 228 KB,
    and a launch takes kMaxY = 256 y rows, whose block fits a block's 227
    KB; the f64 sums of its resident threads stay inside P1_SUMS_L2_SHARE
    of L2; every raced tile is whole warps."""
    from is3d2_tpu_torch.tools.kernel_bench import TILE_LINE_3D, TILES_3D_P1
    src = _P1_SOURCE.read_text()
    [line] = re.findall(TILE_LINE_3D, src)
    t = ck.Tile3d(*map(int, re.findall(r"= (\d+)", line)))
    assert t == pz.TILE_3D
    assert f"{t.r}x{t.ty}x{t.threads}x{t.blocks_per_sm}" in TILES_3D_P1
    assert _p1_source_int(src, "kRunCells3") == pz.RUN_CELLS_3D
    assert pz.RUN_CELLS_3D % _p1_source_int(src, "kTileCells3") == 0
    stride = _p1_source_int(src, "kCellStride3")
    assert stride % 4 == 0 and stride >= len(pz.CELL_COLS_3D)
    assert t.blocks_per_sm * _p1_smem(src, 21) <= 228 * 1024
    assert _p1_source_int(src, "kMaxY") == 256
    assert _p1_smem(src, 256) <= _p1_source_int(src, "kBlockSmem") == 232448
    assert _p1_resident_sums(t) <= P1_SUMS_L2_SHARE * L2_BYTES
    for tile in _p1_tiles():
        assert tile.threads % 32 == 0


def test_p1_3d_main_path_fills_the_card_without_a_split():
    """Phase 36's shape, 100,000 real cells x 371 x 51 x 21 y x 48 phi:
    18,921 groups of whole tiles (the tile divides 21 y and 48 phi), whole
    waves of the card without a cell split, for the tile the source
    builds."""
    t = pz.TILE_3D
    assert 21 % t.ty == 0 and 48 % t.r == 0
    g = pz.geometry_3d(19_072_368, 100_000, 48, 21, t)
    assert (g.groups, g.tiles_per_row, g.y_tiles) == (18_921, 48 // t.r,
                                                      21 // t.ty)
    assert g.n_split == 1 and g.cells_per_split == 100_000
    assert fill(g.blocks, t.blocks_per_sm * H100_SMS) > 0.95


@pytest.mark.parametrize("n_cells", [1, 64, 65, 1000, 4096, 20_000])
def test_p1_3d_splits_begin_on_a_run(n_cells):
    """Each cell split of the 3+1d mode begins on a run of RUN_CELLS_3D
    cells, so the kernel's f32 runs are the plain version's
    [256 k, 256 k + 256)."""
    g = pz.geometry_3d(21 * 7, n_cells, 7, 21)
    ranges = cell_ranges(g, n_cells)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_cells
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(a % pz.RUN_CELLS_3D == 0 for a, _ in ranges)


def test_tile_tree_rewrites_only_p1s_3d_tile(tmp_path):
    """kernel_bench --tile3d-p1 races a copy of this tree whose P1 source
    differs in the 3+1d mode's tile line alone."""
    from is3d2_tpu_torch.tools.kernel_bench import tile_tree
    root = tile_tree("2x7x128x2", tmp_path, "polarization_f32")
    new = (root / "is3d2_tpu_torch/csrc/polarization_f32.cu").read_text()
    old = _P1_SOURCE.read_text()
    diff = [(a, b) for a, b in zip(old.splitlines(), new.splitlines())
            if a != b]
    assert diff == [(diff[0][0], "constexpr int kP3 = 2, kY3 = 7, "
                                 "kThreads3 = 128, kMinBlocks3 = 2;")]
    assert (root / "is3d2_tpu_torch/csrc/cooper_frye_comp.cu").read_text() \
        == _B1_SOURCE.read_text()
