"""Launch geometry of kernels B1, B2, B3 and P1 (ops/launch_geometry.py and
the wrappers' ``geometry``): the host-side arithmetic the CUDA kernels
repeat.

Every momentum point must be owned by exactly one (block, thread, slot) and
every cell by exactly one split, for ragged shapes too; the phi count must
be read off the momentum rows; the split must depend on the shapes alone;
and a block of B3 must never span more species than it stages renorms for.
"""

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
    launch_geometry, momentum_index, row_length)


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
    from pathlib import Path

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
