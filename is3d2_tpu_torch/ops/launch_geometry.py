"""Launch geometry of the Cooper-Frye kernels B1, B2 and B3 and of the
polarization kernel P1, on the host.

The four kernels give a thread a register tile of ``r`` consecutive phi
of one (species, pT) row, walk the cells in shared-memory tiles, and split
the cells across ``blockIdx.y`` so that the grid fills whole waves of the
card.
Everything here is a function of the shapes (and of the card's SM count),
never of timing, so two launches on the same operands run the same grid and
give the same bits.

  * ``row_length``: the run length along which mT, mass2, b and sign stay
    constant in the momentum rows, i.e. the phi count of the grid;
  * ``launch_geometry``: tiles per row, blocks, the cell split;
  * ``operand_geometry``: the same for a kernel's momentum rows on the
    card that holds them;
  * ``momentum_index``: the map (block, thread, j) -> m that the kernels
    compute, for the tests;
  * ``launch_geometry_3d`` and ``momentum_index_3d``: the same for B1's
    3+1d mode, whose thread owns a tile of phi x y of one (species, pT)
    group, launched with its own threads a block and blocks an SM;
  * ``launch_geometry_cells``: B1's per-cell mode (operation 0), a block
    a species on a run of cells;
  * ``over_eta_chunks``: a table of more eta nodes than one launch takes,
    run chunk by chunk;
  * ``df12_flags``: the flag bits that pick the template instantiation of
    the df-1/2 kernels B1 and B2 (their ``dispatch<>``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

THREADS = 256          # kThreads of the four CUDA sources (B1's 3+1d mode
                       # launches its own, Geometry3d.threads)
BLOCKS_PER_SM = 2      # kMinBlocks of B1, B2, B3: what __launch_bounds__
                       # keeps resident (P1 and B1's 3+1d mode pass their
                       # own)
MAX_SPLIT = 32         # (n_split, M) f64 partials: 32 x 7 MB at the full grid
GOOD_FILL = 0.95       # take the smallest split that fills its waves this far
H100_SMS = 132

# flag bits of the df-1/2 launchers (B1 and B2): one template parameter each
SHEAR, DIFFUSION, REGULATE, OUTFLOW, DF2 = 1, 2, 4, 8, 16


@dataclasses.dataclass(frozen=True)
class Geometry:
    n_mom: int
    row_len: int           # momenta per (species, pT) row; the last may be short
    r: int                 # momenta of one thread's register tile
    tiles_per_row: int
    blocks: int            # gridDim.x
    n_split: int           # gridDim.y
    cells_per_split: int   # a multiple of tile_cells unless n_split == 1
    tile_cells: int

    @property
    def rows(self) -> int:
        return -(-self.n_mom // self.row_len)


@dataclasses.dataclass(frozen=True)
class Geometry3d(Geometry):
    """B1's 3+1d mode: a thread owns ``r`` phi (``tiles_per_row`` tiles
    a row) x ``ty`` y (``y_tiles`` tiles a group) of one (species, pT)
    group of ``n_y`` rows of ``row_len`` phi; ``threads`` a block."""

    n_y: int
    ty: int
    y_tiles: int
    threads: int

    @property
    def groups(self) -> int:
        return -(-self.n_mom // (self.n_y * self.row_len))


def row_length(keys: torch.Tensor, divides: int | None = None) -> int:
    """The largest L such that every row of ``keys`` (k, M) is constant on
    each run [i L, (i + 1) L) of momenta (the last run may stop short); with
    ``divides``, also a divisor of it (so that no run crosses a species)."""
    M = keys.shape[1]
    change = (keys[:, 1:] != keys[:, :-1]).any(dim=0)
    at = (torch.nonzero(change)[:, 0] + 1).cpu().numpy()
    L = int(np.gcd.reduce(at)) if at.size else M
    if divides is not None:
        L = math.gcd(L, divides)
    return L


def fill(blocks: int, resident: int) -> float:
    """Share of the card's block slots that ``blocks`` equal blocks keep busy
    over the waves they need."""
    return blocks / (-(-blocks // resident) * resident)


def split_cells(blocks: int, n_cells: int, tile_cells: int,
                resident: int) -> tuple[int, int]:
    """(n_split, cells_per_split) for a grid of ``blocks`` blocks a split,
    ``resident`` of which the card holds at once: the smallest split that
    fills its waves to GOOD_FILL, else the best-filling one."""
    n_tiles = -(-n_cells // tile_cells)
    # (split count, cell tiles per split)
    best, best_fill = (1, n_tiles), fill(blocks, resident)
    for s in range(2, min(MAX_SPLIT, n_tiles) + 1):
        if best_fill >= GOOD_FILL:
            break
        per = -(-n_tiles // s)
        actual = -(-n_tiles // per)     # no split is left empty
        f = fill(blocks * actual, resident)
        if f > best_fill:
            best, best_fill = (actual, per), f
    n_split, per = best
    return n_split, (n_cells if n_split == 1 else per * tile_cells)


def launch_geometry(n_mom: int, row_len: int, n_cells: int, r: int,
                    tile_cells: int, sm_count: int = H100_SMS,
                    blocks_per_sm: int = BLOCKS_PER_SM) -> Geometry:
    tiles_per_row = -(-row_len // r)
    rows = -(-n_mom // row_len)
    blocks = -(-rows * tiles_per_row // THREADS)
    n_split, cells_per_split = split_cells(blocks, n_cells, tile_cells,
                                           blocks_per_sm * sm_count)
    return Geometry(n_mom, row_len, r, tiles_per_row, blocks, n_split,
                    cells_per_split, tile_cells)


def launch_geometry_3d(n_mom: int, row_len: int, n_y: int, n_cells: int,
                       r: int, ty: int, tile_cells: int, threads: int,
                       blocks_per_sm: int,
                       sm_count: int = H100_SMS) -> Geometry3d:
    """B1's 3+1d mode: momenta m = (group, y, phi), a (species, pT) group
    of ``n_y`` rows of ``row_len`` phi (the last group may stop short); a
    thread owns ``r`` phi x ``ty`` y of one group."""
    tiles_per_row = -(-row_len // r)
    y_tiles = -(-n_y // ty)
    groups = -(-n_mom // (row_len * n_y))
    blocks = -(-groups * y_tiles * tiles_per_row // threads)
    n_split, cells_per_split = split_cells(blocks, n_cells, tile_cells,
                                           blocks_per_sm * sm_count)
    return Geometry3d(n_mom, row_len, r, tiles_per_row, blocks, n_split,
                      cells_per_split, tile_cells, n_y, ty, y_tiles, threads)


@dataclasses.dataclass(frozen=True)
class CellsGeometry:
    """B1's per-cell mode (operation 0): block (s, k) is species s on the
    k-th run of ``cells_per_split`` cells; the kernel walks the species'
    register tiles (of ``r`` phi in rows of ``row_len``) in passes of its
    own block size."""

    n_species: int         # gridDim.x
    per_species: int       # momenta of one species: whole rows
    row_len: int
    n_split: int           # gridDim.y
    cells_per_split: int


def launch_geometry_cells(n_mom: int, per_species: int, row_len: int,
                          n_cells: int, tile_cells: int, blocks_per_sm: int,
                          sm_count: int = H100_SMS) -> CellsGeometry:
    """B1's per-cell mode: one block a species and run of cells, the runs
    chosen as the op-1 kernels' cell split is, to fill whole waves."""
    n_species = n_mom // per_species
    n_split, cells_per_split = split_cells(n_species, n_cells, tile_cells,
                                           blocks_per_sm * sm_count)
    return CellsGeometry(n_species, per_species, row_len, n_split,
                         cells_per_split)


def operand_geometry(mom: torch.Tensor, keys: list[int], n_cells: int,
                     r: int, tile_cells: int, row_len: int | None = None,
                     divides: int | None = None,
                     blocks_per_sm: int = BLOCKS_PER_SM) -> Geometry:
    """The launch geometry for the momentum rows ``mom`` (k, M) on the card
    that holds them (an H100 for a tensor elsewhere).  ``row_len`` is the
    phi count of the momentum grid; a caller that does not know it leaves
    it out, and it is read off the rows ``keys`` of ``mom``, which are
    constant along a grid row (``row_length``), at the cost of a
    device-to-host copy."""
    if row_len is None:
        row_len = row_length(mom[keys], divides)
    sms = (torch.cuda.get_device_properties(mom.device).multi_processor_count
           if mom.device.type == "cuda" else H100_SMS)
    return launch_geometry(mom.shape[1], row_len, n_cells, r, tile_cells, sms,
                           blocks_per_sm)


def momentum_index(g: Geometry) -> np.ndarray:
    """(blocks, THREADS, r) int64: the momentum point m that thread
    ``thread`` of block ``block`` owns in slot j, or -1 where the slot is
    masked.  The same arithmetic as the kernels'."""
    gid = np.arange(g.blocks * THREADS, dtype=np.int64)
    row = gid // g.tiles_per_row
    phi = (gid % g.tiles_per_row)[:, None] * g.r + np.arange(g.r)
    m = row[:, None] * g.row_len + phi
    m = np.where((phi < g.row_len) & (m < g.n_mom), m, -1)
    return m.reshape(g.blocks, THREADS, g.r)


def momentum_index_3d(g: Geometry3d, strided: bool = False) -> np.ndarray:
    """(blocks, threads, ty, r) int64: the momentum point m that thread
    ``thread`` of block ``block`` owns in slot (i, j) -- y ``i``, phi ``j``
    of its tile -- or -1 where the slot is masked.  The same arithmetic as
    B1's 3+1d mode: a thread's phi are consecutive; ``strided``, as P1's
    3+1d mode: they are t, t + tiles_per_row, ... for its t-th phi tile."""
    gid = np.arange(g.blocks * g.threads, dtype=np.int64)
    tiles = g.tiles_per_row * g.y_tiles
    group, t = gid // tiles, gid % tiles
    y = (t // g.tiles_per_row * g.ty)[:, None, None] + np.arange(g.ty)[:, None]
    col = (t % g.tiles_per_row)[:, None, None]
    phi = (col + np.arange(g.r) * g.tiles_per_row if strided
           else col * g.r + np.arange(g.r))
    m = (group[:, None, None] * g.n_y + y) * g.row_len + phi
    m = np.where((y < g.n_y) & (phi < g.row_len) & (m < g.n_mom), m, -1)
    return m.reshape(g.blocks, g.threads, g.ty, g.r)


def cell_ranges(g: Geometry, n_cells: int) -> list[tuple[int, int]]:
    """[begin, end) of the cells each split (blockIdx.y) sums."""
    return [(y * g.cells_per_split,
             min(n_cells, (y + 1) * g.cells_per_split))
            for y in range(g.n_split)]


def over_eta_chunks(n_eta: int, chunk: int, run) -> torch.Tensor:
    """``run(e0, e1)`` on each chunk [e0, e1) of at most ``chunk`` eta
    nodes, in order, and the (M,) f64 results added in that order: a
    kernel and its plain version chunked alike sum alike, and with
    ``n_eta <= chunk`` the one result is returned as it is."""
    out = run(0, min(n_eta, chunk))
    for e0 in range(chunk, n_eta, chunk):
        out += run(e0, min(n_eta, e0 + chunk))
    return out


def has_diffusion(cfg) -> bool:
    """Whether the df-1/2 sum takes the baryon-diffusion term."""
    return bool(cfg.include_baryon and cfg.include_baryondiff_deltaf)


def df12_flags(cfg) -> int:
    """The flag bits of a df-1/2 launch (B1 and B2) for ``cfg``."""
    return ((SHEAR if cfg.include_shear_deltaf else 0)
            | (DIFFUSION if has_diffusion(cfg) else 0)
            | (REGULATE if cfg.regulate_deltaf else 0)
            | (OUTFLOW if cfg.outflow else 0)
            | (DF2 if cfg.df_mode == 2 else 0))
