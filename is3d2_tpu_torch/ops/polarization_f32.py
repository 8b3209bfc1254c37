"""Spin-polarization kernel P1 (f32, 2+1d and 3+1d modes) and its plain
torch versions.

The port of the JAX package's f32 polarization route,
is3d2_tpu/core/polarization_fast.py::_polzn_fast_jit (an XLA-fused program:
the JAX package has no Pallas kernel for it), which ``compute_dtype``
"f32" and "f32c" run for a mode-5 surface: the CUDA C++ kernel
csrc/polarization_f32.cu (built for sm_90a by ops/_build.py, bound with
ctypes), and its plain torch version with the same f32 arithmetic.

``polarization_f32`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; ``polarization_f32.launches`` counts
kernel launches, ``polarization_f32.last_geometry`` holds the latest
launch's geometry (ops/launch_geometry.py, from the shapes alone) and
``polarization_f32.last_launch`` its cell, eta and momentum counts and
instantiation.  A
launch takes at most ETA_CHUNK eta nodes: a longer table runs chunk by
chunk, one launch each, and the chunks' results are added in order; the
plain version chunks alike.

Two instantiations, picked on the host by ``folded`` (the gate is
core/polarization.py::fold_polarization_eta): the folded one takes the
eta >= 0 half of a symmetric table with doubled weights and drops the odd
pn terms (P = (mT cosh eta, px, py)); the general one takes every node and
P = (mT cosh eta, px, py, -mT sinh eta).

Operand layout (all contiguous; written by ``pack_inputs``):

  cell  (C, 20) f32   columns CELL_COLS: the rows of _cell_Q_polzn
                      (polarization_fast.py:61-80) without the entries
                      that are zero by construction, the u.p row times
                      log2(e) / T; only the real cells (pad_mask > 0, the
                      u.dsigma <= 0 cells included), so no mask
  eta   (Ne, 5) f32   columns ETA_COLS: cosh, -sinh, the weight w (times
                      delta_eta), w cosh and -w sinh, formed in f64
  mom   (5, M) f32    rows MOM_ROWS, m = (species, pT, phi)

and the result is (5, M) f64: the sums over cells and eta of the summands
of _polzn_value (polarization_fast.py:83-93), (g S_t, g S_x, g S_y, g S_n,
w), weighted by the eta weight.

The arithmetic, in f32, with the cells summed in f64.  Every spin
contraction is linear in (mT cosh, -mT sinh) plus a (cell, phi) part that
does not depend on eta, so the eta loop only sums, per (cell, m),

  G = sum w g,  H1 = sum (w cosh) g,  H4 = sum (-w sinh) g,  W = sum w w0

with x = e_m + exy (log2 of e^(u.p/T)), f0 = 1 / min(2^x + sign, 2^126)
(0 to f32's range where the exponential overflows, never NaN),
w0 = (d_m + dxy) f0 and g = w0 (1 - sign f0); e_m and d_m are the cell's
mT parts times cosh (and -sinh), formed once per (cell, eta, row), exy
and dxy its px/py parts, once per (cell, phi).  H4 exists only in the
general instantiation.  Once per cell,

  S_t = t3 H4 + txy G,  S_x = x0 H1 + x3 H4 + xy G,
  S_y = y0 H1 + y3 H4 + yx G,  S_n = n0 H1 + nxy G

(x0 = qx0 mT and so on, per (cell, row); txy, xy, yx, nxy per (cell,
phi)) and (S_t, S_x, S_y, S_n, W) go into the f64 sums; the factor
-1 / (4m) of the spin sums is applied once per momentum, in f64, at the
end.

The 3+1d mode (``polarization_f32_3d``, below) has counters of its own:
``polarization_f32_3d.launches``, ``.last_geometry`` and ``.last_launch``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..core.cells import CellArrays
from ..core.spectra import MomentumGridDevice, SpeciesArrays
from .cooper_frye_comp import Tile3d
from .launch_geometry import (H100_SMS, Geometry, Geometry3d,
                              launch_geometry_3d, operand_geometry,
                              over_eta_chunks)

CELL_COLS = ("qe0", "qe1", "qe2", "qe3", "qd0", "qd1", "qd2", "qd3",
             "qt1", "qt2", "qt3", "qx0", "qx2", "qx3", "qy0", "qy1", "qy3",
             "qn0", "qn1", "qn2")
ETA_COLS = ("cosh", "msinh", "w", "wcosh", "wmsinh")
MOM_ROWS = ("mT", "px", "py", "sgn", "inv4m")
N_SUMS = 5       # St, Sx, Sy, Sn, Snorm
ETA_CHUNK = 32   # kMaxEta in the CUDA source: the eta nodes of one launch
TILE_CELLS = 64  # kTileCells
MAX_DEN = 2.0 ** 126   # kMaxDen: exp overflows past it, 1 / x flushes to 0
R = 4            # kR: momenta (consecutive phi) of one thread's register tile
BLOCKS_PER_SM = 3  # kMinBlocks: what __launch_bounds__ keeps resident
# the rows constant along a (species, pT) row of the momentum grid
_ROW_KEYS = [MOM_ROWS.index(k) for k in ("mT", "sgn", "inv4m")]

# elements of one (cells x M) f32 block of the plain version
_PLAIN_BLOCK_ELEMENTS = 1 << 24

f32 = torch.float32
f64 = torch.float64


@dataclasses.dataclass
class PolarizationOperands:
    """Kernel P1's operands (see the module docstring)."""

    cell: torch.Tensor    # (C, 20) f32, real cells only
    eta: torch.Tensor     # (Ne, 5) f32
    mom: torch.Tensor     # (5, M) f32
    folded: bool          # the folded instantiation: eta >= 0 nodes only
    row_len: int          # Nphi: momenta per (species, pT) row of mom

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x eta x M."""
        return self.cell.shape[0] * self.eta.shape[0] * self.mom.shape[1]

    def args(self) -> tuple:
        return self.cell, self.eta, self.mom, self.folded


def pack_inputs(cells: CellArrays, species: SpeciesArrays,
                grid: MomentumGridDevice, T: float, d_eta: float,
                folded: bool) -> PolarizationOperands:
    """The rows of the JAX _cell_Q_polzn and _mom_polzn, prepared in f64 on
    the cells' device and cast once to f32; the real cells only.
    ``grid`` is the folded grid where ``folded`` (whose weights carry the
    fold's doubling); ``d_eta`` is the unfolded table's spacing."""
    c = _real_cells(cells)
    cell = _cell_columns(c, T)
    w = grid.eta_weight * d_eta
    ch, msh = torch.cosh(grid.eta), -torch.sinh(grid.eta)
    etas = {"cosh": ch, "msinh": msh, "w": w, "wcosh": w * ch,
            "wmsinh": w * msh}
    eta = torch.stack([etas[k] for k in ETA_COLS], dim=1)

    S = species.mass.shape[0]
    shape = (S, grid.pT.shape[0], grid.cos_phi.shape[0])
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)

    def flat(a):
        return a.expand(shape).reshape(-1)

    rows = {"mT": flat(mT[:, :, None]),
            "px": flat((grid.pT[:, None] * grid.cos_phi[None, :])[None]),
            "py": flat((grid.pT[:, None] * grid.sin_phi[None, :])[None]),
            "sgn": flat(species.sign[:, None, None]),
            "inv4m": flat((0.25 / species.mass)[:, None, None])}
    mom = torch.stack([rows[k].to(f32) for k in MOM_ROWS]).contiguous()
    return PolarizationOperands(
        cell=cell, eta=eta.to(f32).contiguous(), mom=mom, folded=folded,
        row_len=grid.cos_phi.shape[0])


def _real_cells(cells: CellArrays) -> CellArrays:
    """The cells with pad_mask > 0: every real cell, u.dsigma <= 0 too.
    Where ``cells`` carries its HostFacts, these are its first ``real``
    rows and nothing is read back from the device."""
    live = (slice(0, cells.host.real) if cells.host is not None
            else cells.pad_mask > 0)
    return CellArrays(**{f.name: getattr(cells, f.name)[live]
                         for f in dataclasses.fields(cells)})


def _cell_columns(c: CellArrays, T: float) -> torch.Tensor:
    """(C, 20) f32: the columns CELL_COLS of the cells ``c``, formed in f64
    and cast once (the same in 2+1d and 3+1d: the rows of _cell_Q_polzn
    are dimension-independent)."""
    it = 1.0 / c.tau
    to_log2 = math.log2(math.e) / T
    cols = {"qe0": c.ut * to_log2, "qe1": -c.ux * to_log2,
            "qe2": -c.uy * to_log2, "qe3": -c.tau * c.un * to_log2,
            "qd0": c.dat, "qd1": c.dax, "qd2": c.day, "qd3": c.dan * it,
            # S_t: + wyn px - wxn py + wxy pn
            "qt1": c.wyn, "qt2": -c.wxn, "qt3": c.wxy * it,
            # S_x: + wyn pt - wtn py + wty pn
            "qx0": c.wyn, "qx2": -c.wtn, "qx3": c.wty * it,
            # S_y: - wxn pt + wtn px - wtx pn
            "qy0": -c.wxn, "qy1": c.wtn, "qy3": -c.wtx * it,
            # S_n: + wxy pt - wty px + wtx py
            "qn0": c.wxy, "qn1": -c.wty, "qn2": c.wtx}
    return torch.stack([cols[k].to(f32) for k in CELL_COLS],
                       dim=1).contiguous()


def polarization_f32_plain(cell, eta, mom, folded: bool):
    """Plain torch version of the kernel: the same f32 arithmetic in the
    same order on (cell block, M) tensors (see the module docstring), the
    cells summed in f64; eta chunk by chunk, as the wrapper launches the
    kernel.  Runs on any device.  Returns (5, M) f64."""
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: _plain_chunk(cell, eta[e0:e1], mom, folded))


def _plain_chunk(cell, eta, mom, folded):
    C = cell.shape[0]
    M = mom.shape[1]
    mT, px, py, sgn, inv4m = mom
    out = torch.zeros((N_SUMS, M), dtype=f64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = {name: cell[c0:c0 + blk, i:i + 1]
             for i, name in enumerate(CELL_COLS)}
        # once per (cell, row): the mT parts
        e0, d0 = q["qe0"] * mT, q["qd0"] * mT
        x0, y0, n0 = q["qx0"] * mT, q["qy0"] * mT, q["qn0"] * mT
        # once per (cell, phi): the px/py parts of u.p and p.dsigma
        exy = q["qe1"] * px + q["qe2"] * py
        dxy = q["qd1"] * px + q["qd2"] * py
        G, H1, H4, W = (torch.zeros_like(exy) for _ in range(4))
        for e in range(eta.shape[0]):
            ch, msh, w, wc, wms = eta[e]
            # once per (cell, eta, row)
            e_m, d_m = e0 * ch, d0 * ch
            if not folded:
                e_m = e_m + q["qe3"] * mT * msh
                d_m = d_m + q["qd3"] * mT * msh
            # per evaluation
            f0 = 1.0 / torch.clamp(torch.exp2(e_m + exy) + sgn, max=MAX_DEN)
            w0 = (d_m + dxy) * f0
            g = w0 * (1.0 - sgn * f0)
            G += w * g
            H1 += wc * g
            if not folded:
                H4 += wms * g
            W += w * w0
        # once per cell: the spin contractions
        St = (q["qt1"] * px + q["qt2"] * py) * G
        Sx = x0 * H1 + (q["qx2"] * py) * G
        Sy = y0 * H1 + (q["qy1"] * px) * G
        Sn = n0 * H1 + (q["qn1"] * px + q["qn2"] * py) * G
        if not folded:
            St = St + q["qt3"] * mT * H4
            Sx = Sx + q["qx3"] * mT * H4
            Sy = Sy + q["qy3"] * mT * H4
        out += torch.stack([St, Sx, Sy, Sn, W]).to(f64).sum(dim=1)
    out[:4] *= -inv4m.to(f64)
    return out


def _check(cell, eta, mom) -> None:
    C = cell.shape[0]
    Ne = eta.shape[0]
    want = {"cell": (cell, f32, (C, len(CELL_COLS))),
            "eta": (eta, f32, (Ne, len(ETA_COLS))),
            "mom": (mom, f32, (len(MOM_ROWS), mom.shape[1]))}
    for name, (t, dtype, shape) in want.items():
        if t.device != cell.device:
            raise ValueError(f"{name} is on {t.device}, cell on {cell.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Ne < 1:
        raise ValueError("the kernel needs at least one eta node")
    if (mom.shape[1] < 1 or N_SUMS * mom.shape[1] >= 2**31
            or C >= 2**31):
        raise ValueError("momentum and cell counts must fit in int32")


def geometry(mom: torch.Tensor, n_cells: int, r: int = R,
             row_len: int | None = None) -> Geometry:
    """The launch geometry for these operands; ``row_len``, the phi count of
    the momentum grid, is read off the rows mT, sign and 1/(4m) where the
    caller leaves it out (ops/launch_geometry.py::operand_geometry)."""
    return operand_geometry(mom, _ROW_KEYS, n_cells, r, TILE_CELLS, row_len,
                            blocks_per_sm=BLOCKS_PER_SM)


def launch(cell, eta, mom, folded: bool, g: Geometry) -> torch.Tensor:
    """Launch the kernel's ``folded`` or general instantiation on checked
    CUDA operands of at most ETA_CHUNK eta nodes with the geometry ``g``."""
    from . import _build
    fn = _build.load("polarization_f32").is3d2_polarization_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty((N_SUMS, M), dtype=f64, device=cell.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, N_SUMS, M), dtype=f64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), eta.data_ptr(), mom.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), cell.shape[0],
                 eta.shape[0], M, g.row_len, g.n_split, g.cells_per_split,
                 int(folded), stream)
    if err != 0:
        raise RuntimeError(f"polarization_f32 launch failed: cudaError {err}")
    polarization_f32.launches += 1
    polarization_f32.last_geometry = g
    polarization_f32.last_launch = {"cells": cell.shape[0],
                                    "eta": eta.shape[0], "momenta": M,
                                    "folded": bool(folded), "dimension": 2}
    return out


def polarization_f32(cell, eta, mom, folded: bool,
                     row_len: int | None = None) -> torch.Tensor:
    """Run kernel P1 on CUDA tensors (its plain version on CPU tensors).
    Returns the (5, M) f64 sums.  ``folded`` picks the instantiation;
    ``row_len``: the phi count of the momentum grid, see ``geometry``."""
    _check(cell, eta, mom)
    if cell.device.type == "cpu":
        return polarization_f32_plain(cell, eta, mom, folded)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    r = _build.load("polarization_f32").is3d2_polarization_f32_tile()
    g = geometry(mom, cell.shape[0], r, row_len)
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: launch(cell, eta[e0:e1], mom, folded, g))


polarization_f32.launches = 0
polarization_f32.last_geometry = None   # of the latest launch
polarization_f32.last_launch = None     # its operand sizes and instantiation


def compute_polarization_kernel(cells: CellArrays, species: SpeciesArrays,
                                grid: MomentumGridDevice, T: float,
                                d_eta: float, folded: bool) -> torch.Tensor:
    """The f32/f32c route: (5, S, NpT, Nphi, 1) f64 raw sums through P1,
    the layout of the f64 engine."""
    ops = pack_inputs(cells, species, grid, T, d_eta, folded)
    out = polarization_f32(*ops.args(), row_len=ops.row_len)
    return out.reshape(N_SUMS, species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)


# ----------------------------------------------------------------------
# the 3+1d mode
# ----------------------------------------------------------------------
#
# The port of is3d2_tpu/core/polarization_fast.py::_polzn_fast_3d_jit (an
# XLA program).  No eta loop: each (cell, y) pair is one term, with
# P = (mT cosh d, px, py, mT sinh d), d = y - eta_cell, and no eta weight.
# The JAX program does not use the spectra's light-cone form, whose
# difference a m+ - b m- = mT sinh d cancels in f32 where y ~ eta_cell and
# the pure-pn spin terms carry it; it builds cosh d and sinh d from the
# difference itself.  So does the pack: in f64, cast once to f32.
#
# Operand layout (all contiguous; written by ``pack_inputs_3d``):
#
#   cell  (C, 21) f32      columns CELL_COLS_3D of the real cells: 2+1d's
#                          CELL_COLS, then qa = |u_perp| log2(e) / T
#   ytab  (C, Ny, 2) f32   cosh(y - eta_cell), sinh(y - eta_cell)
#   mom   (6, M) f32       rows MOM_ROWS_3D, m = (species, pT, y, phi): a
#                          (species, pT) group is n_y rows of row_len phi
#
# and the result is (5, M) f64: the sums over the cells of (g S_t, g S_x,
# g S_y, g S_n, w), the first four times -1 / (4m).
#
# The arithmetic, in f32.  Per (cell, group): the mT parts of the cell's
# rows (e0 = qe0 mT, e3 = qe3 mT, ...) and the shift A = qa pT; per (cell,
# y): e_m = e0 cosh + e3 sinh, the y factor Ey = 2^(e_m - A), d_m, and the
# spin values' (mT cosh, mT sinh) parts; per (cell, phi): their px/py parts
# exy, dxy, ... and the phi factor Ep = 2^(exy + A); per evaluation
# f0 = 1 / min(Ey Ep + sign, 2^126), w = (d_m + dxy) f0,
# g = w (1 - sign f0) and the five terms g (s_m + s_xy), w.
# Ey Ep = 2^(u.p log2(e) / T), and the shift keeps both exponents >= 0
# (exy + A >= 0 for every phi; e_m - A >= k (mT sqrt(1 + u_perp^2) -
# |u_perp| pT) > 0 for a timelike u, k = log2(e) / T), so neither factor
# underflows while the other overflows: where the product overflows, f0 is
# 2^-126 as in 2+1d, never a NaN, and Snorm stays above 0 where every term
# of a momentum overflows.  Five sums per evaluation: the terms
# of a run of RUN_CELLS_3D cells (the runs [256 k, 256 k + 256) of the
# real cells, whatever the cell split) are added in f32 in cell order, and
# each run's sum goes into the f64 sums, so the f32 -> f64 conversions and
# the kernel's round trips to its f64 sums are paid once per run, not per
# evaluation.  The JAX program sums a whole cell block in f32.

RUN_CELLS_3D = 256   # kRunCells3: one f32 run, and the grain of a cell split
CELL_COLS_3D = CELL_COLS + ("qa",)
MOM_ROWS_3D = MOM_ROWS + ("pT",)

# kP3, kY3, kThreads3, kMinBlocks3 of csrc/polarization_f32.cu: the
# geometry of a tensor that lies off the card
TILE_3D = Tile3d(r=4, ty=3, threads=64, blocks_per_sm=4)


@dataclasses.dataclass
class PolarizationOperands3d:
    """Kernel P1's 3+1d operands (see above)."""

    cell: torch.Tensor    # (C, 21) f32, real cells only
    ytab: torch.Tensor    # (C, Ny, 2) f32
    mom: torch.Tensor     # (6, M) f32
    row_len: int          # Nphi
    n_y: int              # Ny

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x M."""
        return self.cell.shape[0] * self.mom.shape[1]

    def args(self) -> tuple:
        return self.cell, self.ytab, self.mom

    def layout(self) -> dict:
        return {"row_len": self.row_len, "n_y": self.n_y}

    def first(self, n: int) -> "PolarizationOperands3d":
        """The operands cut to the first ``n`` cells."""
        return dataclasses.replace(self, cell=self.cell[:n].contiguous(),
                                   ytab=self.ytab[:n].contiguous())


def pack_inputs_3d(cells: CellArrays, species: SpeciesArrays,
                   grid: MomentumGridDevice,
                   T: float) -> PolarizationOperands3d:
    """The 3+1d operands of the real cells, prepared in f64 on the cells'
    device and cast once to f32; the momenta in (species, pT, y, phi)
    order, as B1's 3+1d mode takes them."""
    c = _real_cells(cells)
    d = grid.y[None, :] - c.eta[:, None]
    ytab = torch.stack([torch.cosh(d), torch.sinh(d)], dim=2)
    qa = torch.sqrt(c.ux ** 2 + c.uy ** 2) * (math.log2(math.e) / T)
    cell = torch.cat([_cell_columns(c, T), qa.to(f32)[:, None]], dim=1)
    S, NpT, Ny = species.mass.shape[0], grid.pT.shape[0], grid.y.shape[0]
    Nphi = grid.cos_phi.shape[0]
    shape = (S, NpT, Ny, Nphi)
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2)

    def flat(a):
        return a.expand(shape).reshape(-1)

    px = (grid.pT[:, None] * grid.cos_phi[None, :])[None, :, None, :]
    py = (grid.pT[:, None] * grid.sin_phi[None, :])[None, :, None, :]
    rows = {"mT": flat(mT[:, :, None, None]), "px": flat(px),
            "py": flat(py), "sgn": flat(species.sign[:, None, None, None]),
            "inv4m": flat((0.25 / species.mass)[:, None, None, None]),
            "pT": flat(grid.pT[None, :, None, None])}
    mom = torch.stack([rows[k].to(f32) for k in MOM_ROWS_3D]).contiguous()
    return PolarizationOperands3d(
        cell=cell.contiguous(), ytab=ytab.to(f32).contiguous(), mom=mom,
        row_len=Nphi, n_y=Ny)


def polarization_f32_3d_plain(cell, ytab, mom, row_len: int, n_y: int):
    """Plain torch version of the 3+1d mode: the kernel's f32 arithmetic
    in its order on (cells, momenta) tensors, the terms of each run of
    RUN_CELLS_3D cells added in f32 one cell after another, as the kernel
    adds them, and the runs summed in f64.  Runs on any device.  Returns
    (5, M) f64."""
    C, M = cell.shape[0], mom.shape[1]
    mT, px, py, sgn, inv4m, pT = mom
    y_of = torch.arange(M, device=mom.device) // row_len % n_y
    out = torch.zeros((N_SUMS, M), dtype=f64, device=mom.device)
    m_blk = max(1, _PLAIN_BLOCK_ELEMENTS // RUN_CELLS_3D)
    for m0 in range(0, M, m_blk):
        m = slice(m0, m0 + m_blk)
        for c0 in range(0, C, RUN_CELLS_3D):
            c1 = min(C, c0 + RUN_CELLS_3D)
            q = {name: cell[c0:c1, i:i + 1]
                 for i, name in enumerate(CELL_COLS_3D)}
            t = ytab[c0:c1][:, y_of[m]]
            ch, sh = t[..., 0], t[..., 1]
            # once per (cell, group): the mT parts and the shift
            a = q["qa"] * pT[m]
            e0, e3 = q["qe0"] * mT[m], q["qe3"] * mT[m]
            d0, d3 = q["qd0"] * mT[m], q["qd3"] * mT[m]
            # once per (cell, y): the y factor 2^(e_m - A)
            ey = torch.exp2(e0 * ch + e3 * sh - a)
            d_m = d0 * ch + d3 * sh
            st_m = (q["qt3"] * mT[m]) * sh
            sx_m = (q["qx0"] * mT[m]) * ch + (q["qx3"] * mT[m]) * sh
            sy_m = (q["qy0"] * mT[m]) * ch + (q["qy3"] * mT[m]) * sh
            sn_m = (q["qn0"] * mT[m]) * ch
            # once per (cell, phi): the phi factor 2^(exy + A)
            ep = torch.exp2(q["qe1"] * px[m] + q["qe2"] * py[m] + a)
            dxy = q["qd1"] * px[m] + q["qd2"] * py[m]
            st_xy = q["qt1"] * px[m] + q["qt2"] * py[m]
            sx_xy = q["qx2"] * py[m]
            sy_xy = q["qy1"] * px[m]
            sn_xy = q["qn1"] * px[m] + q["qn2"] * py[m]
            # per evaluation
            f0 = 1.0 / torch.clamp(ey * ep + sgn[m], max=MAX_DEN)
            w = (d_m + dxy) * f0
            g = w * (1.0 - sgn[m] * f0)
            terms = torch.stack([g * (st_m + st_xy), g * (sx_m + sx_xy),
                                 g * (sy_m + sy_xy), g * (sn_m + sn_xy), w])
            run = terms[:, 0].clone()
            for k in range(1, c1 - c0):
                run += terms[:, k]
            out[:, m] += run.to(f64)
    out[:4] *= -inv4m.to(f64)
    return out


def _check_3d(cell, ytab, mom, row_len, n_y) -> None:
    if n_y is None or n_y < 1 or row_len is None or row_len < 1:
        raise ValueError("polarization_f32_3d needs row_len and n_y, the phi "
                         "and rapidity counts of the momentum grid")
    C = cell.shape[0]
    want = {"cell": (cell, (C, len(CELL_COLS_3D))),
            "ytab": (ytab, (C, n_y, 2)),
            "mom": (mom, (len(MOM_ROWS_3D), mom.shape[-1]))}
    for name, (t, shape) in want.items():
        if t.device != cell.device:
            raise ValueError(f"{name} is on {t.device}, cell on {cell.device}")
        if t.dtype != f32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (mom.shape[1] < 1 or N_SUMS * mom.shape[1] >= 2**31 or C >= 2**31
            or C * n_y >= 2**31):
        raise ValueError("momentum and cell counts must fit in int32")


def geometry_3d(n_mom: int, n_cells: int, row_len: int, n_y: int,
                tile: Tile3d = TILE_3D, device=None) -> Geometry3d:
    """The launch geometry of the 3+1d mode on the card ``device`` (an
    H100 elsewhere)."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device is not None and device.type == "cuda" else H100_SMS)
    return launch_geometry_3d(n_mom, row_len, n_y, n_cells, tile.r, tile.ty,
                              RUN_CELLS_3D, tile.threads,
                              tile.blocks_per_sm, sms)


def launch_3d(cell, ytab, mom, g: Geometry3d, lib=None) -> torch.Tensor:
    """Launch the 3+1d mode of ``lib`` (default: this package's build) on
    checked CUDA operands of at most the built tile's kMaxY rapidities
    (``is3d2_polarization_f32_3d_max_y``) with the geometry ``g``."""
    if lib is None:
        from . import _build
        lib = _build.load("polarization_f32")
    fn = lib.is3d2_polarization_f32_3d
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty((N_SUMS, M), dtype=f64, device=cell.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, N_SUMS, M), dtype=f64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), ytab.data_ptr(), mom.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), cell.shape[0], M,
                 g.row_len, g.n_y, g.n_split, g.cells_per_split, stream)
    if err != 0:
        raise RuntimeError(f"polarization_f32_3d launch failed: cudaError "
                           f"{err}")
    polarization_f32_3d.launches += 1
    polarization_f32_3d.last_geometry = g
    polarization_f32_3d.last_launch = {"cells": cell.shape[0], "momenta": M,
                                       "n_y": g.n_y, "dimension": 3}
    return out


def polarization_f32_3d(cell, ytab, mom, row_len: int | None = None,
                        n_y: int | None = None) -> torch.Tensor:
    """Run kernel P1's 3+1d mode on CUDA tensors (its plain version on CPU
    tensors).  Returns the (5, M) f64 sums.  ``row_len`` and ``n_y``: the
    phi and y counts of the momentum grid, which the caller names (mT,
    sign and 1/(4m) are constant over a whole group, so neither can be
    read off the rows).  More rapidities than one launch takes (the
    built tile's kMaxY) run in chunks of rows, one launch each; each
    momentum's sum is the same either way."""
    _check_3d(cell, ytab, mom, row_len, n_y)
    if cell.device.type == "cpu":
        return polarization_f32_3d_plain(cell, ytab, mom, row_len, n_y)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    lib = _build.load("polarization_f32")
    tile = Tile3d.of(lib, "polarization_f32_3d")
    M = mom.shape[1]
    chunk = lib.is3d2_polarization_f32_3d_max_y()
    if n_y <= chunk:
        return launch_3d(cell, ytab, mom, geometry_3d(
            M, cell.shape[0], row_len, n_y, tile, cell.device), lib)
    if M % (n_y * row_len):
        raise ValueError(f"{n_y} rapidities run in chunks of {chunk}: the "
                         "momenta must be whole (species, pT) groups")
    groups = M // (n_y * row_len)
    full = mom.reshape(mom.shape[0], groups, n_y, row_len)
    out = torch.empty((N_SUMS, groups, n_y, row_len), dtype=f64,
                      device=cell.device)
    for y0 in range(0, n_y, chunk):
        y1 = min(n_y, y0 + chunk)
        part = full[:, :, y0:y1].reshape(mom.shape[0], -1).contiguous()
        g = geometry_3d(part.shape[1], cell.shape[0], row_len, y1 - y0, tile,
                        cell.device)
        out[:, :, y0:y1] = launch_3d(
            cell, ytab[:, y0:y1].contiguous(), part, g, lib).reshape(
                N_SUMS, groups, y1 - y0, row_len)
    return out.reshape(N_SUMS, M)


polarization_f32_3d.launches = 0
polarization_f32_3d.last_geometry = None   # of the latest launch
polarization_f32_3d.last_launch = None     # its operand sizes


def compute_polarization_kernel_3d(cells: CellArrays, species: SpeciesArrays,
                                   grid: MomentumGridDevice,
                                   T: float) -> torch.Tensor:
    """The f32/f32c route in 3+1d: (5, S, NpT, Nphi, Ny) f64 raw sums
    through P1's 3+1d mode, the layout of the f64 engine."""
    ops = pack_inputs_3d(cells, species, grid, T)
    out = polarization_f32_3d(*ops.args(), **ops.layout())
    return out.reshape(N_SUMS, species.mass.shape[0], grid.pT.shape[0],
                       ops.n_y, ops.row_len).permute(0, 1, 2, 4, 3)
