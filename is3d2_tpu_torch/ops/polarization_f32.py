"""Spin-polarization kernel P1 (f32, 2+1d) and its plain torch version.

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
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..core.cells import CellArrays
from ..core.spectra import MomentumGridDevice, SpeciesArrays
from .launch_geometry import Geometry, operand_geometry, over_eta_chunks

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
    live = cells.pad_mask > 0
    c = CellArrays(**{f.name: getattr(cells, f.name)[live]
                      for f in dataclasses.fields(cells)})
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
    cell = torch.stack([cols[k].to(f32) for k in CELL_COLS],
                       dim=1).contiguous()
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
                                    "folded": bool(folded)}
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
