"""Spin-polarization kernel P1 (f32, 2+1d) and its plain torch version.

The port of the JAX package's f32 polarization route,
is3d2_tpu/core/polarization_fast.py::_polzn_fast_jit (an XLA-fused program:
the JAX package has no Pallas kernel for it), which ``compute_dtype``
"f32" and "f32c" run for a mode-5 surface: the CUDA C++ kernel
csrc/polarization_f32.cu (built for sm_90a by ops/_build.py, bound with
ctypes), and its plain torch version with the same f32 arithmetic.

``polarization_f32`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; ``polarization_f32.launches`` counts
kernel launches and ``polarization_f32.last_geometry`` holds the latest
launch's geometry (ops/launch_geometry.py, from the shapes alone).  A
launch takes at most ETA_CHUNK eta nodes: a longer table runs chunk by
chunk, one launch each, and the chunks' results are added in order; the
plain version chunks alike.

Operand layout (all contiguous; written by ``pack_inputs``):

  cell  (C, 24) f32   columns CELL_COLS: the rows of _cell_Q_polzn
                      (polarization_fast.py:61-80) without the entries
                      that are zero by construction, then pad_mask
  eta   (Ne, 2) f32   cosh(eta), -sinh(eta)
  eta_w (Ne,) f64     quadrature weights times delta_eta
  mom   (5, M) f32    rows MOM_ROWS, m = (species, pT, phi)
  inv_T               1 / T of the surface average, rounded to f32

and the result is (5, M) f64: the sums over cells and eta of the summands
of _polzn_value (polarization_fast.py:83-93), (g S_t, g S_x, g S_y, g S_n,
w), weighted by pad_mask and the eta weight.

The arithmetic, in f32, of one (cell, eta, m) evaluation with
P = (m1, px, py, m4) = (mT cosh, px, py, -mT sinh):

  * per (cell, eta, species, pT), shared by the phi of a row: m1, m4 and
    the mT parts of the six contractions (e_m, d_m, t_m, x_m, y_m, n_m);
  * per (cell, phi), independent of eta: their px/py parts (exy, dxy, txy,
    xy, yx, nxy);
  * E = e_m + exy, f0 = 1 / min(e^(E / T) + sign, 2^126) (0 to f32's
    range where the exponential overflows, never NaN), w = (d_m + dxy) f0,
    g = -w (1 - sign f0) / (4 m);
  * the five summands g (t_m + txy), g (x_m + xy), g (y_m + yx),
    g (n_m + nxy) and w, each summed over the eta terms of a cell in f32
    with f32 weights; the cells, times pad_mask, in f64.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.cells import CellArrays
from ..core.spectra import MomentumGridDevice, SpeciesArrays
from .launch_geometry import Geometry, operand_geometry, over_eta_chunks

CELL_COLS = ("qe0", "qe1", "qe2", "qe3", "qd0", "qd1", "qd2", "qd3",
             "qt1", "qt2", "qt3", "qx0", "qx2", "qx3", "qy0", "qy1", "qy3",
             "qn0", "qn1", "qn2", "mask", "unused0", "unused1", "unused2")
MOM_ROWS = ("mT", "px", "py", "sgn", "inv4m")
N_SUMS = 5       # St, Sx, Sy, Sn, Snorm
ETA_CHUNK = 32   # kMaxEta in the CUDA source: the eta nodes of one launch
TILE_CELLS = 64  # kTileCells
MAX_DEN = 2.0 ** 126   # kMaxDen: exp overflows past it, 1 / x flushes to 0
R = 4            # kR: momenta (consecutive phi) of one thread's register tile
# the rows constant along a (species, pT) row of the momentum grid
_ROW_KEYS = [MOM_ROWS.index(k) for k in ("mT", "sgn", "inv4m")]

# elements of one (cells x M) f32 block of the plain version
_PLAIN_BLOCK_ELEMENTS = 1 << 24

f32 = torch.float32
f64 = torch.float64


@dataclasses.dataclass
class PolarizationOperands:
    """Kernel P1's operands (see the module docstring)."""

    cell: torch.Tensor    # (C, 24) f32
    eta: torch.Tensor     # (Ne, 2) f32
    eta_w: torch.Tensor   # (Ne,) f64, times delta_eta
    mom: torch.Tensor     # (5, M) f32
    inv_T: float          # rounded to f32 by the wrappers
    row_len: int          # Nphi: momenta per (species, pT) row of mom

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x eta x M."""
        return self.cell.shape[0] * self.eta.shape[0] * self.mom.shape[1]

    def args(self) -> tuple:
        return self.cell, self.eta, self.eta_w, self.mom, self.inv_T


def pack_inputs(cells: CellArrays, species: SpeciesArrays,
                grid: MomentumGridDevice, T: float,
                d_eta: float) -> PolarizationOperands:
    """The rows of the JAX _cell_Q_polzn and _mom_polzn, prepared in f64 on
    the cells' device and cast once to f32."""
    c = cells
    it = 1.0 / c.tau
    zero = torch.zeros_like(c.tau)
    cols = {"qe0": c.ut, "qe1": -c.ux, "qe2": -c.uy, "qe3": -c.tau * c.un,
            "qd0": c.dat, "qd1": c.dax, "qd2": c.day, "qd3": c.dan * it,
            # S_t: + wyn px - wxn py + wxy pn
            "qt1": c.wyn, "qt2": -c.wxn, "qt3": c.wxy * it,
            # S_x: + wyn pt - wtn py + wty pn
            "qx0": c.wyn, "qx2": -c.wtn, "qx3": c.wty * it,
            # S_y: - wxn pt + wtn px - wtx pn
            "qy0": -c.wxn, "qy1": c.wtn, "qy3": -c.wtx * it,
            # S_n: + wxy pt - wty px + wtx py
            "qn0": c.wxy, "qn1": -c.wty, "qn2": c.wtx,
            "mask": c.pad_mask, "unused0": zero, "unused1": zero,
            "unused2": zero}
    cell = torch.stack([cols[k].to(f32) for k in CELL_COLS],
                       dim=1).contiguous()
    eta = torch.stack([torch.cosh(grid.eta), -torch.sinh(grid.eta)], dim=1)

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
        cell=cell, eta=eta.to(f32).contiguous(),
        eta_w=(grid.eta_weight * d_eta).to(f64).contiguous(), mom=mom,
        inv_T=1.0 / T, row_len=grid.cos_phi.shape[0])


def polarization_f32_plain(cell, eta, eta_w, mom, inv_T):
    """Plain torch version of the kernel: the same f32 arithmetic in the
    same order on (cell block, M) tensors (see the module docstring), the
    cells summed in f64; eta chunk by chunk, as the wrapper launches the
    kernel.  Runs on any device.  Returns (5, M) f64."""
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: _plain_chunk(cell, eta[e0:e1], eta_w[e0:e1], mom,
                                    inv_T))


def _plain_chunk(cell, eta, eta_w, mom, inv_T):
    C = cell.shape[0]
    M = mom.shape[1]
    mT, px, py, sgn, inv4m = mom
    invT = torch.tensor(inv_T, dtype=f32, device=mom.device)
    w32 = eta_w.to(f32)
    out = torch.zeros((N_SUMS, M), dtype=f64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = {name: cell[c0:c0 + blk, i:i + 1]
             for i, name in enumerate(CELL_COLS)}
        # once per (cell, phi): the px/py parts, independent of eta
        exy = q["qe1"] * px + q["qe2"] * py
        dxy = q["qd1"] * px + q["qd2"] * py
        txy = q["qt1"] * px + q["qt2"] * py
        xy = q["qx2"] * py
        yx = q["qy1"] * px
        nxy = q["qn1"] * px + q["qn2"] * py
        part = torch.zeros((N_SUMS, q["qe0"].shape[0], M), dtype=f32,
                           device=mom.device)
        for e in range(eta.shape[0]):
            # once per (cell, eta, row)
            m1 = mT * eta[e, 0]
            m4 = mT * eta[e, 1]
            e_m = q["qe0"] * m1 + q["qe3"] * m4
            d_m = q["qd0"] * m1 + q["qd3"] * m4
            t_m = q["qt3"] * m4
            x_m = q["qx0"] * m1 + q["qx3"] * m4
            y_m = q["qy0"] * m1 + q["qy3"] * m4
            n_m = q["qn0"] * m1
            # per evaluation
            E = e_m + exy
            f0 = 1.0 / torch.clamp(torch.exp(E * invT) + sgn, max=MAX_DEN)
            w = (d_m + dxy) * f0
            g = -w * (1.0 - sgn * f0) * inv4m
            for k, v in enumerate((g * (t_m + txy), g * (x_m + xy),
                                   g * (y_m + yx), g * (n_m + nxy), w)):
                part[k] += w32[e] * v
        out += (q["mask"] * part).to(f64).sum(dim=1)
    return out


def _check(cell, eta, eta_w, mom) -> None:
    C = cell.shape[0]
    Ne = eta.shape[0]
    want = {"cell": (cell, f32, (C, len(CELL_COLS))),
            "eta": (eta, f32, (Ne, 2)),
            "eta_w": (eta_w, f64, (Ne,)),
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
    return operand_geometry(mom, _ROW_KEYS, n_cells, r, TILE_CELLS, row_len)


def launch(cell, eta, eta_w, mom, inv_T: float, g: Geometry) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands of at most ETA_CHUNK eta
    nodes with the geometry ``g``."""
    from . import _build
    fn = _build.load("polarization_f32").is3d2_polarization_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty((N_SUMS, M), dtype=f64, device=cell.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, N_SUMS, M), dtype=f64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), eta.data_ptr(), eta_w.data_ptr(),
                 mom.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 cell.shape[0], eta.shape[0], M, g.row_len, g.n_split,
                 g.cells_per_split, inv_T, stream)
    if err != 0:
        raise RuntimeError(f"polarization_f32 launch failed: cudaError {err}")
    polarization_f32.launches += 1
    polarization_f32.last_geometry = g
    return out


def polarization_f32(cell, eta, eta_w, mom, inv_T: float,
                     row_len: int | None = None) -> torch.Tensor:
    """Run kernel P1 on CUDA tensors (its plain version on CPU tensors).
    Returns the (5, M) f64 sums.  ``row_len``: the phi count of the
    momentum grid, see ``geometry``."""
    _check(cell, eta, eta_w, mom)
    if cell.device.type == "cpu":
        return polarization_f32_plain(cell, eta, eta_w, mom, inv_T)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    r = _build.load("polarization_f32").is3d2_polarization_f32_tile()
    g = geometry(mom, cell.shape[0], r, row_len)
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: launch(cell, eta[e0:e1], eta_w[e0:e1], mom, inv_T, g))


polarization_f32.launches = 0
polarization_f32.last_geometry = None   # of the latest launch


def compute_polarization_kernel(cells: CellArrays, species: SpeciesArrays,
                                grid: MomentumGridDevice, T: float,
                                d_eta: float) -> torch.Tensor:
    """The f32/f32c route: (5, S, NpT, Nphi, 1) f64 raw sums through P1,
    the layout of the f64 engine."""
    ops = pack_inputs(cells, species, grid, T, d_eta)
    out = polarization_f32(*ops.args(), row_len=ops.row_len)
    return out.reshape(N_SUMS, species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)
