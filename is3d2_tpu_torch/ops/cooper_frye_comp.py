"""Compensated-argument Cooper-Frye spectra kernel (df 1/2), 2+1d and
3+1d modes.

The port of is3d2_tpu/ops/cooper_frye_pallas.py::_kernel_comp (2+1d) and
of the JAX package's XLA programs _block_fast_3d_comp / _block_fast_3d
(is3d2_tpu/core/spectra_fast.py:461-582, 3+1d; no Pallas kernel there):
the CUDA C++ kernels of csrc/cooper_frye_comp.cu (built for sm_90a by
ops/_build.py, bound with ctypes), and their plain torch versions with the
same f32c arithmetic.  The 3+1d mode is ``cooper_frye_comp_3d``, operation
0's per-cell mode ``cooper_frye_comp_cells`` (below).

``cooper_frye_comp`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; ``cooper_frye_comp.launches`` counts kernel
launches and ``cooper_frye_comp.last_geometry`` holds the latest launch's
geometry.  The launch geometry (register tile, cell split) comes from the
operands' shapes alone (``geometry``, ops/launch_geometry.py).  A launch
takes at most ETA_CHUNK eta nodes: a longer table runs chunk by chunk, one
launch each, and the chunks' results are added in order; the plain version
chunks alike.

Operand layout (all contiguous; written by
ops/spectra_fast_common.py::pack_inputs_comp):

  cell  (C, 32) f32    columns CELL_COLS (the last one unused, zero)
  qm    (C, Ne, 2) f32 12-bit split (qm1, qm2) of the mT coefficient of u.p/T
                       at each eta node: (ut cosh eta + tau un sinh eta) / T
  eta   (Ne, 2) f32    cosh(eta), -sinh(eta)
  eta_w (Ne,) f64      quadrature weights
  mom   (12, M) f32    rows MOM_ROWS, m = (species, pT, phi)

and the result is the (M,) f64 sum over cells and eta of w * p.dsigma * f.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..config import Config
from .launch_geometry import (H100_SMS, CellsGeometry, Geometry, Geometry3d,
                              df12_flags, has_diffusion, launch_geometry_3d,
                              launch_geometry_cells, operand_geometry,
                              over_eta_chunks, row_length)

CELL_COLS = ("qx1", "qx2", "qy1", "qy2", "abf", "abl", "Tf",
             "shear", "bulk0", "bulk1", "bulk2", "diff0", "diff1",
             "qd0", "qd1", "qd2", "qd3", "qv0", "qv1", "qv2", "qv3",
             *(f"qpi{k}" for k in range(10)), "unused")
MOM_ROWS = ("mT1", "mT2", "mTf", "px1", "px2", "pxf", "py1", "py2", "pyf",
            "mass2", "b", "sgn")
ETA_CHUNK = 32   # kMaxEta in the CUDA source: the eta nodes of one launch
TILE_CELLS = 64   # kTileCells
MAX_DEN = 2.0 ** 126   # kMaxDen: exp overflows past it, 1 / x flushes to 0
R = 4          # kR: momenta (consecutive phi) of one thread's register tile
# the rows constant along a (species, pT) row of the momentum grid
_ROW_KEYS = [MOM_ROWS.index(k)
             for k in ("mT1", "mT2", "mTf", "mass2", "b", "sgn")]

# elements of one (cells x M) f32 block of the plain version
_PLAIN_BLOCK_ELEMENTS = 1 << 24


def _two_sum(x, y):
    s = x + y
    b = s - x
    return s, (x - (s - b)) + (y - b)


def cooper_frye_comp_plain(cell, qm, eta, eta_w, mom, cfg: Config):
    """Plain torch version of the kernel: the same f32 arithmetic in the
    same order on (cell block, M) tensors -- the pieces that depend on (cell,
    eta, species, pT) or on (cell, phi) only formed apart, the pi
    coefficients scaled by the shear coefficient, df 2 through one
    reciprocal of E, the eta terms of a cell summed in f32 with f32 weights
    -- and the cells summed in f64; eta chunk by chunk, as the wrapper
    launches the kernel.  Runs on any device."""
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: _plain_chunk(cell, qm[:, e0:e1], eta[e0:e1],
                                    eta_w[e0:e1], mom, cfg))


def _plain_chunk(cell, qm, eta, eta_w, mom, cfg: Config):
    out = torch.zeros(mom.shape[1], dtype=torch.float64, device=mom.device)
    for part in plain_parts(cell, qm, eta, eta_w, mom, cfg):
        out += part.to(torch.float64).sum(dim=0)
    return out


def plain_parts(cell, qm, eta, eta_w, mom, cfg: Config):
    """The (cell block, M) f32 eta sums of the kernel's evaluation, cell
    block by cell block in order."""
    C = cell.shape[0]
    M = mom.shape[1]
    p = dict(zip(MOM_ROWS, mom))
    b, sgn, mass2, mTf, pxf, pyf = (p["b"], p["sgn"], p["mass2"], p["mTf"],
                                    p["pxf"], p["pyf"])
    shear = bool(cfg.include_shear_deltaf)
    diffusion = has_diffusion(cfg)
    df2 = cfg.df_mode == 2
    w32 = eta_w.to(torch.float32)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = {name: cell[c0:c0 + blk, i:i + 1]
             for i, name in enumerate(CELL_COLS)}
        qm_b = qm[c0:c0 + blk]
        # once per (cell, row)
        t4 = -(q["abf"] * b)
        ablb = q["abl"] * b
        # u.p/T = A - t4 + abl b (+ r): the low part of alphaB b must come
        # back, or E is off by T abl ~ 1e-4 GeV for baryons
        cE = ablb - t4
        c1 = q["bulk1"] * b
        c0b = 0.0 if df2 else q["bulk0"] * mass2
        diffb = (q["diff1"] if df2 else q["diff0"]) * b
        sk = [q["shear"] * q[f"qpi{k}"] for k in range(10)]
        # once per (cell, phi)
        t2 = q["qx1"] * p["px1"]
        t3 = q["qy1"] * p["py1"]
        s_a, e_a = _two_sum(t2, t3)
        s_b, e_b = _two_sum(s_a, t4)
        d0e = (q["qx1"] * p["px2"] + q["qx2"] * pxf + q["qy1"] * p["py2"]
               + q["qy2"] * pyf - ablb) + (e_a + e_b)
        pddxy = q["qd1"] * pxf + q["qd2"] * pyf
        if shear:
            sp0 = (sk[1] * (pxf * pxf) + sk[2] * (pyf * pyf)
                   + sk[7] * (pxf * pyf) + c0b)
            sp1 = sk[4] * pxf + sk[5] * pyf
            sp4 = sk[8] * pxf + sk[9] * pyf
        else:
            sp0 = c0b
        if diffusion:
            vpxy = q["qv1"] * pxf + q["qv2"] * pyf
        part = torch.zeros((qm_b.shape[0], M), dtype=torch.float32,
                           device=mom.device)
        for e in range(eta.shape[0]):
            # once per (cell, eta, row)
            qm1 = qm_b[:, e, 0:1]
            qm2 = qm_b[:, e, 1:2]
            t1 = qm1 * p["mT1"]
            dm = qm1 * p["mT2"] + qm2 * mTf
            m1 = mTf * eta[e, 0]
            m4 = mTf * eta[e, 1]
            pdd = (q["qd0"] * m1 + q["qd3"] * m4) + pddxy
            # per evaluation
            s, e1 = _two_sum(t1, s_b)
            A, r = _two_sum(s, dm + (d0e + e1))
            feq = 1.0 / torch.clamp(torch.exp(A) * (1.0 + r) + sgn, max=MAX_DEN)
            feqbar = 1.0 - sgn * feq
            E = (A + cE) * q["Tf"]
            if shear:
                sp = ((m1 * (sk[0] * m1 + sk[6] * m4) + sk[3] * (m4 * m4))
                      + sp0) + m1 * sp1 + m4 * sp4
            else:
                sp = sp0
            if diffusion:
                Vp = (q["qv0"] * m1 + q["qv3"] * m4) + vpxy
            if not df2:
                df = sp + (c1 + q["bulk2"] * E) * E
                if diffusion:
                    df = df + (diffb + q["diff1"] * E) * Vp
            else:
                rE = 1.0 / E
                df = (sp * rE + (q["bulk0"] * E + c1)
                      + q["bulk2"] * (E - mass2 * rE))
                if diffusion:
                    df = df + (q["diff0"] - diffb * rE) * Vp
            df = feqbar * df
            if cfg.regulate_deltaf:
                df = torch.clamp(df, -1.0, 1.0)
            if cfg.outflow:
                pdd = torch.where(pdd > 0.0, pdd, 0.0)
            part = part + w32[e] * (pdd * (feq * (1.0 + df)))
        yield part


def _check(cell, qm, eta, eta_w, mom) -> None:
    C = cell.shape[0]
    Ne = eta.shape[0]
    want = {"cell": (cell, torch.float32, (C, len(CELL_COLS))),
            "qm": (qm, torch.float32, (C, Ne, 2)),
            "eta": (eta, torch.float32, (Ne, 2)),
            "eta_w": (eta_w, torch.float64, (Ne,)),
            "mom": (mom, torch.float32, (len(MOM_ROWS), mom.shape[1]))}
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
    if mom.shape[1] < 1 or mom.shape[1] >= 2**31 or C >= 2**31:
        raise ValueError("momentum and cell counts must fit in int32")


def geometry(mom: torch.Tensor, n_cells: int, r: int = R,
             row_len: int | None = None) -> Geometry:
    """The launch geometry for these operands; ``row_len``, the phi count of
    the momentum grid, is read off the rows mT, mass2, b and sign where the
    caller leaves it out (ops/launch_geometry.py::operand_geometry)."""
    return operand_geometry(mom, _ROW_KEYS, n_cells, r, TILE_CELLS, row_len)


def launch(cell, qm, eta, eta_w, mom, cfg: Config, g: Geometry) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands of at most ETA_CHUNK eta
    nodes with the geometry ``g``."""
    from . import _build
    fn = _build.load("cooper_frye_comp").is3d2_cooper_frye_comp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty(M, dtype=torch.float64, device=cell.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, M), dtype=torch.float64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), qm.data_ptr(), eta.data_ptr(),
                 eta_w.data_ptr(), mom.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), cell.shape[0], eta.shape[0], M, g.row_len,
                 g.n_split, g.cells_per_split, df12_flags(cfg), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_comp launch failed: cudaError {err}")
    cooper_frye_comp.launches += 1
    cooper_frye_comp.last_geometry = g
    return out


def cooper_frye_comp(cell, qm, eta, eta_w, mom, cfg: Config,
                     row_len: int | None = None) -> torch.Tensor:
    """Run the compensated kernel on CUDA tensors (its plain version on CPU
    tensors).  Returns the (M,) f64 spectra partials.  ``row_len``: the phi
    count of the momentum grid, see ``geometry``."""
    _check(cell, qm, eta, eta_w, mom)
    if cell.device.type == "cpu":
        return cooper_frye_comp_plain(cell, qm, eta, eta_w, mom, cfg)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    r = _build.load("cooper_frye_comp").is3d2_cooper_frye_comp_tile()
    g = geometry(mom, cell.shape[0], r, row_len)
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: launch(cell, qm[:, e0:e1].contiguous(), eta[e0:e1],
                              eta_w[e0:e1], mom, cfg, g))


cooper_frye_comp.launches = 0
cooper_frye_comp.last_geometry = None   # of the latest launch


# ----------------------------------------------------------------------
# operation 0's per-cell mode
# ----------------------------------------------------------------------
#
# Op 1's operands (as above, any rows of cells) and the (pT, phi) weights
#
#   w     (P,) f64   w_pT w_phi of one species' P momenta (pT, phi)
#
# give each cell's dN/dy per species, the (C, S) f64 sums
# sum_m w[m] sum_eta w_eta (p.dsigma) f over a species' momenta, S = M / P.

@dataclasses.dataclass(frozen=True)
class CellsTile:
    """Threads a block and blocks an SM (its __launch_bounds__) of the
    per-cell mode."""

    threads: int
    blocks_per_sm: int

    @classmethod
    def of(cls, lib) -> "CellsTile":
        """The shape a built library launches (its extern "C" getters)."""
        return cls(lib.is3d2_cooper_frye_comp_cells_threads(),
                   lib.is3d2_cooper_frye_comp_cells_blocks_per_sm())


# kThreadsC, kMinBlocksC of csrc/cooper_frye_comp.cu: the geometry of a
# tensor that lies off the card
TILE_CELLS_MODE = CellsTile(threads=128, blocks_per_sm=4)


def cooper_frye_comp_cells_plain(cell, qm, eta, eta_w, mom, w, cfg: Config):
    """Plain torch version of the per-cell mode: the kernel's f32 eta sums
    (``plain_parts``, the arithmetic of the op-1 plain version) contracted
    with the f64 weights in f64, cell block by cell block; eta chunk by
    chunk, as the wrapper launches.  (C, S) f64; runs on any device."""
    S = mom.shape[1] // w.shape[0]

    def chunk(e0, e1):
        parts = [part.to(torch.float64).reshape(part.shape[0], S, -1) @ w
                 for part in plain_parts(cell, qm[:, e0:e1], eta[e0:e1],
                                          eta_w[e0:e1], mom, cfg)]
        return torch.cat(parts) if parts else torch.zeros(
            (0, S), dtype=torch.float64, device=mom.device)
    return over_eta_chunks(eta.shape[0], ETA_CHUNK, chunk)


def _check_cells(mom, w) -> None:
    if w.device != mom.device:
        raise ValueError(f"w is on {w.device}, mom on {mom.device}")
    if w.dtype != torch.float64 or w.dim() != 1 or not w.is_contiguous():
        raise ValueError(f"w: expected contiguous float64 (P,), got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.shape[0] < 1 or mom.shape[1] % w.shape[0]:
        raise ValueError(f"{mom.shape[1]} momenta are no whole number of "
                         f"species of {w.shape[0]}")


def geometry_cells(mom: torch.Tensor, n_cells: int, per_species: int,
                   tile: CellsTile = TILE_CELLS_MODE,
                   row_len: int | None = None) -> CellsGeometry:
    """The per-cell mode's launch geometry; ``row_len`` as in
    ``geometry`` (read off the rows, a divisor of ``per_species``, where
    the caller leaves it out)."""
    if row_len is None:
        row_len = row_length(mom[_ROW_KEYS], per_species)
    sms = (torch.cuda.get_device_properties(mom.device).multi_processor_count
           if mom.device.type == "cuda" else H100_SMS)
    return launch_geometry_cells(mom.shape[1], per_species, row_len, n_cells,
                                 TILE_CELLS, tile.blocks_per_sm, sms)


def launch_cells(cell, qm, eta, eta_w, mom, w, cfg: Config, g: CellsGeometry,
                 lib=None) -> torch.Tensor:
    """Launch the per-cell mode of ``lib`` (default: this package's build)
    on checked CUDA operands of at most ETA_CHUNK eta nodes with the
    geometry ``g``: (C, S) f64, a view of the kernel's (S, C) result."""
    if lib is None:
        from . import _build
        lib = _build.load("cooper_frye_comp")
    fn = lib.is3d2_cooper_frye_comp_cells
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    C = cell.shape[0]
    out = torch.empty((g.n_species, C), dtype=torch.float64,
                      device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), qm.data_ptr(), eta.data_ptr(),
                 eta_w.data_ptr(), mom.data_ptr(), w.data_ptr(),
                 out.data_ptr(), C, eta.shape[0], mom.shape[1], g.row_len,
                 g.per_species, g.n_split, g.cells_per_split,
                 df12_flags(cfg), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_comp_cells launch failed: "
                           f"cudaError {err}")
    cooper_frye_comp_cells.launches += 1
    cooper_frye_comp_cells.last_geometry = g
    return out.T


def cooper_frye_comp_cells(cell, qm, eta, eta_w, mom, w, cfg: Config,
                           row_len: int | None = None) -> torch.Tensor:
    """Run the per-cell mode on CUDA tensors (its plain version on CPU
    tensors): each cell's dN/dy per species before PREFACTOR and the
    degeneracy, (C, S) f64.  ``row_len``: the phi count of the momentum
    grid, see ``geometry_cells``."""
    _check(cell, qm, eta, eta_w, mom)
    _check_cells(mom, w)
    if cell.device.type == "cpu":
        return cooper_frye_comp_cells_plain(cell, qm, eta, eta_w, mom, w, cfg)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    lib = _build.load("cooper_frye_comp")
    g = geometry_cells(mom, cell.shape[0], w.shape[0], CellsTile.of(lib),
                       row_len)
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: launch_cells(cell, qm[:, e0:e1].contiguous(),
                                    eta[e0:e1], eta_w[e0:e1], mom, w, cfg, g,
                                    lib))


cooper_frye_comp_cells.launches = 0
cooper_frye_comp_cells.last_geometry = None   # of the latest launch


# ----------------------------------------------------------------------
# the 3+1d mode
# ----------------------------------------------------------------------
#
# Operand layout (contiguous; written by
# ops/spectra_fast_common.py::pack_inputs_comp_3d from the light-cone rows
# of core/spectra_fast.py):
#
#   cell  (C, 36) f32   columns CELL_COLS_3D of the live cells only (the
#                       last two unused, zero): the 12-bit splits of the
#                       u.p / T coefficients of m+, px, py, m-, of alphaB,
#                       T, the delta-f coefficients, p.dsigma and V.p
#                       against (m+, px, py, m-), and the shear
#                       coefficient times the ten pi:pp coefficients
#   mom   (15, M) f32   rows MOM_ROWS_3D, m = (species, pT, y, phi)
#
# and the result is the (M,) f64 sum over the cells of p.dsigma * f.  No
# eta loop: the cell's eta lives in its light-cone rows.

CELL_COLS_3D = ("qp1", "qp2", "qx1", "qx2", "qy1", "qy2", "qm1", "qm2",
                "abf", "abl", "Tf", "bulk0", "bulk1", "bulk2", "diff0",
                "diff1", "qd0", "qd1", "qd2", "qd3", "qv0", "qv1", "qv2",
                "qv3", *(f"spi{k}" for k in range(10)), "unused0", "unused1")
MOM_ROWS_3D = ("mp1", "mp2", "mpf", "mm1", "mm2", "mmf", "mass2", "b", "sgn",
               "px1", "px2", "pxf", "py1", "py2", "pyf")
TILE_CELLS_3D = 64   # kTileCells3


@dataclasses.dataclass(frozen=True)
class Tile3d:
    """The 3+1d mode's register tile and launch: ``r`` phi x ``ty`` y
    momenta a thread, ``threads`` a block, ``blocks_per_sm`` resident (its
    __launch_bounds__)."""

    r: int
    ty: int
    threads: int
    blocks_per_sm: int

    @classmethod
    def of(cls, lib, name: str = "cooper_frye_comp_3d") -> "Tile3d":
        """The tile a built library launches (the extern "C" getters of
        its 3+1d mode ``name``)."""
        return cls(*(getattr(lib, f"is3d2_{name}_{what}")()
                     for what in ("tile", "tile_y", "threads",
                                  "blocks_per_sm")))


# kP3, kY3, kThreads3, kMinBlocks3 of csrc/cooper_frye_comp.cu: the geometry
# of a tensor that lies off the card
TILE_3D = Tile3d(r=4, ty=7, threads=128, blocks_per_sm=3)
# the rows constant along a (species, pT, y) row of the momentum grid
_ROW_KEYS_3D = list(range(9))


def cooper_frye_comp_3d_plain(cell, mom, cfg: Config):
    """Plain torch version of the 3+1d mode: the kernel's f32 arithmetic
    in its order on (cell block, M) tensors -- the pieces of (cell, species,
    pT, y) formed apart from those of (cell, phi), the exact products
    TwoSum-chained as (q+ m+, q- m-, -abf b) per row and (qx px, qy py) per
    phi, df 2 through one reciprocal of E -- and every cell's term summed
    in f64.  Runs on any device."""
    C, M = cell.shape[0], mom.shape[1]
    p = dict(zip(MOM_ROWS_3D, mom))
    b, sgn, mass2 = p["b"], p["sgn"], p["mass2"]
    mpf, mmf, pxf, pyf = p["mpf"], p["mmf"], p["pxf"], p["pyf"]
    shear = bool(cfg.include_shear_deltaf)
    diffusion = has_diffusion(cfg)
    df2 = cfg.df_mode == 2
    out = torch.zeros(M, dtype=torch.float64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = {name: cell[c0:c0 + blk, i:i + 1]
             for i, name in enumerate(CELL_COLS_3D)}
        # once per (cell, row)
        t1 = q["qp1"] * p["mp1"]
        t4 = q["qm1"] * p["mm1"]
        t5 = -(q["abf"] * b)
        s_r, e_r = _two_sum(t1, t4)
        s_m, e_m = _two_sum(s_r, t5)
        ablb = q["abl"] * b
        # u.p/T = A - t5 + abl b (+ r): the low part of alphaB b comes back
        # (the JAX package's _block_fast_3d_comp drops it, ROADMAP C3)
        cE = ablb - t5
        d_m = (q["qp1"] * p["mp2"] + q["qp2"] * mpf + q["qm1"] * p["mm2"]
               + q["qm2"] * mmf - ablb) + (e_r + e_m)
        c1 = q["bulk1"] * b
        c0b = 0.0 if df2 else q["bulk0"] * mass2
        diffb = (q["diff1"] if df2 else q["diff0"]) * b
        pdd_m = q["qd0"] * mpf + q["qd3"] * mmf
        if shear:
            sk = [q[f"spi{k}"] for k in range(10)]
            sp_m = (mpf * (sk[0] * mpf + sk[6] * mmf) + sk[3] * (mmf * mmf)
                    + c0b)
            cx = sk[4] * mpf + sk[8] * mmf
            cy = sk[5] * mpf + sk[9] * mmf
        else:
            sp_m = c0b
        if diffusion:
            vp_m = q["qv0"] * mpf + q["qv3"] * mmf
        # per evaluation
        t2 = q["qx1"] * p["px1"]
        t3 = q["qy1"] * p["py1"]
        s_a, e_a = _two_sum(t2, t3)
        s, e_b = _two_sum(s_m, s_a)
        dxy = (q["qx1"] * p["px2"] + q["qx2"] * pxf + q["qy1"] * p["py2"]
               + q["qy2"] * pyf)
        A, r = _two_sum(s, d_m + (dxy + (e_a + e_b)))
        feq = 1.0 / torch.clamp(torch.exp(A) * (1.0 + r) + sgn, max=MAX_DEN)
        feqbar = 1.0 - sgn * feq
        E = (A + cE) * q["Tf"]
        pdd = pdd_m + (q["qd1"] * pxf + q["qd2"] * pyf)
        if shear:
            sp = sp_m + (pxf * (sk[1] * pxf + sk[7] * pyf + cx)
                         + pyf * (sk[2] * pyf + cy))
        else:
            sp = sp_m
        if diffusion:
            Vp = vp_m + (q["qv1"] * pxf + q["qv2"] * pyf)
        if not df2:
            df = sp + (c1 + q["bulk2"] * E) * E
            if diffusion:
                df = df + (diffb + q["diff1"] * E) * Vp
        else:
            rE = 1.0 / E
            df = (sp * rE + (q["bulk0"] * E + c1)
                  + q["bulk2"] * (E - mass2 * rE))
            if diffusion:
                df = df + (q["diff0"] - diffb * rE) * Vp
        df = feqbar * df
        if cfg.regulate_deltaf:
            df = torch.clamp(df, -1.0, 1.0)
        if cfg.outflow:
            pdd = torch.where(pdd > 0.0, pdd, 0.0)
        value = pdd * (feq * (1.0 + df))
        out += value.to(torch.float64).sum(dim=0)
    return out


def _check_3d(cell, mom) -> None:
    want = {"cell": (cell, (cell.shape[0], len(CELL_COLS_3D))),
            "mom": (mom, (len(MOM_ROWS_3D), mom.shape[-1]))}
    for name, (t, shape) in want.items():
        if t.device != cell.device:
            raise ValueError(f"{name} is on {t.device}, cell on {cell.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mom.shape[1] < 1 or mom.shape[1] >= 2**31 or cell.shape[0] >= 2**31:
        raise ValueError("momentum and cell counts must fit in int32")


def geometry_3d(mom: torch.Tensor, n_cells: int, n_y: int,
                tile: Tile3d = TILE_3D,
                row_len: int | None = None) -> Geometry3d:
    """The launch geometry of the 3+1d mode: its momenta run (species, pT,
    y, phi), ``n_y`` rows of ``row_len`` phi a (species, pT) group.
    ``row_len``, the phi count of the grid, is read off the rows m+, m-,
    mass2, b and sign where the caller leaves it out; ``n_y`` cannot be
    (pi+ and pi- rows of equal keys may merge), so the caller names it."""
    if row_len is None:
        row_len = row_length(mom[_ROW_KEYS_3D])
    sms = (torch.cuda.get_device_properties(mom.device).multi_processor_count
           if mom.device.type == "cuda" else H100_SMS)
    return launch_geometry_3d(mom.shape[1], row_len, n_y, n_cells, tile.r,
                              tile.ty, TILE_CELLS_3D, tile.threads,
                              tile.blocks_per_sm, sms)


def launch_3d(cell, mom, cfg: Config, g: Geometry3d, lib=None) -> torch.Tensor:
    """Launch the 3+1d mode of ``lib`` (default: this package's build) on
    checked CUDA operands with the geometry ``g``."""
    if lib is None:
        from . import _build
        lib = _build.load("cooper_frye_comp")
    fn = lib.is3d2_cooper_frye_comp_3d
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty(M, dtype=torch.float64, device=cell.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, M), dtype=torch.float64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), mom.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), cell.shape[0], M, g.row_len, g.n_y,
                 g.n_split, g.cells_per_split, df12_flags(cfg), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_comp_3d launch failed: cudaError "
                           f"{err}")
    cooper_frye_comp_3d.launches += 1
    cooper_frye_comp_3d.last_geometry = g
    return out


def cooper_frye_comp_3d(cell, mom, cfg: Config, row_len: int | None = None,
                        n_y: int | None = None) -> torch.Tensor:
    """Run the 3+1d mode on CUDA tensors (its plain version on CPU
    tensors).  Returns the (M,) f64 sums.  ``n_y``: the rapidities of the
    momentum grid, which the caller must name; ``row_len``: its phi count,
    see ``geometry_3d``."""
    if n_y is None or n_y < 1:
        raise ValueError("cooper_frye_comp_3d needs n_y, the rapidity count "
                         "of the momentum grid")
    _check_3d(cell, mom)
    if cell.device.type == "cpu":
        return cooper_frye_comp_3d_plain(cell, mom, cfg)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    lib = _build.load("cooper_frye_comp")
    g = geometry_3d(mom, cell.shape[0], n_y, Tile3d.of(lib), row_len)
    return launch_3d(cell, mom, cfg, g, lib)


cooper_frye_comp_3d.launches = 0
cooper_frye_comp_3d.last_geometry = None   # of the latest launch
