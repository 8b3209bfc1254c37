"""Compensated-argument Cooper-Frye spectra kernel (df 1/2, 2+1d).

The port of is3d2_tpu/ops/cooper_frye_pallas.py::_kernel_comp: the CUDA C++
kernel csrc/cooper_frye_comp.cu (built for sm_90a by ops/_build.py, bound
with ctypes), and its plain torch version with the same f32c arithmetic.

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

import torch

from ..config import Config
from .launch_geometry import (Geometry, df12_flags, has_diffusion,
                              operand_geometry, over_eta_chunks)

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
    C = cell.shape[0]
    M = mom.shape[1]
    p = dict(zip(MOM_ROWS, mom))
    b, sgn, mass2, mTf, pxf, pyf = (p["b"], p["sgn"], p["mass2"], p["mTf"],
                                    p["pxf"], p["pyf"])
    shear = bool(cfg.include_shear_deltaf)
    diffusion = has_diffusion(cfg)
    df2 = cfg.df_mode == 2
    w32 = eta_w.to(torch.float32)
    out = torch.zeros(M, dtype=torch.float64, device=mom.device)
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
        out += part.to(torch.float64).sum(dim=0)
    return out


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
