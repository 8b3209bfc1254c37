"""Compensated-argument Cooper-Frye spectra kernel (df 1/2, 2+1d).

The port of is3d2_tpu/ops/cooper_frye_pallas.py::_kernel_comp: the CUDA C++
kernel csrc/cooper_frye_comp.cu (built for sm_90a by ops/_build.py, bound
with ctypes), and its plain torch version with the same f32c arithmetic.

``cooper_frye_comp`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; ``cooper_frye_comp.launches`` counts kernel
launches.

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

CELL_COLS = ("qx1", "qx2", "qy1", "qy2", "abf", "abl", "Tf",
             "shear", "bulk0", "bulk1", "bulk2", "diff0", "diff1",
             "qd0", "qd1", "qd2", "qd3", "qv0", "qv1", "qv2", "qv3",
             *(f"qpi{k}" for k in range(10)), "unused")
MOM_ROWS = ("mT1", "mT2", "mTf", "px1", "px2", "pxf", "py1", "py2", "pyf",
            "mass2", "b", "sgn")
MAX_ETA = 32   # kMaxEta in the CUDA source

# flag bits of the CUDA launcher
_SHEAR, _DIFFUSION, _REGULATE, _OUTFLOW, _DF2 = 1, 2, 4, 8, 16

# elements of one (cells x M) f32 block of the plain version
_PLAIN_BLOCK_ELEMENTS = 1 << 24


def _diffusion(cfg: Config) -> bool:
    return bool(cfg.include_baryon and cfg.include_baryondiff_deltaf)


def _flags(cfg: Config) -> int:
    return ((_SHEAR if cfg.include_shear_deltaf else 0)
            | (_DIFFUSION if _diffusion(cfg) else 0)
            | (_REGULATE if cfg.regulate_deltaf else 0)
            | (_OUTFLOW if cfg.outflow else 0)
            | (_DF2 if cfg.df_mode == 2 else 0))


def _two_sum(x, y):
    s = x + y
    b = s - x
    return s, (x - (s - b)) + (y - b)


def cooper_frye_comp_plain(cell, qm, eta, eta_w, mom, cfg: Config):
    """Plain torch version of the kernel: the same f32 arithmetic on
    (cell block, M) tensors, summed in f64.  Runs on any device."""
    C = cell.shape[0]
    M = mom.shape[1]
    p = dict(zip(MOM_ROWS, mom))
    b, sgn, mass2, mTf, pxf, pyf = (p["b"], p["sgn"], p["mass2"], p["mTf"],
                                    p["pxf"], p["pyf"])
    diffusion = _diffusion(cfg)
    out = torch.zeros(M, dtype=torch.float64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = {name: cell[c0:c0 + blk, i:i + 1]
             for i, name in enumerate(CELL_COLS)}
        qm_b = qm[c0:c0 + blk]
        t2 = q["qx1"] * p["px1"]
        t3 = q["qy1"] * p["py1"]
        t4 = -(q["abf"] * b)
        s_a, e_a = _two_sum(t2, t3)
        s_b, e_b = _two_sum(s_a, t4)
        err0 = e_a + e_b
        d0 = (q["qx1"] * p["px2"] + q["qx2"] * pxf + q["qy1"] * p["py2"]
              + q["qy2"] * pyf - q["abl"] * b)
        for e in range(eta.shape[0]):
            qm1 = qm_b[:, e, 0:1]
            qm2 = qm_b[:, e, 1:2]
            t1 = qm1 * p["mT1"]
            d = qm1 * p["mT2"] + qm2 * mTf + d0
            s, e1 = _two_sum(t1, s_b)
            A, r = _two_sum(s, d + (err0 + e1))
            feq = 1.0 / (torch.exp(A) * (1.0 + r) + sgn)
            feqbar = 1.0 - sgn * feq
            # u.p/T = A - t4 + abl b (+ r): the low part of alphaB b must
            # come back, or E is off by T abl ~ 1e-4 GeV for baryons
            E = ((A - t4) + q["abl"] * b) * q["Tf"]

            m1 = mTf * eta[e, 0]
            m4 = mTf * eta[e, 1]
            pdd = q["qd0"] * m1 + q["qd1"] * pxf + q["qd2"] * pyf + q["qd3"] * m4
            if cfg.include_shear_deltaf:
                pp = (m1 * m1, pxf * pxf, pyf * pyf, m4 * m4, m1 * pxf,
                      m1 * pyf, m1 * m4, pxf * pyf, pxf * m4, pyf * m4)
                pim = q["qpi0"] * pp[0]
                for k in range(1, 10):
                    pim = pim + q[f"qpi{k}"] * pp[k]
            else:
                pim = 0.0
            if cfg.df_mode == 1:
                df = (q["shear"] * pim + q["bulk0"] * mass2
                      + (q["bulk1"] * b + q["bulk2"] * E) * E)
            else:
                df = (q["shear"] * pim / E + q["bulk0"] * E + q["bulk1"] * b
                      + q["bulk2"] * (E - mass2 / E))
            if diffusion:
                Vp = q["qv0"] * m1 + q["qv1"] * pxf + q["qv2"] * pyf + q["qv3"] * m4
                if cfg.df_mode == 1:
                    df = df + (q["diff0"] * b + q["diff1"] * E) * Vp
                else:
                    df = df + (q["diff0"] - q["diff1"] * b / E) * Vp
            df = feqbar * df
            if cfg.regulate_deltaf:
                df = torch.clamp(df, -1.0, 1.0)
            if cfg.outflow:
                pdd = torch.where(pdd > 0.0, pdd, 0.0)
            value = pdd * (feq * (1.0 + df))
            out += eta_w[e] * value.to(torch.float64).sum(dim=0)
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
    if not 1 <= Ne <= MAX_ETA:
        raise ValueError(f"the kernel takes 1..{MAX_ETA} eta nodes, got {Ne}")
    if mom.shape[1] < 1 or mom.shape[1] >= 2**31 or C >= 2**31:
        raise ValueError("momentum and cell counts must fit in int32")


def cooper_frye_comp(cell, qm, eta, eta_w, mom, cfg: Config) -> torch.Tensor:
    """Run the compensated kernel on CUDA tensors (its plain version on CPU
    tensors).  Returns the (M,) f64 spectra partials."""
    _check(cell, qm, eta, eta_w, mom)
    if cell.device.type == "cpu":
        return cooper_frye_comp_plain(cell, qm, eta, eta_w, mom, cfg)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    fn = _build.load("cooper_frye_comp").is3d2_cooper_frye_comp
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty(M, dtype=torch.float64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), qm.data_ptr(), eta.data_ptr(),
                 eta_w.data_ptr(), mom.data_ptr(), out.data_ptr(),
                 cell.shape[0], eta.shape[0], M, _flags(cfg), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_comp launch failed: cudaError {err}")
    cooper_frye_comp.launches += 1
    return out


cooper_frye_comp.launches = 0
