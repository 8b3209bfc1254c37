"""Plain-f32 Cooper-Frye spectra kernel (df 1/2, 2+1d).

The port of is3d2_tpu/ops/cooper_frye_pallas.py::_kernel, which the JAX
package runs for ``use_pallas = 1`` with ``compute_dtype = "f64"``
(is3d2_tpu/core/spectra.py:386-389): the CUDA C++ kernel
csrc/cooper_frye_f32.cu (built for sm_90a by ops/_build.py, bound with
ctypes), and its plain torch version with the same f32 arithmetic.

``cooper_frye_f32`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; ``cooper_frye_f32.launches`` counts kernel
launches.

Operand layout (all contiguous; written by
ops/spectra_fast_common.py::pack_inputs):

  cell  (C, 32) f32   columns CELL_COLS (the last two unused, zero)
  eta   (Ne, 2) f32   cosh(eta), -sinh(eta)
  eta_w (Ne,) f64     quadrature weights
  mom   (6, M) f32    rows MOM_ROWS, m = (species, pT, phi)

and the result is the (M,) f64 sum over cells and eta of w * p.dsigma * f.

The arithmetic, in f32, of one (cell, eta, m) evaluation with
P = (mT cosh, px, py, -mT sinh):

  * per (cell, eta), independent of m: the mT coefficients of u.p, p.dsigma
    and V.p (cE, cD, cV) and the mT^2, mT px, mT py coefficients of
    pi^munu p_mu p_nu (kmm, kmx, kmy);
  * per (cell, m), independent of eta: the px/py parts of the same sums
    (exy, dxy, vxy, pxy);
  * E = cE mT + exy, a = E / T - alphaB b, f_eq = 1 / (e^a + sign), and the
    Grad (df 1) or Chapman-Enskog (df 2) delta-f chain of
    cooper_frye_pallas.py:179-187, with one reciprocal of E for df 2.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import Config

CELL_COLS = ("qe0", "qe1", "qe2", "qe3", "qd0", "qd1", "qd2", "qd3",
             *(f"qpi{k}" for k in range(10)), "qv0", "qv1", "qv2", "qv3",
             "invT", "alphaB", "shear", "bulk0", "bulk1", "bulk2",
             "diff0", "diff1", "unused0", "unused1")
MOM_ROWS = ("mT", "px", "py", "mass2", "b", "sgn")
MAX_ETA = 32   # kMaxEta in the CUDA source

# flag bits of the CUDA launcher (the same as kernel B1's)
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


def cooper_frye_f32_plain(cell, eta, eta_w, mom, cfg: Config):
    """Plain torch version of the kernel: the same f32 arithmetic in the
    same order on (cell block, M) tensors, summed in f64.  Runs on any
    device."""
    C = cell.shape[0]
    M = mom.shape[1]
    mT, px, py, mass2, b, sgn = mom
    mT2, mTpx, mTpy = mT * mT, mT * px, mT * py
    px2, py2, pxpy = px * px, py * py, px * py
    shear = bool(cfg.include_shear_deltaf)
    diffusion = _diffusion(cfg)
    df2 = cfg.df_mode == 2
    out = torch.zeros(M, dtype=torch.float64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = {name: cell[c0:c0 + blk, i:i + 1]
             for i, name in enumerate(CELL_COLS)}
        qpi = [q[f"qpi{k}"] for k in range(10)]
        # per (cell, m): the px/py parts, independent of eta
        exy = q["qe1"] * px + q["qe2"] * py
        dxy = q["qd1"] * px + q["qd2"] * py
        if diffusion:
            vxy = q["qv1"] * px + q["qv2"] * py
        if shear:
            pxy = (qpi[1] * px2 + qpi[2] * py2) + qpi[7] * pxpy
        abb = q["alphaB"] * b
        for e in range(eta.shape[0]):
            ch, sh = eta[e, 0], eta[e, 1]
            # per (cell, eta): the mT coefficients, independent of m
            cE = q["qe0"] * ch + q["qe3"] * sh
            cD = q["qd0"] * ch + q["qd3"] * sh
            E = cE * mT + exy
            feq = 1.0 / (torch.exp(E * q["invT"] - abb) + sgn)
            feqbar = 1.0 - sgn * feq
            pdd = cD * mT + dxy
            if shear:
                kmm = (qpi[0] * ch) * ch + (qpi[3] * sh) * sh + (qpi[6] * ch) * sh
                kmx = qpi[4] * ch + qpi[8] * sh
                kmy = qpi[5] * ch + qpi[9] * sh
                pim = ((kmm * mT2 + kmx * mTpx) + kmy * mTpy) + pxy
            else:
                pim = 0.0
            if df2:
                rE = 1.0 / E
                df = (q["shear"] * pim * rE + q["bulk0"] * E + q["bulk1"] * b
                      + q["bulk2"] * (E - mass2 * rE))
            else:
                df = (q["shear"] * pim + q["bulk0"] * mass2
                      + (q["bulk1"] * b + q["bulk2"] * E) * E)
            if diffusion:
                cV = q["qv0"] * ch + q["qv3"] * sh
                Vp = cV * mT + vxy
                if df2:
                    df = df + (q["diff0"] - q["diff1"] * b * rE) * Vp
                else:
                    df = df + (q["diff0"] * b + q["diff1"] * E) * Vp
            df = feqbar * df
            if cfg.regulate_deltaf:
                df = torch.clamp(df, -1.0, 1.0)
            if cfg.outflow:
                pdd = torch.where(pdd > 0.0, pdd, 0.0)
            value = pdd * (feq * (1.0 + df))
            out += eta_w[e] * value.to(torch.float64).sum(dim=0)
    return out


def _check(cell, eta, eta_w, mom) -> None:
    C = cell.shape[0]
    Ne = eta.shape[0]
    want = {"cell": (cell, torch.float32, (C, len(CELL_COLS))),
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


def cooper_frye_f32(cell, eta, eta_w, mom, cfg: Config) -> torch.Tensor:
    """Run the plain-f32 kernel on CUDA tensors (its plain version on CPU
    tensors).  Returns the (M,) f64 spectra partials."""
    _check(cell, eta, eta_w, mom)
    if cell.device.type == "cpu":
        return cooper_frye_f32_plain(cell, eta, eta_w, mom, cfg)
    if cell.device.type != "cuda":
        raise ValueError(f"no kernel for device {cell.device}")
    from . import _build
    fn = _build.load("cooper_frye_f32").is3d2_cooper_frye_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M = mom.shape[1]
    out = torch.empty(M, dtype=torch.float64, device=cell.device)
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cell.data_ptr(), eta.data_ptr(), eta_w.data_ptr(),
                 mom.data_ptr(), out.data_ptr(),
                 cell.shape[0], eta.shape[0], M, _flags(cfg), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_f32 launch failed: cudaError {err}")
    cooper_frye_f32.launches += 1
    return out


cooper_frye_f32.launches = 0
