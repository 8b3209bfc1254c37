"""Modified-equilibrium Cooper-Frye spectra kernel B3 (df 3/4 feqmod and
df 5 famod, 2+1d).

The port of is3d2_tpu/ops/cooper_frye_feqmod_pallas.py::_kernel ("vpu"
arithmetic): the CUDA C++ kernel csrc/cooper_frye_feqmod.cu (built for
sm_90a by ops/_build.py, bound with ctypes), its plain torch version with
the same arithmetic, and the operand packs (counterparts of
``_pack_feqmod_fast`` / ``_pack_famod_fast`` + ``pack_feqmod_pallas``).

``cooper_frye_feqmod`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; ``cooper_frye_feqmod.launches`` counts
kernel launches and ``cooper_frye_feqmod.last_geometry`` holds the latest
launch's geometry.  ``dan_weighted`` puts the eta weight on the dsigma_eta
term of p.dsigma, as the spacetime distributions (operation 0) and the
famod mode do; the feqmod spectra leave it off.  The launch geometry
(register tile, cell split) comes from the operands' shapes alone
(``geometry``, ops/launch_geometry.py).  A launch takes at most ETA_CHUNK
eta nodes: a longer table runs chunk by chunk, one launch each, and the
chunks' results are added in order; the plain version chunks alike.

Operand layout (all contiguous, nothing padded):

  cols   (C, 64) f32   per-cell columns COLS (the JAX kernel's layout;
                       M^-1 row-major at MINV, pi coefficients k0..k9 at K)
  mom    (12, M) f32   rows MOM_ROWS, m = (species, pT, phi)
  renorm (C, S) f32    |renorm|, 0 where it is not finite
  red    (C, S) f32    cell mask * (renorm finite)
  eta    (Ne, 4) f32   eta, weight, cosh(eta), sinh(eta)

and the result is the (M,) f64 sum over cells and eta of red * value.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..config import Config
from ..core.cells import CellArrays
from ..core.spectra import PREFACTOR, MomentumGridDevice, SpeciesArrays
from ..core.spectra_fast import fold_eta_quadrature
from .launch_geometry import (THREADS, Geometry, operand_geometry,
                              over_eta_chunks)

f32 = torch.float32
f64 = torch.float64

# column indices of ``cols`` (cooper_frye_feqmod_pallas.py:44-56)
INVT, ALPHAB, DAT, DAX, DAY, DANT = 0, 1, 2, 3, 4, 5
XT, XX, XY, XNT, YX, YY, ZT, ZNT = range(6, 14)
MINV = 14                       # 14..22: M^-1 row-major (3x3)
INVTEFF, ALPHAB_EFF, ETA_SCALE, BREAKS = 23, 24, 25, 26
UT, UX, UY, TUN = 27, 28, 29, 30
K = 31                          # 31..40: pi quadratic coefficients k0..k9
VT, VX, VY, TVN = 41, 42, 43, 44
RATIO, SHEARC = 45, 46
BULK0, BULK1, BULK2, BULKPI = 47, 48, 49, 50
INVBETAV, DZM3DL, DL = 51, 52, 53
N_COLS = 64

MOM_ROWS = ("mT", "px", "py", "mT2", "px2", "py2", "mTpx", "mTpy", "pxpy",
            "mass2", "b", "sgn")
ETA_CHUNK = 32    # kMaxEta in the CUDA source: the eta nodes of one launch
MAX_DEN = 2.0 ** 126   # kMaxDen: exp overflows past it, 1 / x flushes to 0
R = 4             # kR: momenta (consecutive phi) of one thread's register tile
TILE_CELLS = 16   # kTileCells
MAX_SMEM = 100 * 1024   # bytes of shared memory per block: two fit an SM

# mode and flag values of the CUDA launcher
_MODES = {"famod": 0, 3: 3, 4: 4}
_OUTFLOW, _REGULATE, _DAN_WEIGHTED = 1, 2, 4

# elements of one (cells x M) f32 block of the plain version
_PLAIN_BLOCK_ELEMENTS = 1 << 24


@dataclasses.dataclass
class FeqmodOperands:
    """The kernel's operands (see the module docstring)."""

    cols: torch.Tensor
    mom: torch.Tensor
    renorm: torch.Tensor
    red: torch.Tensor
    eta: torch.Tensor
    n_per_species: int    # NpT * Nphi
    row_len: int          # Nphi: momenta per (species, pT) row of mom
    kind: str             # "feqmod" or "famod"
    dan_weighted: bool = False   # feqmod only: famod always weights dan

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x eta x M."""
        return self.cols.shape[0] * self.eta.shape[0] * self.mom.shape[1]

    def args(self) -> tuple:
        """The tensor and shape arguments of cooper_frye_feqmod."""
        return (self.cols, self.mom, self.renorm, self.red, self.eta,
                self.n_per_species)


def _mode(cfg: Config, kind: str) -> int:
    if kind == "famod":
        return _MODES["famod"]
    if kind != "feqmod" or cfg.df_mode not in (3, 4):
        raise ValueError(f"no kernel mode for kind {kind!r}, df {cfg.df_mode}")
    return _MODES[cfg.df_mode]


def _dan(kind: str, dan_weighted: bool) -> bool:
    """Whether p.dsigma weights its dan term: famod always does."""
    return dan_weighted or kind == "famod"


def _flags(cfg: Config, kind: str, dan_weighted: bool) -> int:
    return ((_OUTFLOW if cfg.outflow else 0)
            | (_REGULATE if cfg.regulate_deltaf else 0)
            | (_DAN_WEIGHTED if _dan(kind, dan_weighted) else 0))


def cooper_frye_feqmod_plain(cols, mom, renorm, red, eta, n_per_species: int,
                             cfg: Config, kind: str,
                             dan_weighted: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: the same arithmetic in the same
    order on (cell block, M) tensors -- f32, except U = M^-1 L, p' = U p and
    E_mod^2 in f64 as in the kernel; the px/py parts formed apart from the
    mT parts; the breakdown branch through one reciprocal of E; both
    branches where-selected per cell; the eta terms of a cell summed in f32,
    the renorm applied once per cell, the cells summed in f64; eta chunk by
    chunk, as the wrapper launches the kernel.  Runs on any device."""
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: _plain_chunk(cols, mom, renorm, red, eta[e0:e1],
                                    n_per_species, cfg, kind,
                                    _dan(kind, dan_weighted)))


def _plain_chunk(cols, mom, renorm, red, eta, n_per_species: int,
                 cfg: Config, kind: str, dan: bool) -> torch.Tensor:
    mode = _mode(cfg, kind)
    C = cols.shape[0]
    M = mom.shape[1]
    p = dict(zip(MOM_ROWS, mom))
    mT, px, py = p["mT"], p["px"], p["py"]
    mass2, bm, sgn = p["mass2"], p["b"], p["sgn"]
    mT64, px64, py64, mass2_64 = (t.to(f64) for t in (mT, px, py, mass2))
    species_of_m = torch.arange(M, device=mom.device) // n_per_species
    out = torch.zeros(M, dtype=f64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = cols[c0:c0 + blk]

        def col(i):
            return q[:, i:i + 1]                          # (b, 1)

        rn = renorm[c0:c0 + blk][:, species_of_m]         # (b, M)
        rd = red[c0:c0 + blk][:, species_of_m]
        breaks = col(BREAKS) != 0.0

        def d(i):
            return col(i).to(f64)

        # U = M^-1 L and p' = U (mT, px, py) in f64: on a nearly singular
        # A, p' cancels and f32 rounding would move E_mod by |A^-1| 6e-8 |p|
        Ux = [d(MINV + 3 * i) * d(XX) + d(MINV + 3 * i + 1) * d(YX)
              for i in range(3)]
        Uy = [d(MINV + 3 * i) * d(XY) + d(MINV + 3 * i + 1) * d(YY)
              for i in range(3)]
        r = [Ux[i] * px64 + Uy[i] * py64 for i in range(3)]

        # once per (cell, phi): the px/py parts
        gd = col(DAX) * px + col(DAY) * py            # p.dsigma, unweighted
        exy = (-col(UX)) * px + (-col(UY)) * py       # breakdown u.p
        invT = col(INVT)
        if mode != 0:
            pimxy = (col(K + 1) * p["px2"] + col(K + 2) * p["py2"]
                     + col(K + 7) * p["pxpy"])
        if mode == 3:
            vxy = col(VX) * px + col(VY) * py
        nchem = -(bm * col(ALPHAB_EFF))
        ab = bm * col(ALPHAB)

        part = torch.zeros((q.shape[0], M), dtype=f32, device=mom.device)
        for e in range(eta.shape[0]):
            eta_e, w, chb, shb = eta[e]

            # ---------------- modified branch ----------------
            sm = d(ETA_SCALE) * eta_e.to(f64)
            ex = torch.exp(sm)
            exi = 1.0 / ex
            ch64 = 0.5 * (ex + exi)
            sh64 = 0.5 * (ex - exi)
            a1 = -(d(XT) * ch64 + d(XNT) * sh64)
            c1 = -(d(ZT) * ch64 + d(ZNT) * sh64)
            Um = [d(MINV + 3 * i) * a1 + d(MINV + 3 * i + 2) * c1
                  for i in range(3)]
            ch, sh = ch64.to(f32), sh64.to(f32)
            if dan:
                pddm0 = w * (ch * col(DAT) - sh * col(DANT))
                pddb0 = w * (chb * col(DAT) - shb * col(DANT))
            else:  # feqmod spectra: the dan term carries no eta weight
                pddm0 = w * ch * col(DAT) - sh * col(DANT)
                pddb0 = w * chb * col(DAT) - shb * col(DANT)

            # p' = U (mT, px, py) = A^-1 p_LRF, E_mod^2 = m^2 + |p'|^2
            pm = [Um[i] * mT64 + r[i] for i in range(3)]
            E2 = (mass2_64 + (pm[0] * pm[0] + pm[1] * pm[1]
                              + pm[2] * pm[2])).to(f32)
            pdd_m = pddm0 * mT + w * gd
            E_mod = torch.sqrt(torch.clamp(E2, min=1e-30))
            den = torch.clamp(torch.exp(E_mod * col(INVTEFF) + nchem) + sgn,
                              max=MAX_DEN)
            if cfg.outflow:
                pdd_m = torch.clamp(pdd_m, min=0.0)
            value_mod = pdd_m * (1.0 / den)

            # ---------------- breakdown branch ----------------
            E = (chb * col(UT) + shb * col(TUN)) * mT + exy
            pdd_b = pddb0 * mT + w * gd
            if cfg.outflow:
                pdd_b = torch.clamp(pdd_b, min=0.0)
            if mode == 0:
                feq = 1.0 / torch.clamp(torch.exp(E * invT - ab) + sgn,
                                        max=MAX_DEN)
                value_b = pdd_b * feq
            else:
                kq1 = (col(K) * (chb * chb) + col(K + 3) * (shb * shb)
                       - col(K + 6) * (chb * shb))
                kq4 = col(K + 4) * chb - col(K + 8) * shb
                kq5 = col(K + 5) * chb - col(K + 9) * shb
                pim = (kq1 * p["mT2"] + pimxy + kq4 * p["mTpx"]
                       + kq5 * p["mTpy"])
                rE = 1.0 / E
                if mode == 3:
                    Vp = (chb * col(VT) + shb * col(TVN)) * mT - vxy
                    feq = 1.0 / torch.clamp(torch.exp(E * invT - ab) + sgn,
                                            max=MAX_DEN)
                    feqbar = 1.0 - sgn * feq
                    df = feqbar * (
                        col(SHEARC) * pim * rE
                        + (col(BULK0) * E + col(BULK1) * bm
                           + col(BULK2) * (E - mass2 * rE)) * col(BULKPI)
                        + (col(RATIO) - bm * rE) * Vp * col(INVBETAV))
                else:  # PTB linearised: f_eq with no chemical potential
                    feq = 1.0 / torch.clamp(torch.exp(E * invT) + sgn,
                                            max=MAX_DEN)
                    feqbar = 1.0 - sgn * feq
                    df = (feqbar * col(SHEARC) * pim * rE + col(DZM3DL)
                          + feqbar * col(DL) * (E - mass2 * rE) * invT)
                if cfg.regulate_deltaf:
                    df = torch.clamp(df, -1.0, 1.0)
                value_b = pdd_b * feq * (1.0 + df)

            part = part + torch.where(breaks, value_b, value_mod)
        # the species' renorm once per cell, on the modified branch only
        out += (rd * torch.where(breaks, part, rn * part)).to(f64).sum(dim=0)
    return out


def _check(cols, mom, renorm, red, eta, n_per_species: int) -> None:
    C, S = renorm.shape
    Ne = eta.shape[0]
    M = mom.shape[1]
    want = {"cols": (cols, (C, N_COLS)), "mom": (mom, (len(MOM_ROWS), M)),
            "renorm": (renorm, (C, S)), "red": (red, (C, S)),
            "eta": (eta, (Ne, 4))}
    for name, (t, shape) in want.items():
        if t.device != cols.device:
            raise ValueError(f"{name} is on {t.device}, cols on {cols.device}")
        if t.dtype != f32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {f32} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Ne < 1:
        raise ValueError("the kernel needs at least one eta node")
    if C < 1 or M < 1 or M >= 2**31 or C * S >= 2**31:
        raise ValueError("cell, species and momentum counts must be >= 1 "
                         "and fit in int32")
    if n_per_species < 1 or S * n_per_species < M:
        raise ValueError(f"{M} momenta do not fit {S} species x "
                         f"{n_per_species} momenta")


def smem_bytes(n_eta: int, span: int) -> int:
    """Dynamic shared memory of one block (smem_bytes of the CUDA source);
    within MAX_SMEM for any eta count of a launch (at most ETA_CHUNK) and
    any span."""
    return TILE_CELLS * (n_eta * (4 * 8 + 8 * 4) + 6 * 8 + N_COLS * 4
                         + 2 * span * 4) + 4 * ETA_CHUNK * 4


@dataclasses.dataclass(frozen=True)
class FeqmodGeometry:
    grid: Geometry
    span: int        # species whose renorm one block stages per cell
    smem: int        # dynamic shared memory of one block, bytes


def geometry(mom: torch.Tensor, n_per_species: int, n_species: int,
             n_cells: int, n_eta: int, r: int = R,
             row_len: int | None = None) -> FeqmodGeometry:
    """The launch geometry for these operands (``n_eta``: the eta nodes of
    one launch).  ``row_len``, the phi count of the momentum grid (a row
    lies inside one species), is read off the rows mT, mass2, b and sign
    where the caller leaves it out (ops/launch_geometry.py::
    operand_geometry)."""
    grid = operand_geometry(
        mom, [MOM_ROWS.index(k) for k in ("mT", "mass2", "b", "sgn")],
        n_cells, r, TILE_CELLS, row_len, divides=n_per_species)
    rows_per_block = -(-(THREADS - 1) // grid.tiles_per_row) + 1
    rows_per_species = n_per_species // grid.row_len
    # a block spans at most THREADS + 1 species
    span = min(n_species,
               (rows_per_block + rows_per_species - 2) // rows_per_species + 1)
    return FeqmodGeometry(grid, span, smem_bytes(n_eta, span))


def launch(cols, mom, renorm, red, eta, n_per_species: int, cfg: Config,
           kind: str, fg: FeqmodGeometry,
           dan_weighted: bool = False) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands of at most ETA_CHUNK eta
    nodes with the geometry ``fg``."""
    from . import _build
    fn = _build.load("cooper_frye_feqmod").is3d2_cooper_frye_feqmod
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    C, S = renorm.shape
    M = mom.shape[1]
    g = fg.grid
    out = torch.empty(M, dtype=f64, device=cols.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, M), dtype=f64, device=cols.device)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cols.data_ptr(), mom.data_ptr(), renorm.data_ptr(),
                 red.data_ptr(), eta.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), C, eta.shape[0], M, S, n_per_species,
                 g.row_len, g.n_split, g.cells_per_split, fg.span,
                 _mode(cfg, kind), _flags(cfg, kind, dan_weighted), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_feqmod launch failed: cudaError {err}")
    cooper_frye_feqmod.launches += 1
    cooper_frye_feqmod.last_geometry = fg
    return out


def cooper_frye_feqmod(cols, mom, renorm, red, eta, n_per_species: int,
                       cfg: Config, kind: str, row_len: int | None = None,
                       dan_weighted: bool = False) -> torch.Tensor:
    """Run kernel B3 on CUDA tensors (its plain version on CPU tensors).
    Returns the (M,) f64 spectra partials, prefactor and degeneracy not
    applied.  ``row_len``: the phi count of the momentum grid, see
    ``geometry``; ``dan_weighted``: see the module docstring."""
    _check(cols, mom, renorm, red, eta, n_per_species)
    _mode(cfg, kind)
    if cols.device.type == "cpu":
        args = (cols, mom, renorm, red, eta, n_per_species, cfg, kind)
        if dan_weighted:
            return cooper_frye_feqmod_plain(*args, dan_weighted=True)
        return cooper_frye_feqmod_plain(*args)
    if cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {cols.device}")
    from . import _build
    r = _build.load("cooper_frye_feqmod").is3d2_cooper_frye_feqmod_tile()
    fg = geometry(mom, n_per_species, renorm.shape[1], cols.shape[0],
                  min(eta.shape[0], ETA_CHUNK), r, row_len)
    return over_eta_chunks(
        eta.shape[0], ETA_CHUNK,
        lambda e0, e1: launch(cols, mom, renorm, red, eta[e0:e1],
                              n_per_species, cfg, kind, fg, dan_weighted))


cooper_frye_feqmod.launches = 0
cooper_frye_feqmod.last_geometry = None   # of the latest launch


# ----------------------------------------------------------------------
# operand packs
# ----------------------------------------------------------------------

def _pack(cells: CellArrays, columns: dict, Minv, k, renorm, red,
          species: SpeciesArrays, grid: MomentumGridDevice,
          kind: str) -> FeqmodOperands:
    """Lay out f64 per-cell columns, (C,3,3) M^-1, (C,10) pi coefficients
    and (C,S) renorm/red as the kernel's f32 operands; build the momentum
    rows and the eta table from ``grid`` with the f32/f64 rounding of
    pack_feqmod_pallas."""
    C = cells.n_padded
    dev = cells.tau.device
    cols = torch.zeros((C, N_COLS), dtype=f32, device=dev)
    for i, v in columns.items():
        cols[:, i] = v.to(f32)
    cols[:, MINV:MINV + 9] = Minv.reshape(C, 9).to(f32)
    cols[:, K:K + 10] = k.to(f32)

    S = species.mass.shape[0]
    NpT = grid.pT.shape[0]
    Nphi = grid.cos_phi.shape[0]
    shape = (S, NpT, Nphi)
    mT = torch.sqrt(species.mass[:, None] ** 2 + grid.pT[None, :] ** 2).to(f32)
    px = (grid.pT[:, None] * grid.cos_phi[None, :])[None]
    py = (grid.pT[:, None] * grid.sin_phi[None, :])[None]
    mT3 = mT[:, :, None]

    def flat(a):
        return a.expand(shape).reshape(-1).to(f32)

    rows = [flat(mT3), flat(px), flat(py), flat(mT3 * mT3), flat(px * px),
            flat(py * py), flat(mT3.to(f64) * px), flat(mT3.to(f64) * py),
            flat(px * py), flat((species.mass ** 2)[:, None, None]),
            flat(species.baryon[:, None, None]),
            flat(species.sign[:, None, None])]
    mom = torch.stack(rows).contiguous()
    eta = torch.stack([grid.eta, grid.eta_weight, torch.cosh(grid.eta),
                       torch.sinh(grid.eta)], dim=1).to(f32).contiguous()
    return FeqmodOperands(cols=cols, mom=mom, renorm=renorm.to(f32).contiguous(),
                          red=red.to(f32).contiguous(), eta=eta,
                          n_per_species=NpT * Nphi, row_len=Nphi, kind=kind)


def _cell_columns(c: CellArrays) -> dict:
    """The columns both packs take from the cells."""
    tau = c.tau
    return {INVT: 1.0 / c.T, ALPHAB: c.alphaB, DAT: c.dat, DAX: c.dax,
            DAY: c.day, DANT: c.dan / tau, UT: c.ut, UX: c.ux, UY: c.uy,
            TUN: tau * c.un}


def _basis_columns(tau, b) -> dict:
    return {XT: b.Xt, XX: b.Xx, XY: b.Xy, XNT: tau * b.Xn, YX: b.Yx,
            YY: b.Yy, ZT: b.Zt, ZNT: tau * b.Zn}


def pack_feqmod(cells: CellArrays, fq, species: SpeciesArrays,
                grid: MomentumGridDevice) -> FeqmodOperands:
    """Operands of the feqmod (df 3/4) mode from the f64 prep
    (core/feqmod.py::FeqmodCellData) and the folded grid."""
    c = cells
    tau = c.tau
    tau2 = tau * tau
    k = torch.stack([c.pitt, c.pixx, c.piyy, tau2 * c.pinn,
                     -2.0 * c.pitx, -2.0 * c.pity, -2.0 * tau * c.pitn,
                     2.0 * c.pixy, 2.0 * tau * c.pixn, 2.0 * tau * c.piyn],
                    dim=1)
    columns = {
        **_cell_columns(c), **_basis_columns(tau, fq),
        INVTEFF: 1.0 / fq.T_mod, ALPHAB_EFF: fq.alphaB_mod,
        ETA_SCALE: fq.eta_scale, BREAKS: fq.breaks_down.to(f64),
        VT: c.Vt, VX: c.Vx, VY: c.Vy, TVN: tau * c.Vn,
        RATIO: c.baryon_enthalpy_ratio, SHEARC: fq.shear_coeff,
        BULK0: fq.bulk0, BULK1: fq.bulk1, BULK2: fq.bulk2, BULKPI: fq.bulkPi,
        INVBETAV: 1.0 / fq.betaV,
        DZM3DL: fq.delta_z - 3.0 * fq.delta_lambda, DL: fq.delta_lambda,
    }
    # the nan/inf species skip (MomentumSpectra.cpp:828-832) folded in
    finite = torch.isfinite(fq.renorm)
    renorm = torch.where(finite, fq.renorm.abs(), 0.0)
    red = c.mask[:, None] * finite
    return _pack(c, columns, fq.Ainv, k, renorm, red, species, grid, "feqmod")


def pack_famod(cells: CellArrays, fm, species: SpeciesArrays,
               grid: MomentumGridDevice) -> FeqmodOperands:
    """Operands of the famod (df 5) mode from the famod prep ``fm``
    (core/spectra_famod.py::FamodCellData: the LRF basis, Binv, lam,
    upsilonB, eta_scale, breaks_down and the per-cell renorm, broadcast over
    the species).  The delta-f columns stay zero.  A non-finite famod
    renorm sends its cell to the breakdown branch in the prep, so no
    species is skipped."""
    c = cells
    C = c.n_padded
    S = species.mass.shape[0]
    columns = {**_cell_columns(c), **_basis_columns(c.tau, fm),
               INVTEFF: 1.0 / fm.lam, ALPHAB_EFF: fm.upsilonB,
               ETA_SCALE: fm.eta_scale, BREAKS: fm.breaks_down.to(f64)}
    renorm = fm.renorm.abs()[:, None].expand(C, S)
    renorm = torch.where(torch.isfinite(renorm), renorm, 0.0)
    red = c.mask[:, None].expand(C, S)
    k = torch.zeros((C, 10), dtype=f64, device=c.tau.device)
    return _pack(c, columns, fm.Binv, k, renorm, red, species, grid, "famod")


def feqmod_operands(cells: CellArrays, fq, species: SpeciesArrays,
                    grid: MomentumGridDevice, cfg: Config,
                    dan_weighted: bool = False) -> FeqmodOperands:
    """Fold the eta quadrature where the strict gate allows, then pack;
    ``dan_weighted``: the spacetime distributions' p.dsigma."""
    if cfg.dimension != 2 or cfg.df_mode not in (3, 4):
        raise ValueError("kernel B3's feqmod mode implements 2+1d df 3/4")
    cells, grid, _ = fold_eta_quadrature(cells, grid, cfg, strict=True)
    return dataclasses.replace(pack_feqmod(cells, fq, species, grid),
                               dan_weighted=dan_weighted)


def famod_operands(cells: CellArrays, fm, species: SpeciesArrays,
                   grid: MomentumGridDevice, cfg: Config) -> FeqmodOperands:
    """Fold the eta quadrature where the strict gate allows (the famod
    integrand is as nonlinear in the odd sources as feqmod's), then pack."""
    if cfg.dimension != 2 or cfg.df_mode != 5:
        raise ValueError("kernel B3's famod mode implements 2+1d df 5")
    cells, grid, _ = fold_eta_quadrature(cells, grid, cfg, strict=True)
    return pack_famod(cells, fm, species, grid)


def _spectra(ops: FeqmodOperands, species: SpeciesArrays,
             grid: MomentumGridDevice, cfg: Config) -> torch.Tensor:
    flat = cooper_frye_feqmod(*ops.args(), cfg, ops.kind, row_len=ops.row_len,
                              dan_weighted=ops.dan_weighted)
    out = flat.reshape(species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)
    return PREFACTOR * species.degeneracy[:, None, None, None] * out


def compute_spectra_feqmod_kernel(cells: CellArrays, fq,
                                  species: SpeciesArrays,
                                  grid: MomentumGridDevice,
                                  cfg: Config) -> torch.Tensor:
    """df 3/4 spectra through kernel B3: (S, NpT, Nphi, 1) f64."""
    return _spectra(feqmod_operands(cells, fq, species, grid, cfg), species,
                    grid, cfg)


def compute_spectra_famod_kernel(cells: CellArrays, fm,
                                 species: SpeciesArrays,
                                 grid: MomentumGridDevice,
                                 cfg: Config) -> torch.Tensor:
    """df 5 spectra through kernel B3's famod mode: (S, NpT, Nphi, 1) f64."""
    return _spectra(famod_operands(cells, fm, species, grid, cfg), species,
                    grid, cfg)
