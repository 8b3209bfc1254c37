"""Modified-equilibrium Cooper-Frye spectra kernel B3 (df 3/4 feqmod and
df 5 famod), 2+1d and 3+1d modes.

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

The 3+1d mode (``cooper_frye_feqmod_3d``, below) stands in for the JAX
package's XLA program _feqmod_fast_3d_jit (is3d2_tpu/core/
spectra_feqmod_fast.py:480), which has no Pallas kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..config import Config
from ..core.cells import CellArrays, live_index
from ..core.spectra import PREFACTOR, MomentumGridDevice, SpeciesArrays
from ..core.spectra_fast import (_cell_Q_3d, fold_eta_quadrature,
                                 momentum_matrix_3d)
from ..tracing import span
from .cooper_frye_comp import Tile3d
from .launch_geometry import (H100_SMS, THREADS, Geometry, Geometry3d,
                              cell_ranges, launch_geometry_3d,
                              operand_geometry, over_eta_chunks, row_length)

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
    with span("launch"):
        flat = cooper_frye_feqmod(*ops.args(), cfg, ops.kind,
                                  row_len=ops.row_len,
                                  dan_weighted=ops.dan_weighted)
    out = flat.reshape(species.mass.shape[0], grid.pT.shape[0],
                       grid.cos_phi.shape[0], 1)
    return PREFACTOR * species.degeneracy[:, None, None, None] * out


def compute_spectra_feqmod_kernel(cells: CellArrays, fq,
                                  species: SpeciesArrays,
                                  grid: MomentumGridDevice,
                                  cfg: Config) -> torch.Tensor:
    """df 3/4 spectra through kernel B3: (S, NpT, Nphi, Ny) f64 (in 2+1d
    Ny = 1; in 3+1d its 3+1d mode)."""
    if cfg.dimension == 3:
        with span("pack"):
            ops = feqmod_operands_3d(cells, fq, species, grid, cfg)
        return _spectra_3d(ops, species, grid, cfg)
    with span("pack"):
        ops = feqmod_operands(cells, fq, species, grid, cfg)
    return _spectra(ops, species, grid, cfg)


def compute_spectra_famod_kernel(cells: CellArrays, fm,
                                 species: SpeciesArrays,
                                 grid: MomentumGridDevice,
                                 cfg: Config) -> torch.Tensor:
    """df 5 spectra through kernel B3's famod mode: (S, NpT, Nphi, Ny) f64
    (in 3+1d its 3+1d mode)."""
    if cfg.dimension == 3:
        with span("pack"):
            ops = famod_operands_3d(cells, fm, species, grid, cfg)
        return _spectra_3d(ops, species, grid, cfg)
    with span("pack"):
        ops = famod_operands(cells, fm, species, grid, cfg)
    return _spectra(ops, species, grid, cfg)


# ----------------------------------------------------------------------
# the 3+1d mode
# ----------------------------------------------------------------------
#
# Operand layout (contiguous; written by pack_feqmod_3d / pack_famod_3d,
# the live cells only):
#
#   cols   (C, 8) f32    the modified branch's columns COLS_3D: log2(e) /
#                        T_eff and log2(e) alphaB_eff (scaled in f64, so
#                        that the exponential is 2^x with no rounding more
#                        than e^x had), breaks, p.dsigma against the
#                        light-cone momenta (m+, px, py, m-) with the
#                        cell's a = e^-eta / 2, b = e^eta / 2 folded in
#   cold   (C, 48) f64   U = M^-1 L row-major (3 x 4 against m+, px, py,
#                        m-), the cell's eta, the narrow window (detA, or
#                        famod's detB, where it is below 0.01, else 0);
#                        the linearised branch's columns: 1/T, alphaB,
#                        p.dsigma, u.p and V.p against the light-cone
#                        momenta, pi:pp against their ten products, the
#                        delta-f coefficients of the 2+1d mode
#   mom    (7, M) f64    the rows MOM_ROWS_3D of core/spectra_fast.py::
#                        momentum_matrix_3d, m = (species, pT, y, phi)
#   y      (Ny,) f64     the y table
#   renorm (C, S) f32    |renorm|, 0 where it is not finite
#   red    (C, S) f32    mask * (renorm finite)
#
# and the result is the (M,) f64 sum over the cells of red * value.  A
# cell takes the linearised branch, in f64, where it breaks down, and at
# every y with |y - eta_cell| < window (MomentumSpectra.cpp:863-871),
# decided in f64 as the f64 engine decides it.
#
# The pack puts the clean cells -- breaks and window 0, so that no y row
# takes the linearised branch -- first, in their live order, then the
# others in theirs.  On the card the wrapper counts the leading run of
# clean cells (``clean_count``, on the card: nothing is read back) and runs
# two kernels: the clean kernel, the modified branch alone, on that run,
# and the mixed kernel, both branches (``launch_3d`` runs it on every cell
# on its own), on the cells after it.  Operands in any other order give the
# same function: a clean cell after the run takes the mixed kernel.

INVTEFF_3, ALPHAB_EFF_3, BREAKS_3 = 0, 1, 2   # the first two times log2(e)
QDF_3 = 3                          # 3..6: p.dsigma in f32
N_COLS_3D = 8
U_3, ETA_3, WINDOW_3, INVT_3, ALPHAB_3 = 0, 12, 13, 14, 15   # cold (U: 0..11)
QD_3, QE_3, QV_3 = 16, 20, 24      # four columns each: m+, px, py, m-
K_3 = 28                           # 28..37: the pi:pp coefficients
SHEARC_3, BULK0_3, BULK1_3, BULK2_3, BULKPI_3 = 38, 39, 40, 41, 42
RATIO_3, INVBETAV_3, DZM3DL_3, DL_3 = 43, 44, 45, 46
N_COLD_3D = 48
MOM_ROWS_3D = ("mp", "px", "py", "mm", "mass2", "b", "sgn")
TILE_CELLS_3D = 32   # kTileCells3
# the tiles of the CUDA source, for a tensor that lies off the card: the
# mixed kernel's (kP3m, kY3m, kThreads3m, kMinBlocks3m) and the clean
# kernel's (kP3, kY3, kThreads3, kMinBlocks3)
TILE_3D = Tile3d(r=4, ty=3, threads=256, blocks_per_sm=2)
TILE_3D_CLEAN = Tile3d(r=6, ty=7, threads=128, blocks_per_sm=2)
# the modified branch's exponential is 2^x of its argument times log2(e):
# the pack scales the columns 1/T_eff and alphaB_eff by it in f64
LOG2E = 1.4426950408889634
# the rows constant along a (species, pT, y) row of the momentum grid
_ROW_KEYS_3D = [MOM_ROWS_3D.index(k) for k in ("mp", "mm", "mass2", "b",
                                                "sgn")]
# the window's width: detA below this takes the narrow fallback
NARROW_DET = 0.01


@dataclasses.dataclass
class FeqmodOperands3d:
    """The 3+1d mode's operands (see the layout above)."""

    cols: torch.Tensor
    cold: torch.Tensor
    mom: torch.Tensor
    y: torch.Tensor
    renorm: torch.Tensor
    red: torch.Tensor
    n_per_species: int    # NpT * Ny * Nphi
    row_len: int          # Nphi: momenta per (species, pT, y) row of mom
    n_y: int              # Ny: rows per (species, pT) group of mom
    kind: str             # "feqmod" or "famod"
    n_clean: torch.Tensor  # (1,) int32 on the card: the clean cells
    order: torch.Tensor   # (C,) int64: each cell's place in the live order

    @property
    def evaluations(self) -> int:
        """Integrand evaluations of one kernel call: cells x M."""
        return self.cols.shape[0] * self.mom.shape[1]

    def first(self, n: int) -> "FeqmodOperands3d":
        """The operands of the first ``n`` live cells before the
        partition (a cut with the surface's share of touched cells), clean
        ones first."""
        index = torch.nonzero(self.order < n).squeeze(1)
        return dataclasses.replace(
            self, cols=self.cols[index].contiguous(),
            cold=self.cold[index].contiguous(),
            renorm=self.renorm[index].contiguous(),
            red=self.red[index].contiguous(), order=self.order[index],
            n_clean=(index < self.n_clean).sum(dtype=torch.int32)
            .reshape(1))

    def args(self) -> tuple:
        """The tensor and shape arguments of cooper_frye_feqmod_3d."""
        return (self.cols, self.cold, self.mom, self.y, self.renorm,
                self.red, self.n_per_species)

    def layout(self) -> dict:
        """The grid's shape as the wrapper takes it (``row_len``, ``n_y``)."""
        return {"row_len": self.row_len, "n_y": self.n_y}

    def window(self) -> torch.Tensor:
        """(C, Ny) bool: the (cell, y) pairs inside the narrow window,
        |y - eta_cell| < window, the predicate of the mode and of the f64
        engines."""
        return ((self.y[None, :] - self.cold[:, ETA_3:ETA_3 + 1]).abs()
                < self.cold[:, WINDOW_3:WINDOW_3 + 1])


def _rows_f32(mom) -> tuple:
    """The f32 rows m+, px, py, m-, b, sign of the 3+1d momentum rows."""
    return tuple(mom[MOM_ROWS_3D.index(k)].to(f32)
                 for k in ("mp", "px", "py", "mm", "b", "sgn"))


def _modified_3d(q, u, mom, momf, rn, outflow: bool) -> torch.Tensor:
    """The modified branch on a (cell block, M) tensor in the kernels'
    arithmetic, renorm ``rn`` applied: f32 but p' = U (m+, px, py, m-) and
    E_mod^2 in f64 from the f64 rows, the (m+, m-) parts formed apart from
    the (px, py) parts, the exponential 2^x of the argument the columns
    give pre-scaled by log2(e).  ``q``, ``u``: the block's cols and cold;
    ``momf``: ``_rows_f32(mom)``."""
    mp64, px64, py64, mm64, mass2_64, _, _ = mom
    mpf, pxf, pyf, mmf, bm, sgn = momf

    def col(i):
        return q[:, i:i + 1]                              # (b, 1)

    def d(i):
        return u[:, i:i + 1]

    p = [(d(U_3 + 4 * i) * mp64 + d(U_3 + 4 * i + 3) * mm64)
         + (d(U_3 + 4 * i + 1) * px64 + d(U_3 + 4 * i + 2) * py64)
         for i in range(3)]
    E2 = (mass2_64 + (p[0] * p[0] + p[1] * p[1] + p[2] * p[2])).to(f32)
    E_mod = torch.sqrt(torch.clamp(E2, min=1e-30))
    # exp(E_mod / T_eff - alphaB_eff b) as 2^x, the columns pre-scaled by
    # log2(e) in the pack (b is a whole baryon number: n2 is exact)
    n2 = -(bm * col(ALPHAB_EFF_3))
    den = torch.clamp(torch.exp2(E_mod * col(INVTEFF_3) + n2) + sgn,
                      max=MAX_DEN)
    pdd = ((col(QDF_3) * mpf + col(QDF_3 + 3) * mmf)
           + (col(QDF_3 + 1) * pxf + col(QDF_3 + 2) * pyf))
    if outflow:
        pdd = torch.clamp(pdd, min=0.0)
    return rn * (pdd * (1.0 / den))


def cooper_frye_feqmod_3d_clean_plain(cols, cold, mom, renorm,
                                      n_per_species: int, cfg: Config,
                                      red=None) -> torch.Tensor:
    """Plain torch version of the clean kernel: the modified branch alone
    on every given cell (the caller hands it clean cells), renorm applied
    and no red (with ``red``, multiplied by it as the mixed kernel does:
    the same bits on live cells, where red is 1, or 0 with renorm 0), every
    cell's term summed in f64.  Runs on any device."""
    C, M = cols.shape[0], mom.shape[1]
    species_of_m = torch.arange(M, device=mom.device) // n_per_species
    momf = _rows_f32(mom)
    out = torch.zeros(M, dtype=f64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        value = _modified_3d(cols[c0:c0 + blk], cold[c0:c0 + blk], mom, momf,
                             renorm[c0:c0 + blk][:, species_of_m],
                             bool(cfg.outflow))
        if red is not None:
            value = red[c0:c0 + blk][:, species_of_m] * value
        out += value.to(f64).sum(dim=0)
    return out


def cooper_frye_feqmod_3d_plain(cols, cold, mom, y, renorm, red,
                                n_per_species: int, cfg: Config, kind: str,
                                row_len: int, n_y: int) -> torch.Tensor:
    """Plain torch version of the 3+1d mode, and of its mixed kernel: the
    kernels' arithmetic in their order on (cell block, M) tensors -- the
    modified branch (``_modified_3d``) times red, the linearised branch in
    f64, the window in f64; both branches where-selected per (cell, y),
    every cell's term summed in f64.  Runs on any device."""
    mode = _mode(cfg, kind)
    C, M = cols.shape[0], mom.shape[1]
    mp64, px64, py64, mm64, mass2_64, b64, sgn64 = mom
    m = torch.arange(M, device=mom.device)
    species_of_m = m // n_per_species
    y_of_m = y[(m // row_len) % n_y]
    momf = _rows_f32(mom)
    out = torch.zeros(M, dtype=f64, device=mom.device)
    blk = max(1, min(C, _PLAIN_BLOCK_ELEMENTS // M))
    for c0 in range(0, C, blk):
        q = cols[c0:c0 + blk]
        u = cold[c0:c0 + blk]

        def d(i):
            return u[:, i:i + 1]

        rd = red[c0:c0 + blk][:, species_of_m]            # (b, M)
        narrow = (y_of_m[None, :] - d(ETA_3)).abs() < d(WINDOW_3)
        use_break = (q[:, BREAKS_3:BREAKS_3 + 1] != 0.0) | narrow
        value_mod = (rd * _modified_3d(
            q, u, mom, momf, renorm[c0:c0 + blk][:, species_of_m],
            bool(cfg.outflow))).to(f64)

        # ---------------- linearised branch, f64 ----------------
        def lc(k):   # a light-cone row against (m+, px, py, m-)
            return ((d(k) * mp64 + d(k + 3) * mm64)
                    + (d(k + 1) * px64 + d(k + 2) * py64))

        E = lc(QE_3)
        pdd = lc(QD_3)
        if cfg.outflow:
            pdd = torch.where(pdd > 0.0, pdd, 0.0)
        invT = d(INVT_3)
        if mode == 0:
            value_b = pdd * (1.0 / (torch.exp(E * invT - b64 * d(ALPHAB_3))
                                    + sgn64))
        else:
            k = [d(K_3 + i) for i in range(10)]
            sp_m = mp64 * (k[0] * mp64 + k[6] * mm64) + k[3] * (mm64 * mm64)
            cx = k[4] * mp64 + k[8] * mm64
            cy = k[5] * mp64 + k[9] * mm64
            pim = sp_m + (px64 * ((k[1] * px64 + k[7] * py64) + cx)
                          + py64 * (k[2] * py64 + cy))
            rE = 1.0 / E
            if mode == 3:
                Vp = lc(QV_3)
                feq = 1.0 / (torch.exp(E * invT - b64 * d(ALPHAB_3))
                             + sgn64)
                feqbar = 1.0 - sgn64 * feq
                df = feqbar * (
                    d(SHEARC_3) * pim * rE
                    + (d(BULK0_3) * E + d(BULK1_3) * b64
                       + d(BULK2_3) * (E - mass2_64 * rE)) * d(BULKPI_3)
                    + (d(RATIO_3) - b64 * rE) * Vp * d(INVBETAV_3))
            else:  # PTB linearised: f_eq with no chemical potential
                feq = 1.0 / (torch.exp(E * invT) + sgn64)
                feqbar = 1.0 - sgn64 * feq
                df = (feqbar * d(SHEARC_3) * pim * rE + d(DZM3DL_3)
                      + feqbar * d(DL_3) * (E - mass2_64 * rE) * invT)
            if cfg.regulate_deltaf:
                df = torch.clamp(df, -1.0, 1.0)
            value_b = pdd * feq * (1.0 + df)

        out += torch.where(use_break, rd.to(f64) * value_b,
                           value_mod).sum(dim=0)
    return out


def _check_3d(cols, cold, mom, y, renorm, red, n_per_species: int,
              row_len: int | None, n_y: int) -> None:
    C, S = renorm.shape
    M = mom.shape[1]
    want = {"cols": (cols, f32, (C, N_COLS_3D)),
            "cold": (cold, f64, (C, N_COLD_3D)),
            "mom": (mom, f64, (len(MOM_ROWS_3D), M)), "y": (y, f64, (n_y,)),
            "renorm": (renorm, f32, (C, S)), "red": (red, f32, (C, S))}
    for name, (t, dtype, shape) in want.items():
        if t.device != cols.device:
            raise ValueError(f"{name} is on {t.device}, cols on {cols.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if S < 1 or M < 1 or M >= 2**31 or C * S >= 2**31:
        raise ValueError("species and momentum counts must be >= 1 and the "
                         "tables fit in int32")
    if n_per_species < 1 or S * n_per_species < M:
        raise ValueError(f"{M} momenta do not fit {S} species x "
                         f"{n_per_species} momenta")
    if row_len is not None and n_per_species % (row_len * n_y):
        raise ValueError(f"{n_per_species} momenta a species are no whole "
                         f"number of groups of {n_y} rows of {row_len}")


def geometry_3d(mom: torch.Tensor, n_cells: int, n_y: int,
                tile: Tile3d = TILE_3D,
                row_len: int | None = None) -> Geometry3d:
    """The launch geometry of a 3+1d kernel of ``tile`` (the mixed
    kernel's by default, TILE_3D_CLEAN the clean kernel's): its momenta run
    (species, pT, y, phi), ``n_y`` rows of ``row_len`` phi a (species, pT)
    group, and its cells split as if all ``n_cells`` were its own.
    ``row_len``, the phi count of the grid, is read off the rows m+, m-,
    mass2, b and sign where the caller leaves it out (a device-to-host
    copy); ``n_y`` cannot be, so the caller names it."""
    if row_len is None:
        row_len = row_length(mom[_ROW_KEYS_3D])
    sms = (torch.cuda.get_device_properties(mom.device).multi_processor_count
           if mom.device.type == "cuda" else H100_SMS)
    return launch_geometry_3d(mom.shape[1], row_len, n_y, n_cells, tile.r,
                              tile.ty, TILE_CELLS_3D, tile.threads,
                              tile.blocks_per_sm, sms)


def clean_count(cols: torch.Tensor, cold: torch.Tensor) -> torch.Tensor:
    """(1,) int32 on the operands' device: the length of the leading run
    of clean cells (breaks and window 0), which the clean kernel sums.
    Nothing is read back."""
    touched = (cols[:, BREAKS_3] != 0) | (cold[:, WINDOW_3] != 0)
    return (torch.cumsum(touched, 0) == 0).sum(dtype=torch.int32).reshape(1)


def cell_ranges_3d(g_clean: Geometry3d, g: Geometry3d, n_clean: int,
                   n_cells: int) -> list[tuple[int, int]]:
    """[begin, end) of the cells each partial row of the split route sums
    (empty where end <= begin): the clean kernel's splits, then the mixed
    kernel's.  The kernels' arithmetic."""
    return cell_ranges(g_clean, n_clean) + [
        (n_clean + a, n_clean + b)
        for a, b in cell_ranges(g, n_cells - n_clean)]


def _lib(lib):
    if lib is None:
        from . import _build
        lib = _build.load("cooper_frye_feqmod")
    return lib


def launch_3d(cols, cold, mom, y, renorm, red, n_per_species: int,
              cfg: Config, kind: str, g: Geometry3d, lib=None) -> torch.Tensor:
    """The mixed kernel of ``lib`` (default: this package's build) on
    every cell of checked CUDA operands with the geometry ``g``: B3's 3+1d
    mode as one kernel, the reference the split route is held to.  It is
    no launch of the route and counts none."""
    fn = _lib(lib).is3d2_cooper_frye_feqmod_3d
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    C, S = renorm.shape
    M = mom.shape[1]
    out = torch.empty(M, dtype=f64, device=cols.device)
    partial = out if g.n_split == 1 else torch.empty(
        (g.n_split, M), dtype=f64, device=cols.device)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cols.data_ptr(), cold.data_ptr(), mom.data_ptr(),
                 y.data_ptr(), renorm.data_ptr(), red.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), C, M, S, n_per_species,
                 g.row_len, g.n_y, g.n_split, g.cells_per_split,
                 _mode(cfg, kind), _flags(cfg, kind, False), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_feqmod_3d launch failed: cudaError "
                           f"{err}")
    return out


def launch_3d_split(cols, cold, mom, y, renorm, red, n_per_species: int,
                    cfg: Config, kind: str, g_clean: Geometry3d,
                    g: Geometry3d, lib=None) -> torch.Tensor:
    """The route of the 3+1d mode on checked CUDA operands: the clean
    kernel of ``lib`` on the leading clean cells (``clean_count``) with
    the geometry ``g_clean``, the mixed kernel on the cells after them with
    ``g``, their partial rows added in order.  One launch of the route."""
    fn = _lib(lib).is3d2_cooper_frye_feqmod_3d_split
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    C, S = renorm.shape
    M = mom.shape[1]
    n_clean = clean_count(cols, cold)
    out = torch.empty(M, dtype=f64, device=cols.device)
    partial = torch.empty((g_clean.n_split + g.n_split, M), dtype=f64,
                          device=cols.device)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cols.data_ptr(), cold.data_ptr(), mom.data_ptr(),
                 y.data_ptr(), renorm.data_ptr(), red.data_ptr(),
                 n_clean.data_ptr(), partial.data_ptr(), out.data_ptr(), C, M,
                 S, n_per_species, g.row_len, g.n_y, g_clean.n_split,
                 g_clean.cells_per_split, g.n_split, g.cells_per_split,
                 _mode(cfg, kind), _flags(cfg, kind, False), stream)
    if err != 0:
        raise RuntimeError(f"cooper_frye_feqmod_3d launch failed: cudaError "
                           f"{err}")
    cooper_frye_feqmod_3d.launches += 1
    cooper_frye_feqmod_3d.last_geometry = g
    cooper_frye_feqmod_3d.last_clean_geometry = g_clean
    return out


def cooper_frye_feqmod_3d(cols, cold, mom, y, renorm, red,
                          n_per_species: int, cfg: Config, kind: str,
                          row_len: int | None = None,
                          n_y: int | None = None) -> torch.Tensor:
    """Run B3's 3+1d mode on CUDA tensors, split by cell (the clean and
    the mixed kernel; its plain version on CPU tensors).  Returns the (M,)
    f64 sums, prefactor and degeneracy not applied.  ``n_y``: the
    rapidities of the momentum grid, which the caller must name;
    ``row_len``: its phi count, see ``geometry_3d``."""
    if n_y is None or n_y < 1:
        raise ValueError("cooper_frye_feqmod_3d needs n_y, the rapidity "
                         "count of the momentum grid")
    _check_3d(cols, cold, mom, y, renorm, red, n_per_species, row_len, n_y)
    _mode(cfg, kind)
    if cols.device.type == "cpu":
        if row_len is None:
            row_len = row_length(mom[_ROW_KEYS_3D])
        return cooper_frye_feqmod_3d_plain(cols, cold, mom, y, renorm, red,
                                           n_per_species, cfg, kind,
                                           row_len, n_y)
    if cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {cols.device}")
    lib = _lib(None)
    C = cols.shape[0]
    g_clean = geometry_3d(mom, C, n_y,
                          Tile3d.of(lib, "cooper_frye_feqmod_3d_clean"),
                          row_len)
    g = geometry_3d(mom, C, n_y, Tile3d.of(lib, "cooper_frye_feqmod_3d"),
                    g_clean.row_len)
    return launch_3d_split(cols, cold, mom, y, renorm, red, n_per_species,
                           cfg, kind, g_clean, g, lib)


cooper_frye_feqmod_3d.launches = 0
# the geometries of the route's latest launch: the mixed kernel's and the
# clean kernel's
cooper_frye_feqmod_3d.last_geometry = None
cooper_frye_feqmod_3d.last_clean_geometry = None


def _lrf_matrix_3d(cells: CellArrays, basis, Minv) -> torch.Tensor:
    """U = M^-1 L (C, 3, 4) in f64: L projects (m+, px, py, m-) onto the
    LRF axes, with p^tau = a m+ + b m- and tau p^eta = a m+ - b m-
    (a = e^-eta / 2, b = e^eta / 2 of the cell)."""
    a = 0.5 * torch.exp(-cells.eta)
    b = 0.5 * torch.exp(cells.eta)
    Xnt, Znt = cells.tau * basis.Xn, cells.tau * basis.Zn
    zero = torch.zeros_like(a)
    L = torch.stack([
        torch.stack([a * (Xnt - basis.Xt), basis.Xx, basis.Xy,
                     -b * (basis.Xt + Xnt)], dim=1),
        torch.stack([zero, basis.Yx, basis.Yy, zero], dim=1),
        torch.stack([a * (Znt - basis.Zt), zero, zero,
                     -b * (basis.Zt + Znt)], dim=1)], dim=1)
    return (Minv[:, :, :, None] * L[:, None, :, :]).sum(dim=2)


def _pack_3d(cells: CellArrays, modified: tuple, columns: dict, U, det,
             renorm, red, species: SpeciesArrays, grid: MomentumGridDevice,
             kind: str) -> FeqmodOperands3d:
    """Lay out the modified branch's (1/T_eff, alphaB_eff, breaks), the
    linearised branch's f64 ``columns`` (cold's indices; p.dsigma and u.p
    against the light-cone momenta are added here), U (C, 3, 4), the
    window's determinant and the (C, S) renorm / red tables of the live
    cells as the 3+1d mode's operands, clean cells first
    (``partition_clean``), and the momentum rows and y table from
    ``grid``."""
    c = cells
    dev = c.tau.device
    q = _cell_Q_3d(c, {})
    cold = torch.zeros((c.n_padded, N_COLD_3D), dtype=f64, device=dev)
    for i, v in columns.items():
        cold[:, i] = v
    cold[:, U_3:U_3 + 12] = U.reshape(-1, 12)
    cold[:, ETA_3] = c.eta
    cold[:, WINDOW_3] = torch.where(det < NARROW_DET, det, 0.0)
    cold[:, INVT_3] = 1.0 / c.T
    cold[:, ALPHAB_3] = c.alphaB
    cold[:, QD_3:QD_3 + 4] = q["Q_d"]
    cold[:, QE_3:QE_3 + 4] = q["Q_E"]
    cols = torch.zeros((c.n_padded, N_COLS_3D), dtype=f64, device=dev)
    inv_teff, alpha_eff, cols[:, BREAKS_3] = modified
    cols[:, INVTEFF_3] = LOG2E * inv_teff
    cols[:, ALPHAB_EFF_3] = LOG2E * alpha_eff
    cols[:, QDF_3:QDF_3 + 4] = q["Q_d"]
    rows = momentum_matrix_3d(species, grid)
    mom = torch.stack([rows[k] for k in MOM_ROWS_3D]).contiguous()
    NpT, Nphi, Ny = (grid.pT.shape[0], grid.cos_phi.shape[0],
                     grid.y.shape[0])
    live = live_index(c)
    order, n_clean = partition_clean((cols[live, BREAKS_3] != 0)
                                     | (cold[live, WINDOW_3] != 0))
    at = live[order]
    return FeqmodOperands3d(
        cols=cols[at].to(f32).contiguous(), cold=cold[at].contiguous(),
        mom=mom, y=grid.y.to(f64).contiguous(),
        renorm=renorm[at].to(f32).contiguous(),
        red=red[at].to(f32).contiguous(), n_per_species=NpT * Ny * Nphi,
        row_len=Nphi, n_y=Ny, kind=kind, n_clean=n_clean, order=order)


def partition_clean(touched: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(order, n_clean) of a stable partition of the cells, clean (not
    ``touched``) first: order[i] is the cell placed at i, each set in its
    own order; n_clean a (1,) int32 count.  Scans and a scatter on the
    cells' device: nothing is read back."""
    t = touched.to(torch.int64)
    clean = 1 - t
    n_clean = clean.sum()
    place = torch.where(touched, n_clean + torch.cumsum(t, 0),
                        torch.cumsum(clean, 0)) - 1
    order = torch.empty_like(place).scatter_(
        0, place, torch.arange(place.shape[0], device=place.device))
    return order, n_clean.to(torch.int32).reshape(1)


def pack_feqmod_3d(cells: CellArrays, fq, species: SpeciesArrays,
                   grid: MomentumGridDevice) -> FeqmodOperands3d:
    """The 3+1d mode's operands of the feqmod (df 3/4) prep
    (core/feqmod.py::FeqmodCellData) on a 3+1d surface."""
    c = cells
    q = _cell_Q_3d(c, {})
    columns = {
        SHEARC_3: fq.shear_coeff, BULK0_3: fq.bulk0, BULK1_3: fq.bulk1,
        BULK2_3: fq.bulk2, BULKPI_3: fq.bulkPi,
        RATIO_3: c.baryon_enthalpy_ratio, INVBETAV_3: 1.0 / fq.betaV,
        DZM3DL_3: fq.delta_z - 3.0 * fq.delta_lambda, DL_3: fq.delta_lambda,
        **{QV_3 + k: q["Q_V"][:, k] for k in range(4)},
        **{K_3 + k: q["Q_pi"][:, k] for k in range(10)},
    }
    # the nan/inf species skip (MomentumSpectra.cpp:828-832) folded in
    finite = torch.isfinite(fq.renorm)
    renorm = torch.where(finite, fq.renorm.abs(), 0.0)
    red = c.mask[:, None] * finite
    return _pack_3d(c, (1.0 / fq.T_mod, fq.alphaB_mod,
                        fq.breaks_down.to(f64)), columns,
                    _lrf_matrix_3d(c, fq, fq.Ainv), fq.detA, renorm, red,
                    species, grid, "feqmod")


def pack_famod_3d(cells: CellArrays, fm, species: SpeciesArrays,
                  grid: MomentumGridDevice) -> FeqmodOperands3d:
    """The 3+1d mode's operands of the famod (df 5) prep
    (core/spectra_famod.py::FamodCellData) on a 3+1d surface; the delta-f
    columns stay zero, the window is famod's detB."""
    c = cells
    C = c.n_padded
    S = species.mass.shape[0]
    renorm = fm.renorm.abs()[:, None].expand(C, S)
    renorm = torch.where(torch.isfinite(renorm), renorm, 0.0)
    red = c.mask[:, None].expand(C, S)
    return _pack_3d(c, (1.0 / fm.lam, fm.upsilonB, fm.breaks_down.to(f64)),
                    {}, _lrf_matrix_3d(c, fm, fm.Binv), fm.detB, renorm, red,
                    species, grid, "famod")


def feqmod_operands_3d(cells: CellArrays, fq, species: SpeciesArrays,
                       grid: MomentumGridDevice,
                       cfg: Config) -> FeqmodOperands3d:
    """Pack for B3's 3+1d mode, df 3/4 (no eta fold in 3+1d)."""
    if cfg.dimension != 3 or cfg.df_mode not in (3, 4):
        raise ValueError("B3's 3+1d feqmod mode implements 3+1d df 3/4")
    return pack_feqmod_3d(cells, fq, species, grid)


def famod_operands_3d(cells: CellArrays, fm, species: SpeciesArrays,
                      grid: MomentumGridDevice,
                      cfg: Config) -> FeqmodOperands3d:
    """Pack for B3's 3+1d famod mode, df 5."""
    if cfg.dimension != 3 or cfg.df_mode != 5:
        raise ValueError("B3's 3+1d famod mode implements 3+1d df 5")
    return pack_famod_3d(cells, fm, species, grid)


def run_3d(ops: FeqmodOperands3d, cfg: Config) -> torch.Tensor:
    """The 3+1d mode on ``ops``: the (M,) f64 sums, m = (species, pT, y,
    phi)."""
    return cooper_frye_feqmod_3d(*ops.args(), cfg, ops.kind, **ops.layout())


def _spectra_3d(ops: FeqmodOperands3d, species: SpeciesArrays,
                grid: MomentumGridDevice, cfg: Config) -> torch.Tensor:
    with span("launch"):
        flat = run_3d(ops, cfg)
    out = flat.reshape(species.mass.shape[0], grid.pT.shape[0],
                       grid.y.shape[0], grid.cos_phi.shape[0])
    return (PREFACTOR * species.degeneracy[:, None, None, None]
            * out.permute(0, 1, 3, 2))
