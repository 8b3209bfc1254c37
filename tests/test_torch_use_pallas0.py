"""use_pallas = 0 with f32/f32c in 2+1d operation 1 (ROADMAP A7e / A9b).

The JAX package's use_pallas = 0 runs its XLA fast paths
(is3d2_tpu/core/spectra.py:368-385 ``_block_fast_comp``, :406-419 plain-f32
``_block_fast``, :438-442 and :466-469 ``compute_spectra_feqmod_fast``).
The port has one implementation of each sum, so there it runs the kernels
that use_pallas = -1 runs: B1 for df 1/2, B3 for df 3/4, B3's famod mode
for df 5 (their plain versions on the CPU).  The two packages differ by
design there (ROADMAP C7): df 1 f32 is plain f32 in the JAX package and
compensated B1 in the port; df 3/4 is the ten-term f32 E_mod^2 there (C4)
and B3's f64 |A^-1 p|^2 here.

Bars, relative on bins >= 1e-4 of each species' peak (torch_parity's
surfaces: 512 cells, 8 species, 16 pT x 8 phi, 24 eta):
  * the port's use_pallas = 0 route equals its use_pallas = -1 route, bit
    for bit;
  * against the JAX f64 route: B1 1e-6, B3 1e-4, B3's famod mode 1e-4 (the
    bar of test_torch_famod.py::test_port_cli_matches_jax_driver_df5);
  * against the JAX use_pallas = 0 route at that route's own bar: f32c
    1e-6 (on the baryon case the JAX form drops abl b from the delta-f
    energy, C3: there the JAX route misses 1e-6 of its own f64 route while
    the port meets it), f32 1e-5 (the JAX route rounds the exp argument in
    plain f32, ~5e-6 off f64), the feqmod fast path 1e-3 on a mild
    surface (shear 0.05; on shear 0.2 the JAX ten-term form is the one
    that misses, C4), famod 1e-3 (the JAX route on its own f32 Newton).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (BLOCK, FAMOD_BULK, FAMOD_SHEAR, FEQMOD_BULK,  # noqa: E402
                          FEQMOD_SHEAR, MILD_SHEAR, build_workdir,
                          max_rel_err, run_drivers)

from is3d2_tpu.core.spectra import compute_spectra as j_compute_spectra  # noqa: E402
from is3d2_tpu.driver import IS3D as JIS3D  # noqa: E402

from is3d2_tpu_torch.core.spectra import compute_spectra  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402

torch.set_num_threads(1)

TOL_B1 = 1e-6
TOL_B3 = 1e-4
TOL_F32 = 1e-5
TOL_FEQMOD_FAST = 1e-3

# workdir name -> build_workdir keywords
SURFACES = {
    "df12": {},
    "baryon": {"include_baryon": True},
    "feqmod": {"shear_scale": FEQMOD_SHEAR, "bulk_scale": FEQMOD_BULK},
    "mild": {"shear_scale": MILD_SHEAR, "bulk_scale": FEQMOD_BULK},
    "famod": {"eos_consistent": True, "shear_scale": FAMOD_SHEAR,
              "bulk_scale": FAMOD_BULK},
}


class Pair:
    """Both packages' drivers set up on one workdir for one df mode; their
    compute_spectra (the dispatchers over the routes) on the same
    surface, species and tables."""

    def __init__(self, wd, df_mode: int):
        with contextlib.redirect_stdout(io.StringIO()):
            self.j = JIS3D(wd)
            self.j.cfg = dataclasses.replace(self.j.cfg, df_mode=df_mode)
            self.j.load_surface_from_file()
            self.j._setup()
            self.p = IS3D(wd, device="cpu")
            self.p.cfg = dataclasses.replace(self.p.cfg, df_mode=df_mode)
            self.p.load_surface_from_file()
            self.p._setup()
        self._f64 = None

    def jax(self, **fields) -> np.ndarray:
        r = self.j
        cfg = dataclasses.replace(r.cfg, **fields)
        with contextlib.redirect_stdout(io.StringIO()):
            return np.asarray(j_compute_spectra(
                r.surface, r.species, r.chosen_idx, r.grids, r.df_data, cfg,
                r.laguerre))

    def jax_f64(self) -> np.ndarray:
        if self._f64 is None:
            self._f64 = self.jax(compute_dtype="f64")
        return self._f64

    def port(self, **fields) -> np.ndarray:
        r = self.p
        cfg = dataclasses.replace(r.cfg, **fields)
        with contextlib.redirect_stdout(io.StringIO()):
            return compute_spectra(r.surface, r.species, r.chosen_idx,
                                   r.grids, r.df_data, cfg, "cpu",
                                   laguerre=r.laguerre)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Pair(surface, df_mode), built once each."""
    root = tmp_path_factory.mktemp("torch_use_pallas0")
    workdirs, cache = {}, {}

    def get(surface: str, df_mode: int) -> Pair:
        if surface not in workdirs:
            kw = SURFACES[surface]
            params = {"cell_block": BLOCK}
            if kw.get("include_baryon"):
                params.update(include_baryon=1, include_baryondiff_deltaf=1)
            workdirs[surface] = build_workdir(root / surface, params=params,
                                              **kw)
        if (surface, df_mode) not in cache:
            cache[surface, df_mode] = Pair(workdirs[surface], df_mode)
        return cache[surface, df_mode]
    get.workdirs = workdirs
    return get


def _routes(pair: Pair, dtype: str):
    """The port's use_pallas = 0 and -1 spectra: finite, equal bits."""
    off = pair.port(compute_dtype=dtype, use_pallas=0)
    auto = pair.port(compute_dtype=dtype, use_pallas=-1)
    assert np.isfinite(off).all() and (off > 0).any()
    np.testing.assert_array_equal(off, auto)
    return off


@pytest.mark.parametrize("df_mode", [1, 2])
@pytest.mark.parametrize("dtype", ["f32c", "f32"])
def test_df12_use_pallas0_runs_b1(pairs, df_mode, dtype):
    """B1 (compensated whatever the dtype) against the JAX f64 route at
    1e-6, and against the JAX XLA fast path of the same dtype at its bar."""
    pair = pairs("df12", df_mode)
    off = _routes(pair, dtype)
    err64 = max_rel_err(off, pair.jax_f64())
    assert err64 <= TOL_B1, f"vs JAX f64 {err64:.3e}"
    fast = pair.jax(compute_dtype=dtype, use_pallas=0)
    err = max_rel_err(off, fast)
    assert err <= (TOL_B1 if dtype == "f32c" else TOL_F32), \
        f"vs JAX use_pallas 0 {err:.3e}"
    if dtype == "f32":
        # the JAX route is plain f32: B1 is the closer of the two to f64
        assert max_rel_err(fast, pair.jax_f64()) > err64


def test_baryon_case_keeps_the_alphaB_low_part(pairs):
    """df 2 with baryons and diffusion, f32c: the JAX XLA f32c path drops
    abl b from the delta-f energy (ROADMAP C3) and misses 1e-6 of its own
    f64 route; the port's use_pallas = 0 route meets it."""
    pair = pairs("baryon", 2)
    off = _routes(pair, "f32c")
    fast = pair.jax(compute_dtype="f32c", use_pallas=0)
    assert max_rel_err(fast, pair.jax_f64()) > TOL_B1
    err = max_rel_err(off, pair.jax_f64())
    assert err <= TOL_B1, f"vs JAX f64 {err:.3e}"


@pytest.mark.parametrize("df_mode", [3, 4])
@pytest.mark.parametrize("dtype", ["f32", "f32c"])
def test_feqmod_use_pallas0_runs_b3(pairs, df_mode, dtype):
    """B3 against the JAX f64 route at 1e-4 on the large-viscosity surface
    (cells break down) and on the mild one, and against the JAX feqmod fast
    path at 1e-3 on the mild surface."""
    pair = pairs("feqmod", df_mode)
    off = _routes(pair, dtype)
    err = max_rel_err(off, pair.jax_f64())
    assert err <= TOL_B3, f"shear 0.2: vs JAX f64 {err:.3e}"
    mild = pairs("mild", df_mode)
    off = _routes(mild, dtype)
    err = max_rel_err(off, mild.jax_f64())
    assert err <= TOL_B3, f"shear 0.05: vs JAX f64 {err:.3e}"
    fast = mild.jax(compute_dtype=dtype, use_pallas=0)
    err = max_rel_err(off, fast)
    assert err <= TOL_FEQMOD_FAST, f"shear 0.05: vs JAX fast path {err:.3e}"


def test_famod_use_pallas0_runs_the_famod_mode(pairs):
    """df 5, f32: B3's famod mode on the port's f64 prep against the JAX
    f64 route at 1e-4, and against the JAX use_pallas = 0 route (its XLA
    fast path on its f32 Newton) at 1e-3."""
    pair = pairs("famod", 5)
    off = _routes(pair, "f32")
    err = max_rel_err(off, pair.jax_f64())
    assert err <= TOL_B3, f"vs JAX f64 {err:.3e}"
    fast = pair.jax(compute_dtype="f32", use_pallas=0)
    err = max_rel_err(off, fast)
    assert err <= TOL_FEQMOD_FAST, f"vs JAX use_pallas 0 {err:.3e}"


def test_driver_runs_use_pallas0(pairs):
    """The port's driver with use_pallas 0 (df 4, f32) against the JAX
    driver's f64 route on one workdir (torch_parity.run_drivers)."""
    pairs("feqmod", 4)
    ref, ours = run_drivers(pairs.workdirs["feqmod"], df_mode=4,
                            compute_dtype="f32", use_pallas=0)
    assert ours.cfg.use_pallas == 0
    err = max_rel_err(ours.spectra, np.asarray(ref.spectra))
    assert err <= TOL_B3, f"{err:.3e}"
    assert ours.report.breakdown_cells > 0
