"""The surface formats of modes 0, 4, 6 and 7 and the in-memory surface,
against the JAX package.

Each format is written by the port's synthetic workdir tool from a seeded
surface (with a dsigma_eta, for the formats that keep one) and read by
both packages: every field of SurfaceData must be equal, bit for bit, since
both parse with the same native parser and apply the same numpy arithmetic
to the columns.  The op-1 spectra of each format then match the JAX
driver's f64 route: <= 1e-10 for the port's f64 engines (summation order
only), <= 1e-6 for kernel B1's route (f32c) and <= 1e-4 for kernel B3's
(f32), the kernels' own bars; on bins >= 1e-4 of each species' peak.
"""

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))

from torch_parity import CHOSEN, max_rel_err, run_drivers  # noqa: E402

from is3d2_tpu.io import surface as j_surface  # noqa: E402

from is3d2_tpu_torch.config import Config  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import surface  # noqa: E402
from is3d2_tpu_torch.tools import synthetic  # noqa: E402

torch.set_num_threads(1)

DAN = 0.05    # dsigma_eta / tau in [-DAN, DAN] where the format keeps it


def _fields(s) -> dict:
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


def _assert_same_surface(ours, ref) -> None:
    a, b = _fields(ours), _fields(ref)
    assert a.keys() == b.keys()
    for name in a:
        if b[name] is None:
            assert a[name] is None, name
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _write(path: Path, mode: int, dimension: int, include_baryon: bool,
           n: int = 96, seed: int = 5):
    s = synthetic.make_surface(n, seed=seed, dimension=dimension,
                               include_baryon=include_baryon)
    if dimension == 2:
        s.dan = s.tau * np.random.default_rng(seed).uniform(-DAN, DAN, n)
    writer = synthetic._WRITERS[mode]
    if mode in (0, 6):
        writer(s, path, include_baryon=include_baryon)
    else:
        writer(s, path)
    return s


@pytest.mark.parametrize("mode,dimension,include_baryon", [
    (0, 2, False), (0, 2, True), (0, 3, True),
    (4, 2, False), (4, 3, False),
    (6, 2, False), (6, 2, True), (6, 3, True),
    (7, 2, False),
])
def test_reader_matches_jax(tmp_path, mode, dimension, include_baryon):
    path = tmp_path / "surface.dat"
    _write(path, mode, dimension, include_baryon)
    ours = surface.read_surface(path, mode, dimension, include_baryon)
    ref = j_surface.read_surface(path, mode, dimension, include_baryon)
    _assert_same_surface(ours, ref)
    assert vars(ours.thermo_averages()) == vars(ref.thermo_averages())


def test_readers_keep_or_zero_dsigma_eta(tmp_path):
    """Mode 4 zeroes dsigma_eta on a 2+1d surface (readindata.cu:588-593)
    and keeps it in 3+1d; modes 0 and 6 keep it; mode 7 has none."""
    kept = {}
    for mode in (0, 4, 6, 7):
        path = tmp_path / f"m{mode}.dat"
        s = _write(path, mode, 2, False)
        kept[mode] = surface.read_surface(path, mode, 2, False).dan
    assert (kept[4] == 0).all() and (kept[7] == 0).all()
    np.testing.assert_array_equal(kept[0], s.dan)
    np.testing.assert_allclose(kept[6], s.dan, rtol=1e-9)
    assert np.abs(kept[6]).max() > 0
    assert np.abs(surface.read_surface(tmp_path / "m4.dat", 4, 3,
                                       False).dan).max() > 0


@pytest.mark.parametrize("dimension,include_baryon,match", [
    (3, False, "boost-invariant"), (2, True, "no baryon chemical potential")])
def test_mode7_rejections_match_jax(tmp_path, dimension, include_baryon,
                                    match):
    path = tmp_path / "surface.dat"
    _write(path, 7, 2, False)
    for read in (surface.read_surface, j_surface.read_surface):
        with pytest.raises(ValueError, match=match):
            read(path, 7, dimension, include_baryon)


def test_mode5_is_still_rejected(tmp_path):
    """Mode 5 runs in 2+1d and in 3+1d (its reader and polarization: tests/
    test_torch_polarization.py, tests/test_torch_polarization_3d.py), and
    with use_mesh too (parallel/, ROADMAP A12); it is still rejected where
    the JAX package rejects the rest: df 4 with baryons."""
    path = tmp_path / "surface.dat"
    s = synthetic.make_surface(8, seed=1, vorticity=True)
    synthetic.write_mode1(s, path, vorticity=True)
    np.testing.assert_array_equal(surface.read_surface(path, 5, 2, False).wyn,
                                  s.wyn)
    Config(mode=5, df_mode=1, compute_dtype="f32c").validate_slice()
    Config(mode=5, df_mode=1, compute_dtype="f32c",
           dimension=3).validate_slice()
    Config(mode=5, df_mode=1, compute_dtype="f32c",
           use_mesh=1).validate_slice()
    with pytest.raises(ValueError, match="PTB"):
        Config(mode=5, df_mode=4, include_baryon=1,
               use_mesh=1).validate_slice()


def _memory_fields(s) -> dict:
    return dict(tau=s.tau, x=s.x, y=s.y, eta=s.eta, dsigma_tau=s.dat,
                dsigma_x=s.dax, dsigma_y=s.day, dsigma_eta=s.dan, E=s.E,
                T=s.T, P=s.P, ux=s.ux, uy=s.uy, un=s.un, pixx=s.pixx,
                pixy=s.pixy, pixn=s.pixn, piyy=s.piyy, piyn=s.piyn,
                pinn=np.zeros_like(s.tau), Pi=s.bulkPi)


def _workdir(root: Path, mode: int, params: dict, dan: float = DAN,
             **kw) -> Path:
    return synthetic.write_workdir(
        root, n_cells=384, seed=3, chosen_mcids=CHOSEN, n_pT=12, n_phi=8,
        n_T=21, surface_mode=mode, dan_scale=dan if mode != 7 else 0.0,
        params={"cell_block": 128, **params}, **kw)


def test_surface_from_memory_matches_jax_and_the_file_route(tmp_path):
    """The in-memory surface equals the JAX package's, and op 1 on it
    (fo_from_file = False) gives the file route's spectra bit for bit."""
    wd = _workdir(tmp_path / "wd", 6, {"df_mode": 1,
                                        "compute_dtype": "f32c"})
    s = surface.read_surface(wd / "input/surface.dat", 6, 2, False)
    fields = _memory_fields(s)
    _assert_same_surface(surface.surface_from_memory(**fields),
                         j_surface.surface_from_memory(**fields))
    with contextlib.redirect_stdout(io.StringIO()):
        by_file = IS3D(wd, device="cpu")
        by_file.run_particlization(write=False)
        in_memory = IS3D(wd, device="cpu")
        in_memory.load_surface_from_memory(**fields)
        (wd / "input/surface.dat").unlink()   # the file is not read again
        in_memory.run_particlization(fo_from_file=False, write=False)
    np.testing.assert_array_equal(in_memory.spectra, by_file.spectra)


# (mode, params, bar against the JAX f64 route, make_surface options)
CLI_CASES = {
    "mode0-df2-f64": (0, {"df_mode": 2, "compute_dtype": "f64"}, 1e-10, {}),
    "mode4-df1-f64": (4, {"df_mode": 1, "compute_dtype": "f64"}, 1e-10, {}),
    "mode6-df4-f64": (6, {"df_mode": 4, "compute_dtype": "f64"}, 1e-10,
                      {"shear_scale": 0.2, "bulk_scale": 0.1}),
    "mode6-df1-f32c": (6, {"df_mode": 1, "compute_dtype": "f32c"}, 1e-6, {}),
    "mode7-df3-f64": (7, {"df_mode": 3, "compute_dtype": "f64"}, 1e-10, {}),
    "mode0-df3-f32": (0, {"df_mode": 3, "compute_dtype": "f32"}, 1e-4,
                      {"shear_scale": 0.2, "bulk_scale": 0.1}),
    "mode2-df2-f64": (2, {"df_mode": 2, "compute_dtype": "f64"}, 1e-10, {}),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_op1_on_each_format_matches_the_jax_driver(tmp_path, case):
    mode, params, bar, kw = CLI_CASES[case]
    wd = _workdir(tmp_path / "wd", mode, params,
                  dan=0.0 if mode == 2 else DAN, **kw)
    ref, ours = run_drivers(wd)
    assert ours.surface.n_cells == 384
    assert max_rel_err(ours.spectra, ref.spectra) <= bar
