"""The plain reference against the port's CPU paths at a tiny size: the
kernels' plain versions (df 1 f32c in 2+1d, B1; df 4 f32 in 3+1d, B3's
3+1d mode) within their precision, and the port's torch f64 engine in
3+1d df 4 to rounding.  The op-0 reference (reference/spacetime.py)
against a cell-by-cell loop, against the port's f64 op-0 route, and
against its own sum rule."""

import contextlib
import copy
import io
import math

import numpy as np
import pytest

from is3d2_tpu_torch.config import Config
from is3d2_tpu_torch.driver import IS3D
from portbench.harness import cell, inputs, manifest
from portbench.reference import cooper_frye as ref
from portbench.reference import spacetime


def tiny(config: str, **params) -> dict:
    cfg = copy.deepcopy(manifest.config(manifest.load(), config))
    cfg["inputs"].update(n_cells=500, n_pT=5, n_phi=6, n_species=20)
    cfg["params"].update(cell_block=256, **params)
    return cfg


def program_and_reference(cfg, tmp_path, seed=2**33 + 1):
    inputs.write_data_dir(tmp_path, cfg)
    surface = inputs.make_surfaces(cfg, seed, 1)[0]
    prog = IS3D(tmp_path, cfg=Config(**cfg["params"]), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        prog.load_surface_from_memory(**inputs.memory_fields(surface))
        prog.run_particlization(fo_from_file=False, write=False)
    species = ref.read_species(tmp_path)["chosen"]
    grids = ref.read_grids(tmp_path)
    s, p, f, y = np.meshgrid(np.arange(len(species["mc_id"])),
                             np.arange(5), np.arange(6),
                             np.arange(cfg["inputs"]["n_y"]), indexing="ij")
    bins = {"s": s.ravel(), "pT": p.ravel(), "phi": f.ravel(), "y": y.ravel()}
    prep = ref.prepare(surface, tmp_path, cfg, "cpu")
    rv = ref.spectra_bins(prep, species, grids, bins, cfg)
    pv = prog.spectra[bins["s"], bins["pT"], bins["phi"], bins["y"]]
    return cell.bin_error(pv, rv, bins, 1e-4), prep, grids


def test_grad_2d_against_b1_plain(tmp_path):
    err, prep, _ = program_and_reference(tiny("box2d-grad"), tmp_path)
    assert prep["n_live"] > 490
    assert err < 1e-6


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-4), ("f64", 1e-9)])
def test_ptb_3d_against_port(tmp_path, dtype, tol):
    err, prep, grids = program_and_reference(
        tiny("box3d-ptb", compute_dtype=dtype), tmp_path)
    assert err < tol
    mod, lin = ref.branch_rows(prep, grids["y"])
    assert mod + lin == prep["n_live"] * 21
    assert mod > 0 and lin > 0            # both branches are driven


def test_lower_precision_reference_departs(tmp_path):
    """The reference computed in bfloat16 is far off the f64 one: the
    3+1d cell's control."""
    import torch
    cfg = tiny("box3d-ptb")
    inputs.write_data_dir(tmp_path, cfg)
    surface = inputs.make_surfaces(cfg, 9, 1)[0]
    bins = cell.check_bins(cfg, tmp_path, 9)
    rv = cell.reference_values(cfg, surface, tmp_path, bins, "cpu")
    lo = cell.reference_values(cfg, surface, tmp_path, bins, "cpu",
                               torch.bfloat16)
    assert cell.bin_error(lo, rv, bins, 1e-4) > 1e-2


def tiny_dndx(n_cells=300, **params) -> dict:
    b = manifest.load()
    wl = manifest.workload(b, "box2d-grad.dndx")
    cfg = manifest.effective(copy.deepcopy(manifest.config(b, wl["config"])),
                             manifest.traffic(wl["traffic"]))
    cfg["inputs"].update(n_cells=n_cells, n_pT=4, n_phi=5, n_species=12)
    cfg["params"].update(cell_block=128, **params)
    return cfg


def dndx_reference(cfg, tmp_path, seed=2**33 + 5):
    inputs.write_data_dir(tmp_path, cfg)
    surface = inputs.make_surfaces(cfg, seed, 1)[0]
    species = ref.read_species(tmp_path)["chosen"]
    grids = ref.read_grids(tmp_path)
    prep = ref.prepare(surface, tmp_path, cfg, "cpu")
    return (surface, species, grids, prep,
            spacetime.dN_dX(prep, species, grids, cfg))


def test_dndx_against_a_cell_by_cell_loop(tmp_path):
    """Each live cell alone through the op-1 reference (its spectra at
    every pT and phi), contracted with the pT and phi weights and added
    to its bin of each axis, one cell at a time."""
    cfg = tiny_dndx(n_cells=40)
    _, species, grids, prep, got = dndx_reference(cfg, tmp_path)
    p = cfg["params"]
    n_s, n_pT, n_phi = len(species["mass"]), len(grids["pT"]), len(grids["phi"])
    s, k, f = (a.ravel() for a in np.meshgrid(
        np.arange(n_s), np.arange(n_pT), np.arange(n_phi), indexing="ij"))
    bins = {"s": s, "pT": k, "phi": f, "y": np.zeros_like(s)}
    w = (grids["pT_w"][k] * grids["phi_w"][f]).reshape(n_s, -1)
    widths = [(p["tau_max"] - p["tau_min"]) / p["tau_bins"],
              (p["r_max"] - p["r_min"]) / p["r_bins"],
              2.0 * math.pi / p["phip_bins"]]
    want = [np.zeros((n_s, p["tau_bins"])), np.zeros((n_s, p["r_bins"])),
            np.zeros((n_s, p["phip_bins"]))]
    for i in range(prep["n_live"]):
        one = {key: v[i:i + 1] for key, v in prep.items() if key != "n_live"}
        dN = (ref.spectra_bins(one, species, grids, bins, cfg)
              .reshape(n_s, -1) * w).sum(axis=1)
        tau, x, y = (float(one[key][0]) for key in ("tau", "x", "y"))
        phi = math.atan2(y, x)
        phi += 2.0 * math.pi if phi < 0.0 else 0.0
        at = [math.floor((tau - p["tau_min"]) / widths[0]),
              math.floor((math.sqrt(x * x + y * y) - p["r_min"]) / widths[1]),
              math.floor(phi / widths[2])]
        for axis in range(3):
            if 0 <= at[axis] < want[axis].shape[1]:
                want[axis][:, at[axis]] += dN
    for axis, (lo, n) in enumerate(((p["tau_min"], p["tau_bins"]),
                                    (p["r_min"], p["r_bins"]))):
        mid = lo + widths[axis] * (np.arange(n) + 0.5)
        want[axis] /= mid * widths[axis] * (2.0 * math.pi if axis else 1.0)
    want[2] /= widths[2]
    want = np.concatenate(want, axis=1)
    assert got.shape == want.shape == (n_s, 280)
    assert np.count_nonzero(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def test_dndx_against_port_f64(tmp_path):
    """The port's f64 op-0 route (the torch f64 engine, binned) agrees
    with the reference to rounding."""
    cfg = tiny_dndx(compute_dtype="f64")
    surface, species, grids, prep, rv = dndx_reference(cfg, tmp_path)
    prog = IS3D(tmp_path, cfg=Config(**cfg["params"]), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        prog.load_surface_from_memory(**inputs.memory_fields(surface))
        prog.run_particlization(fo_from_file=False, write=False)
    pv = np.concatenate(prog.dN_dX.normalized(prog.cfg), axis=1)
    assert prep["n_live"] > 290 and pv.shape == rv.shape
    np.testing.assert_allclose(pv, rv, rtol=1e-12,
                               atol=1e-12 * np.abs(rv).max())


def test_dndx_sum_rule(tmp_path):
    """Every cell lies inside the tau range, so the tau axis and the
    phi_s axis (which holds every cell) sum to the same dN/dy."""
    cfg = tiny_dndx()
    surface, _, _, prep, got = dndx_reference(cfg, tmp_path)
    p = cfg["params"]
    assert p["tau_min"] <= surface["tau"].min() <= surface["tau"].max() \
        < p["tau_max"]
    tau_norm, _, phi_norm = spacetime.bin_norms(p)
    n_tau, n_r = p["tau_bins"], p["r_bins"]
    by_tau = (got[:, :n_tau] * tau_norm).sum(axis=1)
    by_phi = (got[:, n_tau + n_r:] * phi_norm).sum(axis=1)
    assert (by_phi > 0.0).all()
    np.testing.assert_allclose(by_tau, by_phi, rtol=1e-12)
