"""The plain reference against the port's CPU paths at a tiny size: the
kernels' plain versions (df 1 f32c in 2+1d, B1; df 4 f32 in 3+1d, B3's
3+1d mode) within their precision, and the port's torch f64 engine in
3+1d df 4 to rounding."""

import contextlib
import copy
import io

import numpy as np
import pytest

from is3d2_tpu_torch.config import Config
from is3d2_tpu_torch.driver import IS3D
from portbench.harness import cell, inputs, manifest
from portbench.reference import cooper_frye as ref


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
