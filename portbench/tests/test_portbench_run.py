"""The entry point refuses to measure without a card, and a run with the
timed path broken underneath comes out not correct: half of the cells
left out of the sum (the rest counted double), and one surface's answer
altered where the driver produces it, in each operation's cell (the
spectra of operation 1, the dN/dX of operation 0).  An operation with no
check is refused at set-up."""

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import cell, manifest

ROOT = Path(__file__).resolve().parents[2]


def _no_card_env():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("JAX_PLATFORMS", None)
    return env


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "box2d-grad.spectra",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=_no_card_env(),
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "box2d-grad.spectra",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=_no_card_env(),
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# Operation 0 compares every bin, and at 400 cells a bin holds ~3 cells:
# it would read the plain kernel's error of single cells, not of the
# ~1,000-cell bins its limit was set from
TINY_CELLS = {"box2d-grad.dndx": 2000}


def _tiny(config, n_cells=400):
    b = manifest.load()
    cfg = copy.deepcopy(manifest.config(b, config))
    cfg["inputs"].update(n_cells=n_cells, n_pT=4, n_phi=5, n_species=12)
    cfg["params"]["cell_block"] = 128
    return b, cfg


def _run(monkeypatch, cell_name, config, surfaces=2):
    """A tiny run whose window holds ``surfaces`` surfaces, however busy
    the host: the window reads a clock that advances one second a read."""
    b, cfg = _tiny(config, TINY_CELLS.get(cell_name, 400))
    reads = itertools.count()
    monkeypatch.setattr(cell, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(reads))))
    with contextlib.redirect_stdout(io.StringIO()):
        # set-up reads the clock once, the window once and twice a surface
        return cell.run(cell_name, 2**32 + 11, 2 * surfaces, False, 0.0,
                        device="cpu", bench=b, cfg=cfg)


# each operation's entry in is3d2_tpu_torch.driver, which the faults break
COMPUTE = {0: "compute_dN_dX", 1: "compute_spectra"}


def _scaled(out, factor: float):
    """A result (the spectra, or operation 0's SpacetimeDistributions)
    times ``factor``."""
    if isinstance(out, np.ndarray):
        return factor * out
    return dataclasses.replace(out, **{
        k: factor * getattr(out, k)
        for k in ("dN_taudtaudy", "dN_twopirdrdy", "dN_dphidy")})


def _half_the_cells(monkeypatch, target):
    from is3d2_tpu_torch import driver
    real = getattr(driver, target)

    def broken(surf, *args, **kwargs):
        n = surf.n_cells // 2
        half = type(surf)(**{k: v[:n] if isinstance(v, np.ndarray) else v
                             for k, v in vars(surf).items()})
        return _scaled(real(half, *args, **kwargs), 2.0)

    monkeypatch.setattr(driver, target, broken)


def _one_answer_altered(monkeypatch, target):
    from is3d2_tpu_torch import driver
    real = getattr(driver, target)
    calls = []

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(1)
        return _scaled(out, 1.0 + 1e-2) if len(calls) == 3 else out
    monkeypatch.setattr(driver, target, broken)


def _operation(cell_name):
    b = manifest.load()
    wl = manifest.workload(b, cell_name)
    cfg = manifest.effective(manifest.config(b, wl["config"]),
                             manifest.traffic(wl["traffic"]))
    return cfg["params"]["operation"]


@pytest.mark.parametrize("cell_name,config", [
    ("box2d-grad.spectra", "box2d-grad"), ("box3d-ptb.spectra", "box3d-ptb"),
    ("box2d-grad.dndx", "box2d-grad")])
@pytest.mark.parametrize("fault", [_half_the_cells, _one_answer_altered])
def test_fault_is_not_correct(monkeypatch, cell_name, config, fault):
    # two surfaces, so the third answer (the warm-up's is the first) lies
    # in the window
    sound = _run(monkeypatch, cell_name, config)
    fault(monkeypatch, COMPUTE[_operation(cell_name)])
    broken = _run(monkeypatch, cell_name, config)
    assert broken["attempted"] == 2
    assert not broken["correct"]
    # the fault, not the size, fails it: far above the sound run's reading
    assert broken["checks"]["max_rel_err"]["value"] > \
        100 * sound["checks"]["max_rel_err"]["value"]
    if config == "box2d-grad":
        assert sound["correct"]


def test_sound_dndx_run_is_correct(monkeypatch):
    """The op-0 cell's window holds operation 0's result, one row of the
    three axes' bins a species, and the check passes it."""
    r = _run(monkeypatch, "box2d-grad.dndx", "box2d-grad")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 2
    assert r["_conditions"]["bins_compared"] == 6 * (120 + 60 + 100)
    assert 0.0 < r["checks"]["max_rel_err"]["value"] \
        <= r["checks"]["max_rel_err"]["limit"]


def test_an_operation_without_check_is_refused(monkeypatch):
    b, cfg = _tiny("box2d-grad")
    traffic = {**manifest.traffic("spectra"), "params": {"operation": 2}}
    with pytest.raises(ValueError, match="operation 2 has no check"):
        cell.run("box2d-grad.spectra", 5, 1.0, False, 0.0, device="cpu",
                 bench=b, cfg=cfg, traffic=traffic)
