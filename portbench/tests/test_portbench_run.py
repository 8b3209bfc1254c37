"""The entry point refuses to measure without a card, and a run with the
timed path broken underneath comes out not correct: half of the cells
left out of the sum (the rest counted double), and one surface's answer
altered where the driver produces it."""

import contextlib
import copy
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


def _tiny(config):
    b = manifest.load()
    cfg = copy.deepcopy(manifest.config(b, config))
    cfg["inputs"].update(n_cells=400, n_pT=4, n_phi=5, n_species=12)
    cfg["params"]["cell_block"] = 128
    return b, cfg


def _run(monkeypatch, cell_name, config, surfaces=2):
    """A tiny run whose window holds ``surfaces`` surfaces, however busy
    the host: the window reads a clock that advances one second a read."""
    b, cfg = _tiny(config)
    reads = itertools.count()
    monkeypatch.setattr(cell, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(reads))))
    with contextlib.redirect_stdout(io.StringIO()):
        # set-up reads the clock once, the window once and twice a surface
        return cell.run(cell_name, 2**32 + 11, 2 * surfaces, False, 0.0,
                        device="cpu", bench=b, cfg=cfg)


def _half_the_cells(monkeypatch):
    from is3d2_tpu_torch import driver
    real = driver.compute_spectra

    def broken(surf, *args, **kwargs):
        n = surf.n_cells // 2
        half = type(surf)(**{k: v[:n] if isinstance(v, np.ndarray) else v
                             for k, v in vars(surf).items()})
        return 2.0 * real(half, *args, **kwargs)

    monkeypatch.setattr(driver, "compute_spectra", broken)


def _one_answer_altered(monkeypatch):
    from is3d2_tpu_torch import driver
    real = driver.compute_spectra
    calls = []

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(1)
        return out * (1.0 + 1e-2) if len(calls) == 3 else out
    monkeypatch.setattr(driver, "compute_spectra", broken)


@pytest.mark.parametrize("cell_name,config", [
    ("box2d-grad.spectra", "box2d-grad"), ("box3d-ptb.spectra", "box3d-ptb")])
@pytest.mark.parametrize("fault", [_half_the_cells, _one_answer_altered])
def test_fault_is_not_correct(monkeypatch, cell_name, config, fault):
    # two surfaces, so the third answer (the warm-up's is the first) lies
    # in the window
    sound = _run(monkeypatch, cell_name, config)
    fault(monkeypatch)
    broken = _run(monkeypatch, cell_name, config)
    assert broken["attempted"] == 2
    assert not broken["correct"]
    # the fault, not the size, fails it: far above the sound run's reading
    assert broken["checks"]["max_rel_err"]["value"] > \
        100 * sound["checks"]["max_rel_err"]["value"]
    if config == "box2d-grad":
        assert sound["correct"]
