"""On the card, at each cell's own size: a short run of each cell comes
out correct with the contract's keys, and each cell's control (the
configuration's lower-precision path) fails the cell's limit on three
seeds while the program passes it.

    python -m pytest -m gpu portbench/tests/test_portbench_gpu.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import calibrate
from portbench.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_short_run_is_correct(card, cell_name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell_name,
         "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0
    assert {"surfaces_per_s", "setup_s"} <= set(result["metrics"])
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_limit(card, cell_name):
    b = manifest.load()
    wl = manifest.workload(b, cell_name)
    cfg = manifest.effective(manifest.config(b, wl["config"]),
                             manifest.traffic(wl["traffic"]))
    seeds = [7001, 7002, 7003]
    r = calibrate.readings(cell_name, seeds, seeds, [], emit=lambda d: None)
    limit = cfg["check"]["limit"]
    assert max(r["program"]) <= limit
    assert min(r["control"]) > limit
