"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "is3d2_tpu"}

PROBE = """
import json, sys, copy, time
sys.path.insert(0, {root!r})
T = time.perf_counter()
from portbench.harness import cell, manifest
b = manifest.load()
cfg = copy.deepcopy(manifest.config(b, "box2d-grad"))
cfg["inputs"].update(n_cells=300, n_pT=3, n_phi=4, n_species=10)
cfg["params"]["cell_block"] = 256
out = sys.stdout
sys.stdout = sys.stderr
r = cell.run("box2d-grad.spectra", 5, 0.2, {trace}, T, device="cpu",
             bench=b, cfg=cfg)
sys.stdout = out
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": r["correct"]}}))
"""


def _top_levels(trace: bool) -> dict:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT), trace=trace)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_untraced_and_traced():
    for trace in (False, True):
        r = _top_levels(trace)
        assert r["correct"]
        assert "is3d2_tpu_torch" in r["modules"]
        assert not FORBIDDEN.intersection(r["modules"]), r["modules"]


PLANTED = """
import importlib, json, sys, copy, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {fake!r})
T = time.perf_counter()
from portbench.harness import cell, manifest
real = manifest.{what}

def planted(name):
    importlib.import_module("jax")       # the fake package, found first
    return real(name)

manifest.{what} = planted
b = manifest.load()
cfg = copy.deepcopy(manifest.config(b, "box2d-grad"))
cfg["inputs"].update(n_cells=300, n_pT=3, n_phi=4, n_species=10)
cfg["params"]["cell_block"] = 256
out = sys.stdout
sys.stdout = sys.stderr
r = cell.run("box2d-grad.spectra", 5, 0.2, False, T, device="cpu",
             bench=b, cfg=cfg)
sys.stdout = out
print(json.dumps(r))
"""


@pytest.mark.parametrize("what", ["reader", "reference"])
def test_jax_loaded_after_the_window_gives_no_result(tmp_path, what):
    # a metric reader or the reference that loads a module named jax, at
    # run time and so past any scan of the sources: the run ends without
    # a result and names it
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c",
         PLANTED.format(root=str(ROOT), fake=str(tmp_path), what=what)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "forbidden modules loaded: ['jax']" in out.stderr


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "is3d2_tpu_torch_fake", object())
    assert "is3d2_tpu" not in cell._forbidden_modules() or \
        "is3d2_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in cell._forbidden_modules()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"is3d2_tpu_torch", "portbench"}), path
    probe = ("import sys; sys.path.insert(0, %r); "
             "import portbench.reference.cooper_frye; "
             "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    mods = set(ast.literal_eval(out.stdout.strip()))
    assert not mods & (FORBIDDEN | {"is3d2_tpu_torch"})


def test_no_benchmark_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
