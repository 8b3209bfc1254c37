"""Find a cell's pieces by name: the workload entry and the metrics of
BENCHMARK.json, the configuration file it names, the traffic file
``traffic/<name>.json``, the reference module ``reference/<name>.py`` and
one reader ``metrics/<name>.py`` per per-layer metric.  A traffic file may
set parameters of the configuration it runs, the operation among them,
and its own check and control (``effective``).  A later change adds
a cell or a metric by adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def effective(cfg: dict, traffic: dict) -> dict:
    """The configuration one cell runs: the traffic's ``params`` merged
    over the configuration's, and its ``check`` and ``control`` in place
    of the configuration's.  A traffic file with none of these keys gives
    the configuration as it is."""
    out = {**cfg, **{k: traffic[k] for k in ("check", "control")
                     if k in traffic}}
    if "params" in traffic:
        out["params"] = {**cfg["params"], **traffic["params"]}
    return out


def reference(name: str):
    """The plain reference module ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{name}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["per_layer"] if _applies(m, cell)]


def reader(name: str):
    """The reader ``metrics/<name>.py`` of one per-layer metric: a module
    with ``read(ctx) -> float | None``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
