"""BENCHMARK.json against the contract's shape, and the loader that finds
each cell's configuration, traffic, reference and metric readers by
name."""

import json
import re

import pytest

from portbench.harness import cell, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_and_names(bench):
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in bench[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"])
            assert e["name"] not in names
            names.add(e["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_finds_its_pieces(bench):
    configs = {c["name"] for c in bench["configs"]}
    for wl in bench["workloads"]:
        assert wl["config"] in configs and wl["chips"] in (1, 4)
        cfg = manifest.config(bench, wl["config"])
        assert cfg["name"] == wl["config"]
        entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
        assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
        assert entry["file"].startswith("portbench/")
        traffic = manifest.traffic(wl["traffic"])
        assert traffic["distinct_surfaces"] >= 1
        ref = manifest.reference(cfg["reference"])
        assert callable(ref.spectra_bins) and callable(ref.prepare)
        run = manifest.effective(cfg, traffic)
        assert 0 < run["check"]["limit"] < 1
        assert cell.operation(run) in cell.OPERATIONS.values()
        e2e = manifest.end_to_end(bench, wl["name"])
        layers = manifest.per_layer(bench, wl["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layers
        for m in e2e + layers:
            assert callable(manifest.reader(m["name"]).read)


def test_config_files_are_distinct(bench):
    files = [c["file"] for c in bench["configs"]]
    sources = [c["source"] for c in bench["configs"]]
    assert len(set(files)) == len(files) and len(set(sources)) == len(sources)
    for c in bench["configs"]:
        json.loads((manifest.ROOT / c["file"]).read_text())


def test_unknown_names_are_refused(bench):
    with pytest.raises(KeyError):
        manifest.workload(bench, "no-such-cell")
    with pytest.raises(KeyError):
        manifest.config(bench, "no-such-config")


@pytest.mark.parametrize("cell_name", ["box2d-grad.spectra",
                                       "box3d-ptb.spectra"])
def test_spectra_cells_run_their_files_unchanged(bench, cell_name):
    """A traffic file with no params, check or control leaves the
    configuration as its file has it, dict for dict."""
    wl = manifest.workload(bench, cell_name)
    cfg = manifest.config(bench, wl["config"])
    assert manifest.effective(cfg, manifest.traffic(wl["traffic"])) == cfg
    assert cfg["params"]["operation"] == 1


def test_traffic_sets_the_operation_and_its_check(bench):
    wl = manifest.workload(bench, "box2d-grad.dndx")
    cfg = manifest.config(bench, wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    run = manifest.effective(cfg, traffic)
    assert run["params"] == {**cfg["params"], **traffic["params"]}
    assert run["params"]["operation"] == 0
    assert (run["params"]["tau_bins"], run["params"]["r_bins"],
            run["params"]["phip_bins"]) == (120, 60, 100)
    assert run["check"] == traffic["check"] != cfg["check"]
    assert run["control"] == traffic["control"]
    assert run["inputs"] == cfg["inputs"]
    # the configuration itself is left as it was
    assert cfg == manifest.config(bench, wl["config"])
