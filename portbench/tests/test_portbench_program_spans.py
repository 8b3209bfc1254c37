"""The readers of the program's own spans (``is3d2::`` record_functions,
harness/program_spans.py) on hand-made traces with known answers, and
their entries in BENCHMARK.json."""

import pytest

from portbench.harness import cell, manifest, program_spans
from portbench.harness.trace import Trace

CELLS = ["box2d-grad.spectra", "box3d-ptb.spectra"]
# operation 0 has no copy_back span: its cell reads the others
OP0_CELLS = ["box2d-grad.dndx"]
# name -> (unit, source)
READERS = {
    "setup_tables_ms": ("ms", "program_span"),
    "setup_averages_ms": ("ms", "program_span"),
    "setup_coefficients_ms": ("ms", "program_span"),
    "invariants_ms": ("ms", "program_span"),
    "prep_ms": ("ms", "program_span"),
    "copy_back_ms": ("ms", "device_trace"),
    "idle_unnamed_pct": ("%", "device_trace"),
}


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def span(name, a, b):
    return ev("is3d2::" + name, "user_annotation", a, b - a)


def traced_window():
    """Two surfaces of 1,000 us.  Per surface (offset t0): load_surface
    0-20, particlization 20-1000, setup 20-240 (tables 20-70, averages
    70-90, coefficients 90-240), invariants 240-260 (surface 1: 240-280),
    compute 300-990 (prepare_cells 300-320, cell_physics 320-340, pack
    340-350, launch 350-360, copy_back 900-990); on the card a copy back
    at 245-250 (outside copy_back), B1 360-880 and the spectra's copy back
    905-985."""
    e = []
    for k, t0 in enumerate((0.0, 1000.0)):
        e.append(ev("portbench::surface", "user_annotation", t0, 1000.0))
        for name, a, b in (
                ("load_surface", 0, 20), ("particlization", 20, 1000),
                ("setup", 20, 240), ("setup.tables", 20, 70),
                ("setup.averages", 70, 90), ("setup.coefficients", 90, 240),
                ("invariants", 240, 260 + 20 * k), ("compute", 300, 990),
                ("prepare_cells", 300, 320), ("cell_physics", 320, 340),
                ("pack", 340, 350), ("launch", 350, 360),
                ("copy_back", 900, 990)):
            e.append(span(name, t0 + a, t0 + b))
        e.append(ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                    t0 + 245, 5.0))
        e.append(ev("void cooper_frye_comp_kernel<true>(float)", "kernel",
                    t0 + 360, 520.0))
        e.append(ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                    t0 + 905, 80.0))
    return Trace(e)


def ctx_of(trace):
    return cell.Context(cfg={}, setup_s=1.0, records=[None, None],
                        surfaces=[], data_dir=None, device="cuda",
                        n_species=1, trace=trace)


def read(name, trace):
    return manifest.reader(name).read(ctx_of(trace))


def test_span_readers_on_a_known_window():
    t = traced_window()
    assert read("setup_tables_ms", t) == pytest.approx(0.050)
    assert read("setup_averages_ms", t) == pytest.approx(0.020)
    assert read("setup_coefficients_ms", t) == pytest.approx(0.150)
    # 20 and 40 us
    assert read("invariants_ms", t) == pytest.approx(0.030)
    assert read("prep_ms", t) == pytest.approx(0.050)


def test_copy_back_ignores_copies_outside_its_span():
    # the 5 us copy at 245 lies in invariants, not in copy_back
    assert read("copy_back_ms", traced_window()) == pytest.approx(0.080)


def test_idle_unnamed_on_a_known_window():
    """Idle: 0-245, 250-360, 880-905, 985-1245, 1250-1360, 1880-1905,
    1985-2000 (790 us); in no span but particlization: 260-300, 990-1000,
    1280-1300 and 1990-2000 (80 us)."""
    assert read("idle_unnamed_pct", traced_window()) == \
        pytest.approx(100.0 * 80.0 / 790.0)


def test_idle_unnamed_with_a_gap_half_inside_setup_tables():
    """One surface: B1 0-40, then idle 40-100, setup.tables 70-100: half
    the gap is named; particlization, over all of it, names nothing."""
    t = Trace([ev("portbench::surface", "user_annotation", 0.0, 100.0),
               span("particlization", 0, 100), span("setup.tables", 70, 100),
               ev("cooper_frye_comp_kernel", "kernel", 0.0, 40.0)])
    assert read("idle_unnamed_pct", t) == pytest.approx(50.0)
    assert program_spans.named(t) == [[70.0, 100.0]]


def test_covered_us():
    gaps = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    assert program_spans.covered_us(gaps, [[5.0, 25.0], [45.0, 60.0]]) == \
        pytest.approx(15.0)
    assert program_spans.covered_us(gaps, []) == 0.0


def test_spans_are_given_to_the_surface_they_start_in():
    t = traced_window()
    v = program_spans.per_surface(ctx_of(t), ("invariants",))
    assert v == [pytest.approx(20.0), pytest.approx(40.0)]
    assert program_spans.per_surface(ctx_of(t), ("no-such-span",)) is None


def test_a_program_without_spans_gives_nothing():
    """The parent of the spans: the benchmark's own spans and the card's
    work, but no ``is3d2::`` span; and a trace without device time."""
    e = [ev("portbench::surface", "user_annotation", 0.0, 1000.0),
         ev("portbench::setup", "user_annotation", 0.0, 200.0),
         ev("cooper_frye_comp_kernel", "kernel", 250.0, 600.0),
         ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 890.0, 100.0)]
    for name in READERS:
        assert read(name, Trace(e)) is None, name
    host_only = Trace([ev("portbench::surface", "user_annotation", 0.0, 10.0),
                       span("copy_back", 1.0, 9.0)])
    assert read("copy_back_ms", host_only) is None
    assert read("idle_unnamed_pct", host_only) is None
    assert ctx_of(None).trace is None
    for name in READERS:
        assert read(name, None) is None, name


def test_every_new_entry_resolves_to_a_reader():
    bench = manifest.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, (unit, source) in READERS.items():
        m = entries[name]
        assert (m["unit"], m["source"], m["better"]) == (unit, source, "lower")
        assert m["moves"] == "surfaces_per_s"
        cells = CELLS + ([] if name == "copy_back_ms" else OP0_CELLS)
        assert m["workloads"] == cells
        assert callable(manifest.reader(name).read)
        for wl in cells:
            assert m in manifest.per_layer(bench, wl)
