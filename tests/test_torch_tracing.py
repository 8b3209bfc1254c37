"""The port's spans (is3d2_tpu_torch/tracing.py) and the driver's stage
seconds.

Under torch.profiler, an op-1 run on the CPU (2+1d df 1 through B1's
plain version, 3+1d df 4 through B3's 3+1d plain version) emits every
``is3d2::`` span of its route, each inside its parent, on one thread, and
each stage's ``stage_seconds`` matches its span.  With the profiler off the
program enters no ``record_function``, and ``stage_seconds`` keeps the keys
of operations 0, 1 and 2 as the driver has always given them.  Imports
nothing of JAX; the `gpu` test (B1 and B3's 3+1d mode inside their
``launch`` and ``copy_back`` spans) runs on a card with

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import json

import pytest

torch = pytest.importorskip("torch")

from is3d2_tpu_torch import tracing  # noqa: E402
from is3d2_tpu_torch.driver import IS3D  # noqa: E402
from is3d2_tpu_torch.io import output  # noqa: E402
from is3d2_tpu_torch.tools.synthetic import write_workdir  # noqa: E402

CHOSEN = (211, 321, 2212)

# each span of an op-1 run and the span it lies in
PARENT = {
    "particlization": None,
    "read": "particlization", "load_surface": "read",
    "setup": "particlization", "setup.tables": "setup",
    "setup.averages": "setup", "setup.coefficients": "setup",
    "invariants": "particlization", "compute": "particlization",
    "prepare_cells": "compute", "cell_physics": "compute", "pack": "compute",
    "launch": "compute", "copy_back": "compute",
    "write": "particlization",
}
STAGES = ("read", "setup", "compute", "write")

ROUTES = {
    "2d-df1-f32c": dict(n_cells=1000, params={"cell_block": 512}),
    "3d-df4-f32": dict(n_cells=512, dimension=3, shear_scale=0.2,
                       bulk_scale=0.1,
                       params={"cell_block": 512, "df_mode": 4,
                               "compute_dtype": "f32"}),
}


def _workdir(root, **kw):
    kw = {"chosen_mcids": CHOSEN, "n_pT": 8, "n_phi": 8, **kw}
    return write_workdir(root, **kw)


def _spans(prof, path):
    """(name without the prefix, start, end, thread) of every program span
    in ``prof``'s trace."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    n = len(tracing.PREFIX)
    return [(e["name"][n:], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(tracing.PREFIX)], events


@pytest.fixture(scope="module", params=list(ROUTES))
def traced(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_" + request.param)
    wd = _workdir(root / "wd", **ROUTES[request.param])
    run = IS3D(wd, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run.run_particlization()
    spans, _ = _spans(prof, root / "trace.json")
    return spans, run.stage_seconds


def test_every_span_of_the_route(traced):
    spans, _ = traced
    names = [s[0] for s in spans]
    assert sorted(set(names)) == sorted(PARENT)
    for name in PARENT:
        assert names.count(name) == 1, name


def test_children_lie_inside_their_parents_on_one_thread(traced):
    spans, _ = traced
    assert len({s[3] for s in spans}) == 1
    at = {s[0]: (s[1], s[2]) for s in spans}
    for name, parent in PARENT.items():
        if parent is not None:
            a, b = at[name]
            pa, pb = at[parent]
            assert pa <= a <= b <= pb, (name, parent)
    # the driver's stages and the compute spans follow one another
    for group in (("read", "setup", "invariants", "compute", "write"),
                  ("setup.tables", "setup.averages", "setup.coefficients"),
                  ("prepare_cells", "cell_physics", "pack", "launch",
                   "copy_back")):
        ends = [x for name in group for x in at[name]]
        assert ends == sorted(ends), group


def test_stage_seconds_match_their_spans(traced):
    spans, stages = traced
    at = {s[0]: (s[2] - s[1]) * 1e-6 for s in spans}
    for name in STAGES:
        assert stages[name] == pytest.approx(at[name], rel=0.05), name
    assert "invariants" not in stages


def test_profiler_off_enters_no_record_function(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    wd = _workdir(tmp_path / "wd", **ROUTES["3d-df4-f32"])
    run = IS3D(wd, device="cpu")
    run.run_particlization()
    assert list(run.stage_seconds) == ["read", "setup", "compute", "write"]
    with tracing.stage("x", run.stage_seconds):
        pass
    assert run.stage_seconds["x"] >= 0.0


def test_stage_adds_up_and_span_is_inert_without_a_profiler():
    seconds = {}
    for _ in range(3):
        with tracing.stage("s", seconds):
            pass
    assert 0.0 <= seconds["s"] < 0.1
    with tracing.span("s"):
        pass


class _Writer(output.StreamingEventWriter):
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Writer.made.append(self)


# (workdir options, write) -> the stage_seconds keys in the driver's order
KEYS = [
    ("op0", dict(params={"cell_block": 512, "operation": 0}), True,
     ["read", "setup", "compute", "write"]),
    ("op1", dict(params={"cell_block": 512}), False,
     ["read", "setup", "compute"]),
    ("op1-mode5", dict(surface_mode=5, params={"cell_block": 512}), True,
     ["read", "setup", "compute", "write", "polarization_write",
      "polarization"]),
    ("op1-df5", dict(eos_consistent=True, shear_scale=0.1, bulk_scale=0.05,
                     params={"cell_block": 512, "df_mode": 5,
                             "compute_dtype": "f32"}), False,
     ["read", "setup", "compute", "famod_prep"]),
    ("op2-histograms", dict(params={"cell_block": 512, "operation": 2,
                                    "min_num_hadrons": 2e4}), True,
     ["read", "setup", "compute", "assemble", "write"]),
    ("op2-events", dict(params={"cell_block": 512, "operation": 2,
                                "test_sampler": 0, "min_num_hadrons": 2e4}),
     True,
     ["read", "setup", "compute", "write_exposed", "assemble", "write",
      "write_transfer", "write_overlapped", "write_boost"]),
    ("op2-list", dict(params={"cell_block": 512, "operation": 2,
                              "test_sampler": 0, "min_num_hadrons": 2e4}),
     False, ["read", "setup", "compute", "assemble"]),
]


@pytest.mark.parametrize("options,write,keys", [k[1:] for k in KEYS],
                         ids=[k[0] for k in KEYS])
def test_stage_seconds_keep_their_keys(tmp_path, monkeypatch, options, write,
                                       keys):
    monkeypatch.setattr(output, "StreamingEventWriter", _Writer)
    _Writer.made.clear()
    wd = _workdir(tmp_path / "wd", **{"n_cells": 512, **options})
    run = IS3D(wd, device="cpu")
    run.run_particlization(write=write)
    st = run.stage_seconds
    assert list(st) == keys
    assert all(v >= 0.0 for v in st.values())
    if "famod_prep" in st:
        assert st["famod_prep"] == run.report.reconstruction.seconds
    if "write_boost" in st:
        (w,) = _Writer.made
        assert (st["write"], st["write_transfer"], st["write_boost"]) == (
            w.write_seconds, w.transfer_seconds, w.boost_seconds)
        assert 0.0 <= st["write_overlapped"] <= st["write"]
        assert st["write_exposed"] <= st["assemble"]


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_kernels_run_between_launch_and_copy_back(tmp_path, route):
    """On the card the Cooper-Frye kernels of a surface start after its
    ``launch`` span opens and end before its ``copy_back`` span closes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    wd = _workdir(tmp_path / "wd", **ROUTES[route])
    run = IS3D(wd, device="cuda")
    run.run_particlization(write=False)          # builds and warms up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run.run_particlization(write=False)
    torch.cuda.synchronize()
    spans, events = _spans(prof, tmp_path / "trace.json")
    at = {s[0]: (s[1], s[2]) for s in spans}
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") == "kernel"
                     and "cooper_frye" in e["name"])
    assert kernels, "no Cooper-Frye kernel in the trace"
    assert at["launch"][0] <= kernels[0][0]
    assert kernels[-1][1] <= at["copy_back"][1]
