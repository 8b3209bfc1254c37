"""The trace reduction and the bound, idle and launch readers on a
synthetic trace with known answers."""

import types

import numpy as np
import pytest

from portbench.harness import bounds, cell, manifest
from portbench.harness.trace import Trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic_trace():
    """Two surfaces of 1,000 us each: per surface a B1 launch of 600 us
    and its add of 50 us, a copy of 100 us, with idle host time between."""
    e = []
    for k, t0 in enumerate((0.0, 1000.0)):
        e.append(ev("portbench::surface", "user_annotation", t0, 1000.0))
        e.append(ev("portbench::setup", "user_annotation", t0, 200.0))
        e.append(ev("aten::sqrt", "cpu_op", t0 + 50, 20.0))
        e.append(ev("void cooper_frye_comp_kernel<true>(float)", "kernel",
                    t0 + 250, 600.0))
        e.append(ev("add_partials", "kernel", t0 + 850, 50.0))
        e.append(ev("Memcpy DtoH", "gpu_memcpy", t0 + 890, 100.0))
    return Trace(e)


def test_busy_gaps_and_breakdown():
    t = synthetic_trace()
    assert t.has_device
    a, b = t.spans("surface")[0][0], t.spans("surface")[-1][1]
    assert (a, b) == (0.0, 2000.0)
    # busy per surface: 250..990 = 740 us
    assert t.busy_us(a, b) == pytest.approx(1480.0)
    gaps = t.gaps(a, b)
    assert gaps[0] == (0.0, 250.0) and gaps[-1] == (1990.0, 2000.0)
    top = t.top_ops(a, b)
    assert top[0][0].startswith("void cooper_frye_comp_kernel")
    assert top[0][1] == pytest.approx(1200e-6)
    label, secs = t.idle_gaps(a, b, 1)[0]
    assert secs == pytest.approx(260e-6)        # 990 .. 1250
    assert label == "setup / python"       # the innermost span at 1,120 us
    assert t.host_label(60.0) == "setup / aten::sqrt"


def fake_ctx(trace, n_species=3, n_cells=4, live=4):
    inp = {"n_pT": 2, "n_phi": 5, "n_eta": 24, "n_y": 1, "n_cells": n_cells,
           "dimension": 2}
    zeros = np.zeros(n_cells)
    surface = {"un": zeros, "dan": zeros, "pixn": zeros, "piyn": zeros}
    recs = [types.SimpleNamespace(index=i, surface=0,
                                  stages={"setup": 0.1, "compute": 0.9})
            for i in range(2)]

    def kernel_s(i, patterns):
        a, b = trace.spans("surface")[i]
        return sum(e - s for s, e, _ in trace.kernels(patterns, a, b)) * 1e-6

    return types.SimpleNamespace(
        cfg={"inputs": inp}, records=recs, surfaces=[surface], trace=trace,
        n_species=n_species, window_us=(0.0, 2000.0), kernel_s=kernel_s,
        live_cells=lambda k: live, branch_rows=lambda k: (30, 10))


def test_readers_on_synthetic_trace():
    t = synthetic_trace()
    ctx = fake_ctx(t)
    assert manifest.reader("device_idle_pct").read(ctx) == pytest.approx(26.0)
    assert manifest.reader("cf_launches_per_surface").read(ctx) == 2.0
    assert manifest.reader("setup_stage_ms").read(ctx) == pytest.approx(100.0)
    # compute 900 ms less 650 us of kernels
    assert manifest.reader("compute_nonkernel_ms").read(ctx) == \
        pytest.approx(900.0 - 0.65)
    # 4 live cells x 12 folded eta x 3 x 2 x 5 momenta
    ev_ = 4 * 12 * 30
    need = bounds.bound_seconds(bounds.B1_OPS_PER_EVALUATION * ev_,
                                bounds.bytes_moved(4, 30))
    assert manifest.reader("b1_bound_pct").read(ctx) == \
        pytest.approx(100.0 * 2 * need / (2 * 650e-6))


def test_b3_reader_counts_rows_by_branch():
    e = [ev("portbench::surface", "user_annotation", 0.0, 1000.0),
         ev("cooper_frye_feqmod_3d_clean_kernel", "kernel", 10.0, 500.0),
         ev("cooper_frye_feqmod_3d_kernel", "kernel", 510.0, 200.0),
         ev("add_partials", "kernel", 710.0, 10.0)]
    ctx = fake_ctx(Trace(e))
    ctx.records = ctx.records[:1]
    ctx.cfg["inputs"].update(n_y=21, dimension=3)
    per = bounds.B3_3D_OPS_PER_EVALUATION
    ops = 30 * (30 * per["modified"] + 10 * per["linearised"])
    need = bounds.bound_seconds(ops, bounds.bytes_moved(4, 30 * 21))
    assert manifest.reader("b3_3d_bound_pct").read(ctx) == \
        pytest.approx(100.0 * need / 710e-6)


def test_readers_without_device_time_give_nothing():
    t = Trace([ev("portbench::surface", "user_annotation", 0.0, 10.0)])
    assert not t.has_device
    assert cell.Context(cfg={}, setup_s=1.0, records=[], surfaces=[],
                        data_dir=None, device="cuda", n_species=1,
                        trace=t).kernel_s(0, ("cooper_frye",)) is None
    ctx = fake_ctx(t)
    ctx.kernel_s = lambda i, p: None
    for name in ("device_idle_pct", "cf_launches_per_surface",
                 "b1_bound_pct", "compute_nonkernel_ms"):
        assert manifest.reader(name).read(ctx) is None


def test_bound_is_the_larger_side():
    assert bounds.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert bounds.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert bounds.B3_3D_OPS_PER_EVALUATION["modified"] == pytest.approx(40.714, abs=1e-3)
