"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

The window drives the driver's in-memory library path
(``IS3D.load_surface_from_memory`` then ``run_particlization(
fo_from_file=False, write=False)``) in a closed loop: the next surface
starts when the previous one's spectra are on the host.  The traffic file
says how many distinct surfaces are cycled and how many warm up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from is3d2_tpu_torch.config import Config
from is3d2_tpu_torch.driver import IS3D

from . import inputs, manifest
from .instrument import Instruments
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "is3d2_tpu")


@dataclasses.dataclass
class Record:
    """One surface of the window."""
    index: int
    surface: int          # which distinct surface
    start: float          # host clock (perf_counter)
    end: float
    stages: dict          # the driver's stage_seconds
    result: np.ndarray | None


@dataclasses.dataclass
class Context:
    """What the metric readers see."""
    cfg: dict
    setup_s: float
    records: list
    surfaces: list
    data_dir: Path
    device: str
    n_species: int
    trace: Trace | None = None
    _rows: dict = dataclasses.field(default_factory=dict)

    def surface_span(self, i: int):
        """The trace-clock (start, end) of window surface ``i``."""
        return self.trace.spans("surface")[i]

    @property
    def window_us(self):
        spans = self.trace.spans("surface")
        return spans[0][0], spans[-1][1]

    def kernel_s(self, i: int, patterns) -> float | None:
        """Device seconds of the kernels matching ``patterns`` during
        window surface ``i``, from the trace; None where the trace shows
        no device time."""
        if self.trace is None or not self.trace.has_device:
            return None
        a, b = self.surface_span(i)
        spans = self.trace.kernels(patterns, a, b)
        return sum(e - s for s, e, _ in spans) * 1e-6

    def live_cells(self, k: int) -> int:
        """Cells of surface ``k`` with u.dsigma > 0."""
        s = self.surfaces[k]
        ut = np.sqrt(1.0 + s["ux"] ** 2 + s["uy"] ** 2
                     + (s["tau"] * s["un"]) ** 2)
        uds = (ut * s["dat"] + s["ux"] * s["dax"] + s["uy"] * s["day"]
               + s["un"] * s["dan"])
        return int((uds > 0.0).sum())

    def branch_rows(self, k: int) -> tuple[int, int]:
        """3+1d df 4: (modified, linearised) (live cell, y) rows of
        surface ``k``, by the reference's classification."""
        if k not in self._rows:
            ref = manifest.reference(self.cfg["reference"])
            prep = ref.prepare(self.surfaces[k], self.data_dir, self.cfg,
                               self.device)
            y = ref.read_grids(self.data_dir)["y"]
            self._rows[k] = ref.branch_rows(prep, y)
        return self._rows[k]


def _nvidia_smi(*query: str) -> list[str] | None:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(query)}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines() if out.returncode == 0 else None


class ClockSampler:
    """``nvidia-smi`` sampling the SM clock and the power draw every second
    beside the window; one process, stopped and waited for."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=index,clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except FileNotFoundError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        clocks, power = [], []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 3 and parts[0] == "0":
                with contextlib.suppress(ValueError):
                    clocks.append(float(parts[1]))
                    power.append(float(parts[2]))
        return {"sm_clock_mhz": clocks, "power_draw_w": power}


def sample_bins(cfg: dict, species: dict, grids: dict, seed: int) -> dict:
    """The bins compared, drawn from the seed: the configuration's
    ``always_mcids`` and the heaviest species, then species at random up
    to ``species_sampled``; every pT, ``phi_sampled`` phi at random, every
    y."""
    chk = cfg["check"]
    rng = np.random.default_rng([seed, 7])
    mc = list(species["mc_id"])
    chosen = [mc.index(m) for m in chk["always_mcids"] if m in mc]
    heaviest = int(np.argmax(species["mass"]))
    if heaviest not in chosen:
        chosen.append(heaviest)
    rest = [i for i in range(len(mc)) if i not in chosen]
    n_more = max(0, min(len(rest), chk["species_sampled"] - len(chosen)))
    chosen += [int(i) for i in rng.choice(rest, n_more, replace=False)]
    n_phi = len(grids["phi"])
    phi = np.sort(rng.choice(n_phi, min(n_phi, chk["phi_sampled"]),
                             replace=False))
    s, p, f, y = np.meshgrid(np.array(sorted(chosen)), np.arange(len(grids["pT"])),
                             phi, np.arange(cfg["inputs"]["n_y"]), indexing="ij")
    return {"s": s.ravel(), "pT": p.ravel(), "phi": f.ravel(), "y": y.ravel()}


def reference_values(cfg: dict, surface: dict, data_dir: Path, bins: dict,
                     device: str, dtype=torch.float64) -> np.ndarray:
    """The plain reference's spectra at ``bins`` for one surface."""
    ref = manifest.reference(cfg["reference"])
    prep = ref.prepare(surface, data_dir, cfg, device)
    return ref.spectra_bins(prep, ref.read_species(data_dir)["chosen"],
                            ref.read_grids(data_dir), bins, cfg, dtype)


def bin_error(pv: np.ndarray, rv: np.ndarray, bins: dict, floor: float) -> float:
    """The largest |program - reference| over the larger of |reference|
    and ``floor`` times the species' largest sampled |reference|."""
    peak = {s: np.abs(rv[bins["s"] == s]).max() for s in np.unique(bins["s"])}
    den = np.maximum(np.abs(rv), floor * np.array([peak[s] for s in bins["s"]]))
    return float(np.max(np.abs(pv - rv) / den))


def check_bins(cfg: dict, data_dir: Path, seed: int) -> dict:
    ref = manifest.reference(cfg["reference"])
    return sample_bins(cfg, ref.read_species(data_dir)["chosen"],
                       ref.read_grids(data_dir), seed)


def result_shape(cfg: dict, n_species: int) -> tuple:
    inp = cfg["inputs"]
    return (n_species, inp["n_pT"], inp["n_phi"], inp["n_y"])


def compare(cfg: dict, surfaces: list, records: list, data_dir: Path,
            seed: int, device: str, n_species: int) -> dict:
    """The check: the reference at the sampled bins of each distinct
    surface the window ran, against every window result of that surface
    (bin_error); a result that is missing, misshapen or not finite fails."""
    bins = check_bins(cfg, data_dir, seed)
    shape = result_shape(cfg, n_species)
    worst, failed = 0.0, 0
    for k in sorted({r.surface for r in records}):
        rv = reference_values(cfg, surfaces[k], data_dir, bins, device)
        for r in records:
            if r.surface != k:
                continue
            out = r.result
            if out is None or out.shape != shape or not np.isfinite(out).all():
                failed += 1
                continue
            pv = out[bins["s"], bins["pT"], bins["phi"], bins["y"]]
            worst = max(worst, bin_error(pv, rv, bins, cfg["check"]["floor"]))
    return {"max_rel_err": worst, "failed": failed, "bins": len(bins["s"])}


def _forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", bench: dict | None = None,
        cfg: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's object (with
    ``checks`` last) and, under ``_conditions``, the run's conditions.
    ``cfg`` and ``traffic`` replace the cell's own files (the CPU tests run
    tiny configurations)."""
    bench = bench or manifest.load()
    wl = manifest.workload(bench, cell)
    cfg = cfg or manifest.config(bench, wl["config"])
    traffic = traffic or manifest.traffic(wl["traffic"])
    data_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(cell, seed, seconds, trace, t_start, device, bench, wl,
                    cfg, traffic, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def _run(cell, seed, seconds, trace, t_start, device, bench, wl, cfg,
         traffic, data_dir) -> dict:
    cuda = device == "cuda"
    card = _nvidia_smi("name", "power.limit") if cuda else None
    species = inputs.write_data_dir(data_dir, cfg)
    surfaces = inputs.make_surfaces(cfg, seed, traffic["distinct_surfaces"])
    fields = [inputs.memory_fields(s) for s in surfaces]
    program = IS3D(data_dir, cfg=Config(**cfg["params"]), device=device)

    def one(k):
        program.load_surface_from_memory(**fields[k])
        program.run_particlization(fo_from_file=False,
                                   write=bool(traffic["write"]))

    for w in range(traffic["warmup_surfaces"]):
        one(w % len(fields))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    instruments = prof = None
    if trace:
        instruments = Instruments()
        instruments.install()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    setup_s = time.perf_counter() - t_start
    sampler = ClockSampler() if cuda else None

    records = []
    t0 = time.perf_counter()
    try:
        while True:
            i = len(records)
            k = i % len(fields)
            ts = time.perf_counter()
            with (torch.profiler.record_function("portbench::surface")
                  if trace else contextlib.nullcontext()):
                one(k)
            te = time.perf_counter()
            records.append(Record(i, k, ts, te, dict(program.stage_seconds),
                                  program.spectra))
            if te - t0 >= seconds:
                break
    finally:
        clocks = sampler.stop() if sampler else {}
    trace_obj = None
    if trace:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        instruments.remove()
        path = data_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        trace_obj = Trace.from_chrome(path)
        path.unlink()
        del prof
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_species = len(species["mc_id"])
    ctx = Context(cfg=cfg, setup_s=setup_s, records=records,
                  surfaces=surfaces, data_dir=data_dir, device=device,
                  n_species=n_species, trace=trace_obj)
    check = compare(cfg, surfaces, records, data_dir, seed, device, n_species)
    limit = cfg["check"]["limit"]
    correct = check["failed"] == 0 and check["max_rel_err"] <= limit

    metrics = {}
    wanted = (manifest.per_layer(bench, cell) if trace
              else manifest.end_to_end(bench, cell))
    for m in wanted:
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": check["failed"], "metrics": metrics, "device": dev}
    if trace_obj is not None and trace_obj.has_device:
        a, b = ctx.window_us
        dev["busy_s"] = trace_obj.busy_us(a, b) * 1e-6
        dev["window_s"] = (b - a) * 1e-6
        result["breakdown"] = {"device_ops": trace_obj.top_ops(a, b),
                               "idle_gaps": trace_obj.idle_gaps(a, b)}
    result["checks"] = {
        "max_rel_err": {"value": check["max_rel_err"], "limit": limit},
        "failed_surfaces": {"value": check["failed"], "limit": 0}}
    result["_conditions"] = {
        "workload": cell, "seed": seed, "trace": int(trace),
        "card": card,
        "device_count": torch.cuda.device_count() if cuda else 0,
        **clocks, "surfaces_timed": len(records),
        "window_s": records[-1].end - records[0].start,
        "bins_compared": check["bins"]}
    # last, once the check and every reader have run: whatever they
    # loaded counts too
    forbidden = _forbidden_modules()
    if forbidden:
        raise SystemExit(f"portbench: forbidden modules loaded: {forbidden}")
    return result
