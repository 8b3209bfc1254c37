"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

The window drives the driver's in-memory library path
(``IS3D.load_surface_from_memory`` then ``run_particlization(
fo_from_file=False, write=False)``) in a closed loop: the next surface
starts when the previous one's result (the spectra of operation 1, the
dN/dX of operation 0) is on the host.  The traffic file says how many
distinct surfaces are cycled and how many warm up, and may set the
operation; ``OPERATIONS`` says what each operation's check compares.
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
from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch
from is3d2_tpu_torch.config import Config
from is3d2_tpu_torch.driver import IS3D

from ..reference import spacetime
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


def _sample_species(chk: dict, species: dict, rng) -> list[int]:
    """The configuration's ``always_mcids`` and the heaviest species, then
    species at random up to ``species_sampled``."""
    mc = list(species["mc_id"])
    chosen = [mc.index(m) for m in chk["always_mcids"] if m in mc]
    heaviest = int(np.argmax(species["mass"]))
    if heaviest not in chosen:
        chosen.append(heaviest)
    rest = [i for i in range(len(mc)) if i not in chosen]
    n_more = max(0, min(len(rest), chk["species_sampled"] - len(chosen)))
    return chosen + [int(i) for i in rng.choice(rest, n_more, replace=False)]


def sample_bins(cfg: dict, species: dict, grids: dict, seed: int) -> dict:
    """Operation 1's bins compared, drawn from the seed: the sampled
    species (_sample_species), every pT, ``phi_sampled`` phi at random,
    every y."""
    chk = cfg["check"]
    rng = np.random.default_rng([seed, 7])
    chosen = _sample_species(chk, species, rng)
    n_phi = len(grids["phi"])
    phi = np.sort(rng.choice(n_phi, min(n_phi, chk["phi_sampled"]),
                             replace=False))
    s, p, f, y = np.meshgrid(np.array(sorted(chosen)), np.arange(len(grids["pT"])),
                             phi, np.arange(cfg["inputs"]["n_y"]), indexing="ij")
    return {"s": s.ravel(), "pT": p.ravel(), "phi": f.ravel(), "y": y.ravel()}


def dndx_bins(cfg: dict, species: dict, grids: dict, seed: int) -> dict:
    """Operation 0's bins compared: the species drawn from the seed as
    for operation 1, every bin of the three axes (``axis`` 0, 1, 2: tau,
    r, phi_s; ``col`` the result's column)."""
    rng = np.random.default_rng([seed, 7])
    chosen = np.array(sorted(_sample_species(cfg["check"], species, rng)))
    axis = np.repeat(np.arange(3), _axis_bins(cfg))
    s, a = np.meshgrid(chosen, axis, indexing="ij")
    return {"s": s.ravel(), "axis": a.ravel(),
            "col": np.tile(np.arange(len(axis)), len(chosen))}


def _axis_bins(cfg: dict) -> list[int]:
    p = cfg["params"]
    return [p["tau_bins"], p["r_bins"], p["phip_bins"]]


def bin_error(pv: np.ndarray, rv: np.ndarray, bins: dict, floor: float) -> float:
    """The largest |program - reference| over the larger of |reference|
    and ``floor`` times the species' largest sampled |reference|."""
    peak = {s: np.abs(rv[bins["s"] == s]).max() for s in np.unique(bins["s"])}
    den = np.maximum(np.abs(rv), floor * np.array([peak[s] for s in bins["s"]]))
    return float(np.max(np.abs(pv - rv) / den))


def _spectra_reference(ref, prep, data_dir, bins, cfg, dtype):
    return ref.spectra_bins(prep, ref.read_species(data_dir)["chosen"],
                            ref.read_grids(data_dir), bins, cfg, dtype)


def _dndx_reference(ref, prep, data_dir, bins, cfg, dtype):
    chosen = ref.read_species(data_dir)["chosen"]
    s = np.unique(bins["s"])
    species = {k: v[s] for k, v in chosen.items()}
    return spacetime.dN_dX(prep, species, ref.read_grids(data_dir), cfg,
                           dtype).ravel()


def _dndx_result(program) -> np.ndarray | None:
    d = program.dN_dX
    return None if d is None else np.concatenate(d.normalized(program.cfg),
                                                 axis=1)


@dataclasses.dataclass(frozen=True)
class Operation:
    """What a cell of one operation holds and checks: the program's result
    after a surface, its shape, the bins compared (drawn from the seed),
    the plain reference there, the program's values there, and the error
    between the two (bin_error's floor applied per ``group``)."""
    result: Callable      # (program) -> np.ndarray | None
    shape: Callable       # (cfg, n_species) -> tuple
    bins: Callable        # (cfg, species, grids, seed) -> dict
    reference: Callable   # (ref, prep, data_dir, bins, cfg, dtype) -> array
    at: Callable          # (result, bins) -> array
    group: Callable       # (bins) -> the bins' group of the floor


OPERATIONS = {
    0: Operation(
        result=_dndx_result,
        shape=lambda cfg, n_species: (n_species, sum(_axis_bins(cfg))),
        bins=dndx_bins, reference=_dndx_reference,
        at=lambda out, bins: out[bins["s"], bins["col"]],
        # the three axes have different units: a floor per species and axis
        group=lambda bins: 3 * bins["s"] + bins["axis"]),
    1: Operation(
        result=lambda program: program.spectra,
        shape=lambda cfg, n_species: (n_species, cfg["inputs"]["n_pT"],
                                      cfg["inputs"]["n_phi"],
                                      cfg["inputs"]["n_y"]),
        bins=sample_bins, reference=_spectra_reference,
        at=lambda out, bins: out[bins["s"], bins["pT"], bins["phi"],
                                 bins["y"]],
        group=lambda bins: bins["s"]),
}


def operation(cfg: dict) -> Operation:
    """The Operation of ``cfg``'s ``params["operation"]``; one with no
    comparison raises, so that its cell cannot pass unchecked."""
    op = cfg["params"]["operation"]
    if op not in OPERATIONS:
        raise ValueError(f"portbench: operation {op} has no check against "
                         f"a reference (operations {sorted(OPERATIONS)} do)")
    return OPERATIONS[op]


def check_bins(cfg: dict, data_dir: Path, seed: int) -> dict:
    ref = manifest.reference(cfg["reference"])
    return operation(cfg).bins(cfg, ref.read_species(data_dir)["chosen"],
                               ref.read_grids(data_dir), seed)


def reference_values(cfg: dict, surface: dict, data_dir: Path, bins: dict,
                     device: str, dtype=torch.float64) -> np.ndarray:
    """The plain reference's values at ``bins`` for one surface."""
    ref = manifest.reference(cfg["reference"])
    prep = ref.prepare(surface, data_dir, cfg, device)
    return operation(cfg).reference(ref, prep, data_dir, bins, cfg, dtype)


def check_error(cfg: dict, pv: np.ndarray, rv: np.ndarray,
                bins: dict) -> float:
    """bin_error of the program's values against the reference's, with
    the floor of ``cfg``'s check per species (and, for operation 0, per
    axis)."""
    return bin_error(pv, rv, {"s": operation(cfg).group(bins)},
                     cfg["check"]["floor"])


def compare(cfg: dict, surfaces: list, records: list, data_dir: Path,
            seed: int, device: str, n_species: int) -> dict:
    """The check: the reference at the sampled bins of each distinct
    surface the window ran, against every window result of that surface
    (check_error); a result that is missing, misshapen or not finite
    fails."""
    op = operation(cfg)
    bins = check_bins(cfg, data_dir, seed)
    shape = op.shape(cfg, n_species)
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
            worst = max(worst, check_error(cfg, op.at(out, bins), rv, bins))
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
    tiny configurations); the run takes the configuration that the
    traffic makes of it (manifest.effective)."""
    bench = bench or manifest.load()
    wl = manifest.workload(bench, cell)
    traffic = traffic or manifest.traffic(wl["traffic"])
    cfg = manifest.effective(cfg or manifest.config(bench, wl["config"]),
                             traffic)
    data_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(cell, seed, seconds, trace, t_start, device, bench, wl,
                    cfg, traffic, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def _run(cell, seed, seconds, trace, t_start, device, bench, wl, cfg,
         traffic, data_dir) -> dict:
    cuda = device == "cuda"
    op = operation(cfg)
    card = _nvidia_smi("name", "power.limit") if cuda else None
    species = inputs.write_data_dir(data_dir, cfg)
    surfaces = inputs.make_surfaces(cfg, seed, traffic["distinct_surfaces"],
                                    device)
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
                                  op.result(program)))
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
        "surface_s": [r.end - r.start for r in records],
        "stage_s": {k: [r.stages.get(k) for r in records]
                    for k in ("setup", "compute")},
        "bins_compared": check["bins"]}
    # last, once the check and every reader have run: whatever they
    # loaded counts too
    forbidden = _forbidden_modules()
    if forbidden:
        raise SystemExit(f"portbench: forbidden modules loaded: {forbidden}")
    return result
