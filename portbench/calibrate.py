"""The readings a cell's limit is set from, at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 2001 2002 ... \\
        [--control-seeds 2001 2002 2003] [--reference-dtypes float32 ...] \\
        [--variant '{"compute_dtype": "f32"}' ...]

For every seed the program runs each distinct surface of the cell once
through the same driver path the window drives, on the configuration the
cell's traffic makes of it (manifest.effective), and the check's number
(``max_rel_err``, cell.check_error over the bins of the cell's operation)
is read against the plain reference: the lower readings.  For each control seed the
configuration's control runs on the same surfaces: the program with the
lower-precision parameters of ``control.params``, or the reference itself
computed in ``control.reference_dtype``: the upper readings.  Each
``--reference-dtypes`` entry adds the reference computed in that dtype
as a further control, and each ``--variant`` the program with those
parameters changed.  One JSON line per reading on standard output, a
summary last.  Needs the card; the benchmark's runs do not run it.
"""

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell_name: str, seeds, control_seeds, reference_dtypes,
             device: str = "cuda", cfg: dict | None = None,
             emit=print, variants=()) -> dict:
    """Run the readings; ``emit`` gets one dict per reading.  Returns
    {"program": [...], "control": [...], "<dtype>": [...],
    "<variant as JSON>": [...]} of the per-seed maxima."""
    import torch
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.driver import IS3D

    from portbench.harness import cell, inputs, manifest

    bench = manifest.load(ROOT)
    wl = manifest.workload(bench, cell_name)
    traffic = manifest.traffic(wl["traffic"])
    cfg = manifest.effective(cfg or manifest.config(bench, wl["config"]),
                             traffic)
    op = cell.operation(cfg)
    ctl = cfg["control"]
    data_dir = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
    named = {json.dumps(v, sort_keys=True): v for v in variants}
    out = {"program": [], "control": [], **{d: [] for d in reference_dtypes},
           **{k: [] for k in named}}
    try:
        inputs.write_data_dir(data_dir, cfg)
        program = IS3D(data_dir, cfg=Config(**cfg["params"]), device=device)
        control = (IS3D(data_dir, cfg=Config(**{**cfg["params"],
                                                 **ctl["params"]}),
                        device=device) if "params" in ctl else None)
        others = {k: IS3D(data_dir, cfg=Config(**{**cfg["params"], **v}),
                          device=device) for k, v in named.items()}

        def run(prog, fields):
            with contextlib.redirect_stdout(sys.stderr):
                prog.load_surface_from_memory(**fields)
                prog.run_particlization(fo_from_file=False, write=False)
            return op.result(prog)

        for seed in dict.fromkeys(list(seeds) + list(control_seeds)):
            bins = cell.check_bins(cfg, data_dir, seed)
            surfaces = inputs.make_surfaces(cfg, seed,
                                            traffic["distinct_surfaces"],
                                            device)
            per = {k: [] for k in out}
            for s in surfaces:
                fields = inputs.memory_fields(s)
                t0 = time.perf_counter()
                rv = cell.reference_values(cfg, s, data_dir, bins, device)
                emit({"seed": seed, "which": "reference_seconds",
                      "seconds": time.perf_counter() - t0})
                if seed in seeds:
                    t0 = time.perf_counter()
                    pv = op.at(run(program, fields), bins)
                    per["program"].append(cell.check_error(cfg, pv, rv, bins))
                    emit({"seed": seed, "which": "program",
                          "max_rel_err": per["program"][-1],
                          "seconds": time.perf_counter() - t0})
                if seed in control_seeds:
                    if control is not None:
                        pv = op.at(run(control, fields), bins)
                    else:
                        pv = cell.reference_values(
                            cfg, s, data_dir, bins, device,
                            getattr(torch, ctl["reference_dtype"]))
                    per["control"].append(cell.check_error(cfg, pv, rv, bins))
                    emit({"seed": seed, "which": "control", "control": ctl,
                          "max_rel_err": per["control"][-1]})
                    for d in reference_dtypes:
                        pv = cell.reference_values(cfg, s, data_dir, bins,
                                                   device, getattr(torch, d))
                        per[d].append(cell.check_error(cfg, pv, rv, bins))
                        emit({"seed": seed, "which": f"reference_{d}",
                              "max_rel_err": per[d][-1]})
                    for k, prog in others.items():
                        pv = op.at(run(prog, fields), bins)
                        per[k].append(cell.check_error(cfg, pv, rv, bins))
                        emit({"seed": seed, "which": f"variant {k}",
                              "max_rel_err": per[k][-1]})
            for k, v in per.items():
                if v:
                    out[k].append(max(v))
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--reference-dtypes", nargs="*", default=[])
    ap.add_argument("--variant", type=json.loads, action="append", default=[],
                    help="JSON of parameters changed from the configuration's")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2

    def emit(d):
        print(json.dumps(d), flush=True)

    out = readings(args.workload, args.seeds, args.control_seeds,
                   args.reference_dtypes, emit=emit, variants=args.variant)
    summary = {k: {"max": max(v), "min": min(v), "n": len(v)}
               for k, v in out.items() if v}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
