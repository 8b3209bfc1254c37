"""Parameter-sweep harness: the modified-distribution paper matrix.

The port's counterpart of is3d2_tpu/tools/sweep.py (the reference's
scripts/modified_distribution/run_all_*.sh): run the smooth spectra for
every (df mode x viscous-correction) combination on one freezeout surface
and archive the dN* and vn* outputs per combination under
``<out>/<df>/<corr>/``.  famod runs the ``none`` and ``shear``
combinations only.  Each combination is one run of the port's driver on
``device`` (the GPU unless the CPU is asked for), with the workdir's own
parameters but operation 1 and the combination's df mode and switches;
the runs write into the workdir's ``results/continuous``, which the next
run overwrites, so the archive is the record.  Where the workdir has no
results of its own before a run, everything in ``results/continuous``
after it is that run's, and the directory becomes the archive in one
rename (copying 1,855 files a run costs seconds on a slow file system);
the last run's files, and every file of a workdir with results of its
own, are copied, so the workdir ends as the JAX tool leaves it.

CLI:
    python -m is3d2_tpu_torch.tools.sweep <workdir> [--out sweep_results]
        [--df grad ce ptm ptb famod] [--corr none shear bulk shear_bulk]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import os
import shutil
import time
from pathlib import Path

DF_MODES = {"grad": 1, "ce": 2, "ptm": 3, "ptb": 4, "famod": 5}
CORRECTIONS = {
    "none": dict(include_shear_deltaf=0, include_bulk_deltaf=0),
    "shear": dict(include_shear_deltaf=1, include_bulk_deltaf=0),
    "bulk": dict(include_shear_deltaf=0, include_bulk_deltaf=1),
    "shear_bulk": dict(include_shear_deltaf=1, include_bulk_deltaf=1),
}


def _rename(src: Path, dst: Path) -> bool:
    """``src`` renamed to ``dst``; False where it cannot be (``dst`` on
    another file system)."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    try:
        src.rename(dst)
    except OSError:
        return False
    return True


def run_sweep(workdir, df_names=("grad", "ce", "ptm", "ptb"),
              corr_names=("none", "shear", "bulk", "shear_bulk"),
              out_dir=None, device=None, timings=None):
    """Run the spectra matrix on ``device`` (None: the GPU); returns
    {(df, corr): archive subdir}.  ``timings``, a dict when given, gets
    each run's stage seconds, its wall ("run") and its archive's
    ("archive") under the same key."""
    from ..config import Config
    from ..driver import IS3D

    workdir = Path(workdir)
    out_dir = Path(out_dir) if out_dir else workdir / "sweep_results"
    base = Config.from_file(workdir / "iS3D_parameters.dat")
    combos = [(df_name, corr) for df_name in df_names
              for corr in (("none", "shear") if df_name == "famod"
                           else corr_names)]

    archived = {}
    cont = workdir / "results/continuous"
    for i, (df_name, corr) in enumerate(combos):
        cfg = dataclasses.replace(base, operation=1,
                                  df_mode=DF_MODES[df_name],
                                  **CORRECTIONS[corr])
        print(f"=== sweep: df={df_name} corrections={corr} ===", flush=True)
        fresh = not cont.is_dir() or not any(cont.iterdir())
        t0 = time.perf_counter()
        run = IS3D(str(workdir), cfg=cfg, device=device)
        run.run_particlization()
        t1 = time.perf_counter()
        dst = out_dir / df_name / corr
        if not (fresh and i < len(combos) - 1 and not dst.exists()
                and all(n.startswith(("dN", "vn")) for n in os.listdir(cont))
                and _rename(cont, dst)):
            dst.mkdir(parents=True, exist_ok=True)
            files = [f for pattern in ("dN*", "vn*")
                     for f in sorted(cont.glob(pattern))]
            # one file at a time pays the file system's latency per file;
            # the copies wait on I/O, so threads overlap them
            with concurrent.futures.ThreadPoolExecutor() as pool:
                list(pool.map(lambda f: shutil.copy(f, dst / f.name), files))
        if timings is not None:
            timings[(df_name, corr)] = {
                **run.stage_seconds, "run": t1 - t0,
                "archive": time.perf_counter() - t1}
        archived[(df_name, corr)] = dst
    print(f"sweep complete: {len(archived)} combinations under {out_dir}")
    return archived


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="is3d2_tpu_torch.tools.sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("workdir")
    ap.add_argument("--out", default=None,
                    help="archive root (default: <workdir>/sweep_results)")
    ap.add_argument("--df", nargs="+", default=["grad", "ce", "ptm", "ptb"],
                    choices=list(DF_MODES))
    ap.add_argument("--corr", nargs="+",
                    default=["none", "shear", "bulk", "shear_bulk"],
                    choices=list(CORRECTIONS))
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda or cpu (default: cuda; "
                         "fails when torch sees no CUDA device)")
    args = ap.parse_args(argv)
    run_sweep(args.workdir, tuple(args.df), tuple(args.corr), args.out,
              device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
