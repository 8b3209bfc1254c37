"""Paper-reproduction / regression parameter sweep.

The port's counterpart of scripts/run_modified_distribution.py (the
reference's tests/modified_distribution matrix: 4 df modes x 4
viscous-switch combinations, driven by
scripts/modified_distribution/run_modified_distribution_*.sh): runs the
continuous spectra for every combination on ``device`` (the GPU unless
the CPU is asked for) and archives the dN outputs under
``<out>/<df>_<switches>/``.

As in the JAX script, each run's configuration is ``Config(...)`` with
the defaults (compute_dtype "f64": the torch f64 engines) and only
operation 1, the df mode, the two switches and ``--hrg-eos`` set: the
workdir's iS3D_parameters.dat is not read.  The workdir supplies the
surface (input/surface.dat, read as the default mode 1 in 2+1d), PDG/,
tables/ and deltaf_coefficients/.

CLI:
    python -m is3d2_tpu_torch.tools.modified_distribution <workdir>
        [--out modified_distribution_results] [--hrg-eos 3]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import itertools
import shutil
from pathlib import Path

DF_NAMES = {1: "grad", 2: "ce", 3: "ptm", 4: "ptb"}
SWITCHES = {
    "none": (0, 0),
    "shear": (1, 0),
    "bulk": (0, 1),
    "shear_bulk": (1, 1),
}


def run_matrix(workdir, out="modified_distribution_results",
               hrg_eos: int = 3, device=None) -> dict:
    """Run the matrix; returns {label: archive dir}."""
    from ..config import Config
    from ..driver import IS3D

    out_root = Path(out)
    archived = {}
    for df_mode, (sw_name, (shear, bulk)) in itertools.product(
            DF_NAMES, SWITCHES.items()):
        label = f"{DF_NAMES[df_mode]}_{sw_name}"
        print(f"=== {label} ===", flush=True)
        cfg = Config(operation=1, df_mode=df_mode, hrg_eos=hrg_eos,
                     include_shear_deltaf=shear, include_bulk_deltaf=bulk)
        run = IS3D(workdir, cfg=cfg, device=device)
        run.run_particlization()

        dst = out_root / label
        dst.mkdir(parents=True, exist_ok=True)
        for f in (Path(workdir) / "results/continuous").glob("dN*"):
            shutil.copy2(f, dst / f.name)
        archived[label] = dst
    print(f"archived results under {out_root}")
    return archived


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="is3d2_tpu_torch.tools.modified_distribution",
        description=__doc__.splitlines()[0])
    ap.add_argument("workdir", help="run dir with PDG/, tables/, "
                                    "deltaf_coefficients/, input/surface.dat")
    ap.add_argument("--out", default="modified_distribution_results")
    ap.add_argument("--hrg-eos", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda or cpu (default: cuda; "
                         "fails when torch sees no CUDA device)")
    args = ap.parse_args(argv)
    run_matrix(args.workdir, args.out, args.hrg_eos, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
