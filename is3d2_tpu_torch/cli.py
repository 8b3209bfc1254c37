"""Command-line entry point: ``python -m is3d2_tpu_torch [workdir]``.

Counterpart of is3d2_tpu/cli.py (the reference binary, Main.cpp:4-24):
reads <workdir>/iS3D_parameters.dat, <workdir>/input/surface.dat and the
data assets, then runs operation 0 (spacetime distributions), 1
(continuous spectra) or 2 (the hadron sampler).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="is3d2_tpu_torch",
                                 description="PyTorch/CUDA particlization")
    ap.add_argument("workdir", nargs="?", default=".",
                    help="run directory (default: cwd)")
    ap.add_argument("--data-dir", default=None,
                    help="directory holding PDG/, tables/, deltaf_coefficients/ "
                         "(default: workdir)")
    ap.add_argument("--params", default=None,
                    help="parameter file (default: <workdir>/iS3D_parameters.dat)")
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda or cpu (default: cuda; "
                         "fails when torch sees no CUDA device)")
    args = ap.parse_args(argv)

    from .config import Config
    from .driver import IS3D
    cfg = Config.from_file(args.params) if args.params else None
    run = IS3D(args.workdir, cfg=cfg, data_dir=args.data_dir,
               device=args.device)
    run.run_particlization()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
