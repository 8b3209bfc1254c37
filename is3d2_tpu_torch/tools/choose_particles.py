#!/usr/bin/env python
"""Switch the chosen-particles preset (parity with PDG/chosen_particles.sh).

The port's copy of is3d2_tpu/tools/choose_particles.py (pure Python; the
same files, byte for byte).  Run as
``python -m is3d2_tpu_torch.tools.choose_particles PRESET [--pdg-dir PDG]``.

Copies one of the bundled presets over PDG/chosen_particles.dat:
  pikp   : pi0, K+, p (3 species)
  urqmd  : all urqmd v3.3+ species
  smash  : all smash species
  box    : smash-box species
or writes an explicit list of MC IDs.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

PRESETS = {
    "pikp": "chosen_particles_pikp.dat",
    "urqmd": "chosen_particles_urqmd_v3.3+.dat",
    "smash": "chosen_particles_smash.dat",
    "box": "chosen_particles_box.dat",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("preset", help="pikp | urqmd | smash | box | "
                                   "comma-separated MC IDs")
    ap.add_argument("--pdg-dir", default="PDG")
    args = ap.parse_args(argv)

    pdg = Path(args.pdg_dir)
    target = pdg / "chosen_particles.dat"
    if args.preset in PRESETS:
        src = pdg / PRESETS[args.preset]
        shutil.copyfile(src, target)
        print(f"chosen_particles.dat <- {src.name}")
    else:
        mcids = [int(tok) for tok in args.preset.split(",")]
        target.write_text("\n".join(str(m) for m in mcids) + "\n")
        print(f"chosen_particles.dat <- {len(mcids)} explicit MC IDs")


if __name__ == "__main__":
    main()
