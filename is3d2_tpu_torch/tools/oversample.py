"""Oversampling campaign: N sampling batches with distinct seeds, each into
its own OSCAR event files.

The port's counterpart of scripts/oversample.py (the reference's
scripts/oversample.sh and run_multithread_sampling_iS3D.py, which rerun
the whole binary N times).  One process reads the workdir once, estimates
the yield, then runs each batch b through the sampler on ``device`` (the
GPU unless the CPU is asked for) with the seed ``base_seed + 1000 b``
(``base_seed`` the workdir's sampler_seed, 0 where it is negative) and
writes its events to ``results/batch_<b>/particle_list_osc_<event>.dat``.
Each batch has ``--events-per-batch`` events, or the event count that
min_num_hadrons gives.  With the workdir's use_mesh giving a mesh
(parallel/sharding.py::auto_mesh), each batch's chunks are spread over
its devices (parallel/sampler_shard.py), with the same hadrons.

CLI:
    python -m is3d2_tpu_torch.tools.oversample <workdir> [--batches 4]
        [--events-per-batch N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def batch_seed(base_seed: int, b: int) -> int:
    return base_seed + 1000 * b


def run_campaign(workdir, batches: int = 4,
                 events_per_batch: int | None = None,
                 device=None) -> tuple[float, list[dict]]:
    """Run the campaign; returns the yield estimate per event and one dict
    per batch: its seed, events, kept hadrons, directory and seconds
    (sampling, and the OSCAR write)."""
    from ..config import Config
    from ..core.sampler import (compute_total_yield, number_of_events,
                                sample_particles, to_particle_list)
    from ..driver import IS3D
    from ..io import output

    workdir = Path(workdir)
    cfg = Config.from_file(workdir / "iS3D_parameters.dat")
    base_seed = cfg.sampler_seed if cfg.sampler_seed >= 0 else 0
    run = IS3D(workdir, cfg=cfg, device=device)
    run.load_surface_from_file()
    run._setup()
    args = (run.surface, run.species, run.chosen_idx, run.df_data, cfg,
            run.laguerre)

    Ntot = compute_total_yield(*args, run.device)
    n_events = events_per_batch or number_of_events(Ntot, cfg)
    print(f"yield estimate {Ntot:.1f}; {batches} batches x {n_events} events",
          flush=True)

    if run.mesh is None:
        def sample(n, seed):
            return sample_particles(*args, n, run.device, seed=seed)
    else:
        from ..parallel.sampler_shard import sample_particles_meshed

        def sample(n, seed):
            return sample_particles_meshed(*args, n, run.mesh, run.device,
                                           seed=seed)
    out = []
    for b in range(batches):
        seed = batch_seed(base_seed, b)
        t0 = time.perf_counter()
        plist = to_particle_list(sample(n_events, seed))
        t1 = time.perf_counter()
        batch_dir = workdir / "results" / f"batch_{b}"
        batch_dir.mkdir(parents=True, exist_ok=True)
        output.write_particle_list_oscar(batch_dir, plist, n_events)
        t2 = time.perf_counter()
        out.append({"batch": b, "seed": seed, "events": n_events,
                    "kept": int(plist.valid.sum()), "dir": batch_dir,
                    "sample_seconds": t1 - t0, "write_seconds": t2 - t1})
        print(f"batch {b}: {out[-1]['kept']} particles, {n_events} events, "
              f"sampled in {t1 - t0:.3f} s, written in {t2 - t1:.3f} s",
              flush=True)
    print(f"total sampled particles: {sum(r['kept'] for r in out)}")
    return Ntot, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="is3d2_tpu_torch.tools.oversample",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("workdir")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--events-per-batch", type=int, default=None,
                    help="override the min_num_hadrons-derived event count")
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda or cpu (default: cuda; "
                         "fails when torch sees no CUDA device)")
    args = ap.parse_args(argv)
    run_campaign(args.workdir, args.batches, args.events_per_batch,
                 args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
