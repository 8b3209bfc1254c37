"""Run one cell of the benchmark of is3d2_tpu_torch.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on one host thread (THREAD_VARS).  Set-up
builds the inputs from the seed, the program and its kernels (nvcc at a
checkout's first run, into the program's own build directory inside the
checkout) and warms up; the window then runs whole surfaces for
``--seconds``; the check compares what the window produced with the
plain reference.  Standard output ends with a line of the run's
conditions and the result's JSON line; standard error ends with each
number compared beside its limit.  The program's own log goes to
standard error.  Exits 2 without a result where torch sees no
CUDA device or fewer than the cell asks for, and exits 1 without a result
where, once the check and the readers have run, the process holds JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# The host libraries' thread pools, each held to one thread before numpy
# and torch load.  The program's host work per surface (the set-up, the
# invariants, the prep) is small; spread over one thread a core, each
# parallel region waits for its slowest thread, so where other work takes
# the host's cores a run slows by tens of percent, against a few with one.
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    for var in THREAD_VARS:
        os.environ[var] = "1"

    from portbench.harness import manifest

    bench = manifest.load(ROOT)
    wl = manifest.workload(bench, args.workload)
    import torch
    torch.set_num_threads(1)

    from portbench.harness import cell
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    out = sys.stdout
    sys.stdout = sys.stderr          # the program's log
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, bench=bench)
    conditions = result.pop("_conditions")
    sys.stdout = out
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print("portbench conditions: " + json.dumps(conditions), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
