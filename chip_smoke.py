"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises; nothing is caught):
  1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
     fails without a CUDA device;
  2. build the four kernels with nvcc (sm_90a), one nvcc per source,
     started together, and print ptxas' registers, static shared memory and
     spills of each (the most over a source's instantiations, and the
     instantiation its main path launches);
  3. kernel B1 (compensated, df 1/2) vs its plain torch version and the
     port's f64 engine at a reduced shape (2048 cells, 16 species, 51 pT x
     48 phi, 24 eta) for df 1 and df 2 with the clip/outflow/diffusion
     variants: <= 1e-6 relative on bins >= 1e-4 of each species' peak
     (is3d2_tpu_torch/tools/kernel_check); a ragged case against the
     plain version (kernel_check.RAGGED: rows of 7 phi under a register
     tile of 4, 105 momenta, 1000 cells); and df 1 on an eta table of 80
     nodes, not folded (kernel_check.ETA_NODES): three launches of at most
     32 nodes, held to the plain version and the f64 engine;
  4. kernel B3 (feqmod, df 3/4) vs its plain version (<= 1e-5) and the f64
     feqmod engine (<= 1e-4) at the same shape, on a surface with large
     viscous corrections (shear 0.2, bulk 0.1 of E + P) so that cells break
     down: df 3, df 4, df 3 with outflow + regulation, df 4 with
     regulation; the famod mode (df 5) vs its plain version (<= 1e-5) and
     the f64 famod engine (<= 1e-4) on the famod prep of an EOS-consistent
     surface (shear 0.1, bulk 0.05; kernel_check.FAMOD_SURFACE); the ragged
     case in df 4; and df 4 on the 80-node table;
  5. the df-1 main path at full size through the CLI: 1e5 cells, the full
     ~370-species list, 51 pT x 48 phi x 24 eta, f32c.  B1's launch count
     must move, the spectra must be finite and non-negative and dN/dy must
     order pi+ > K+ > p;
  6. B1 on the main path's own operands (102,400 padded cells x 12 eta x
     ~9.1e5 momenta, not a multiple of the block) timed at full size, and
     held to its plain version (<= 1e-6) on the first 16,384 cells at the
     full M, both timed there; two launches at full size must give equal
     bits;
  7. the df-4 main path at full size through the CLI: as phase 5 with df 4,
     f32, shear 0.2 and bulk 0.1: B3's launch count must move and cells
     must break down;
  8. B3 on the df-4 main path's operands, timed at full size, and held to
     its plain version (<= 1e-5) on the first 8,192 cells at the full S and
     M, both timed there; two launches at full size must give equal bits;
  9. kernel B2 (plain f32, df 1/2) vs its plain version (<= 1e-5) and the
     f64 engine (<= 2e-5) at phase 3's shape, over the cases of
     kernel_check.F32_CASES (compute_dtype f64, use_pallas 1); the ragged
     case in df 2; and df 2 on the 80-node table;
 10. the use_pallas = 1 main path at full size through the CLI: as phase 5
     with df 2 and compute_dtype f64.  B2's launch count must move and B1's
     and B3's must stay at 0;
 11. B2 on phase 10's operands, timed at full size, and held to its plain
     version (<= 1e-5) on the first 8,192 cells at the full M, both timed
     there; two launches at full size must give equal bits;
 12. the operation-2 histogram main path at full size through the CLI:
     phase 5's workdir (1e5 cells, all species, df 1) with test_sampler 1,
     fast 1, min_num_hadrons 1e7, max_num_samples 1000 and a fixed
     sampler_seed.  No kernel may launch; the kept yield must lie within
     0.05 Ntot + 5 sqrt(Ntot / n_events) of the estimate per event, drawn /
     kept below 2.7, no lane dropped, and the sampled dN/dy of pi+, K+ and
     p within 5 sigma + 1% of phase 5's op-1 dN_dy files.  Then the six
     phase functions on one full chunk, each timed with CUDA events, the
     chunk run twice with one seed (equal bits), and torch.poisson held to
     its mean and variance at the chunk's largest Poisson mean;
 13. the operation-2 OSCAR path at full size through the CLI: phase 7's
     df-4 workdir with test_sampler 0 and min_num_hadrons 1e7: one file per
     event with the OSCAR header and 11 columns, rows summing to the kept
     count, the yield bound of phase 12; it prints the write, transfer and
     overlapped seconds;
 14. the df-5 main path at full size through the CLI: 1e5 cells of an
     EOS-consistent surface (shear 0.1, bulk 0.05), all species, 51 x 48 x
     24, f32: the famod prep (the VAH reconstruction in f64 on the card)
     and B3's famod mode.  B3's launch count must move, B1's and B2's stay
     at 0, cells must break down; it prints the breakdown, pl < 0 and
     reconstruction-failure counts, the Newton iterations and the stage
     seconds with the famod prep split out;
 15. B3's famod mode on phase 14's operands, timed at full size, held to its
     plain version (<= 1e-5) on the first 8,192 cells at the full S and M;
     two launches at full size must give equal bits;
 16. operation 2 with df 5 on phase 14's workdir: test histograms, 1e7
     hadrons, a fixed seed, phase 12's bounds (yield, no dropped lane, equal
     bits from one seed, dN/dy of pi+, K+ and p within 5 sigma + 1% of an
     op-1 run of phase 14's surface on tables that resolve it: 96 eta nodes,
     pT to 6 GeV) and no kernel launch in the sampler;
 17. the grouped main path through the CLI: phase 5's surface written in
     mode 6 (public MUSIC), df 1, f32c, group_particles 1 (371 species ->
     94 representatives at tolerance 0.01).  Only B1 may launch; it prints
     M and B1's time on the representatives, and holds the grouped spectra
     to an ungrouped run of the same surface: <= 1e-12 on the species that
     share (mass, sign, baryon) with their representative, <= GROUP_BAR
     (the grouping's own error, measured with the JAX package) on all;
 18. operation 0 (dN/dX), df 1, f32c, on phase 5's surface through the
     CLI: B1 once per non-empty (tau, r, phi_s) bin, the launches timed one
     by one by CUDA events and summed; the files finite, the tau bins
     summed back to phase 5's dN/dy of pi+, K+ and p (<= 1e-5); B1 on the
     fullest bin's cells at the full M against its plain version
     (<= 1e-6); and at 2,048 cells the whole route against its plain
     version and the f64 engine (<= 1e-6 both);
 19. operation 0, df 4, f32, on a mode-6 surface with dsigma_eta / tau in
     +-0.05 (not folded: 24 eta nodes), shear 0.2, bulk 0.1: B3 in its
     dan-weighted variant once per bin, timed as in 18; B3 on the fullest
     bin that holds a breakdown cell against its plain version (<= 1e-5);
     at 2,048 cells (df 4, and df 3 with outflow, where the convention
     decides the number) the route against its plain version (<= 1e-5) and
     the f64 engine (<= 1e-4);
 20. kernel P1 (spin polarization, f32) vs its plain version (<= 1e-5 on
     both metrics) and the f64 polarization engine at the JAX package's
     bars for its f32 route (Snorm <= 2e-5 relative on bins >= 1e-6 of its
     max; P^mu = S^mu / Snorm within 1e-5 of max |P| where Snorm >= 1e-3
     of its max) at phase 3's shape on a surface with thermal vorticity;
     on the 80-node table (three launches); the ragged case;
 21. the mode-5 main path at full size through the CLI: phase 5's surface
     with thermal vorticity, written in mode 5, df 1, f32c.  B1 (the
     spectra) and P1 (the polarization) must both launch and no other
     kernel; the four files St, Sx, Sy, Sn hold S x 48 x 51 = 908,208
     finite rows each; it prints the stage seconds (polarization
     included);
 22. P1 on phase 21's operands (102,400 padded cells x 24 eta, not folded,
     x 908,208 momenta), timed at full size: evaluations/s and share of
     the bound; every sum finite and Snorm > 0; two launches give equal
     bits; held to its plain version (<= 1e-5 on both metrics) on the
     first 4,096 cells at the full M, both timed there.

Before the card's line, a JSON object {"sampler": {...}} carries phases
12-13's and 16's numbers.  The line before the last is a JSON object with each
kernel's measurements (phases 17-18 under B1's "grouped_mode6" and
"operation0", phase 19 under B3's "operation0", each with the launches of
its own path; P1's launches from phase 21),
its bound (the least time the card could take for the same work, from
BOUND_OPS_PER_EVALUATION and the bytes of its operands), library_ms null
(no single PyTorch call computes a Cooper-Frye or polarization sum), and
the register tile
and the cell split that the wrapper launched with at full size.  The bound
counts, per kernel, the fewer of the operations of its plain version
(OPS_PER_EVALUATION) and of the kernel itself
(EXECUTED_OPS_PER_EVALUATION); all three are printed on a line before it.
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MAIN_CELLS = 100_000
KERNELS = ("cooper_frye_comp", "cooper_frye_feqmod", "cooper_frye_f32",
           "polarization_f32")
B1_COMPARE_CELLS = 16_384
B2_COMPARE_CELLS = 8_192
B3_COMPARE_CELLS = 8_192
P1_COMPARE_CELLS = 4_096

# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

# Floating-point operations per (cell, eta, m) evaluation at the main paths'
# settings (shear and bulk delta-f; no diffusion, regulation or outflow),
# counted from the plain versions' arithmetic: each elementwise add,
# multiply, divide, exp, sqrt, clamp or f32 -> f64 conversion on a
# (cells, M) tensor counts one, and so does each term of the f64 sum; work
# outside the eta loop counts once per 12 eta nodes (24 for P1, which
# never folds); per-cell and per-momentum work is left out.  f64 operations
# count at the FP32 rate, so the bound stays a lower bound.  B3's kernel
# runs one branch per cell, so its two branches count apart.
OPS_PER_EVALUATION = {
    "cooper_frye_comp": 70 + 26 / 12,     # df 1
    "cooper_frye_f32": 34 + 12 / 12,      # df 2
    "cooper_frye_feqmod": {"modified": 30 + 9 / 12,    # df 4
                           "breakdown": 43 + 9 / 12,
                           # df 5: the modified branch is df 4's; the
                           # breakdown branch is plain f_eq (E 2, p.dsigma 3,
                           # f_eq 6, value 1, the sum 2; gd, exy and the
                           # per-cell sum 11 outside the loop)
                           "famod_modified": 30 + 9 / 12,
                           "famod_breakdown": 14 + 11 / 12},
    # the six contractions' mT parts 14, E and f0 6, w 2, g 5, the four
    # spin sums 4 each, Snorm 2; the px/py parts 14 and the per-cell mask,
    # conversion and f64 sum 15 outside the loop
    "polarization_f32": 45 + 29 / 24,
}
# What the kernels execute per evaluation, counted the same way from their
# sources (a multiply-add counts two; work shared by a thread's 4 momenta
# counts a quarter, work outside the eta loop a twelfth).
EXECUTED_OPS_PER_EVALUATION = {
    "cooper_frye_comp": 41 + 16 / 4 + 45 / 12,
    "cooper_frye_feqmod": {"modified": 23 + 5 / 4 + 16 / 12,
                           "breakdown": 31 + 4 / 4 + 14 / 12,
                           "famod_modified": 23 + 5 / 4 + 16 / 12,
                           # E 1, p.dsigma 2, f_eq 6, value 1, sum 1; EmT
                           # and pddb per row; gd, exy, the f64 add
                           "famod_breakdown": 11 + 2 / 4 + 9 / 12},
    "cooper_frye_f32": 30 + 21 / 4 + 20 / 12,    # df 2
    # E 1, E / T 1, exp 1, + sign 1, clamp 1, reciprocal 5, w 2, g 4, the
    # four spin sums 4 each, Snorm 2; per row m1, m4 and the mT parts 16;
    # the px/py parts 14 and the per-cell mask, conversion and f64 add 15
    "polarization_f32": 34 + 16 / 4 + 29 / 24,
}


def _fewer(a, b):
    if isinstance(a, dict):
        return {k: _fewer(a[k], b[k]) for k in a}
    return min(a, b)


# The bounds count the smaller of the two: a kernel that computes the
# function shows that the function needs no more operations than it does.
BOUND_OPS_PER_EVALUATION = {k: _fewer(OPS_PER_EVALUATION[k],
                                      EXECUTED_OPS_PER_EVALUATION[k])
                            for k in OPS_PER_EVALUATION}
PARITY_CHOSEN = (211, -211, 111, 321, -321, 311, 221, 2212, -2212, 2112,
                 3122, -3122, 3222, 3312, 213, 333)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, warmup=None):
    """Device time of one fn() call after one warm-up call of ``warmup``
    (default: fn), and that call's result."""
    (warmup or fn)()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def launch_counters():
    from is3d2_tpu_torch.ops.cooper_frye_comp import cooper_frye_comp
    from is3d2_tpu_torch.ops.cooper_frye_f32 import cooper_frye_f32
    from is3d2_tpu_torch.ops.cooper_frye_feqmod import cooper_frye_feqmod
    from is3d2_tpu_torch.ops.polarization_f32 import polarization_f32
    return {"cooper_frye_comp": cooper_frye_comp,
            "cooper_frye_feqmod": cooper_frye_feqmod,
            "cooper_frye_f32": cooper_frye_f32,
            "polarization_f32": polarization_f32}


def bound(ops: float, args: tuple, n_mom: int) -> dict:
    """The least time the card could take for one kernel call on ``args``:
    the larger of ``ops`` over the FP32 peak and the bytes (each operand
    read once, the (n_mom,) f64 output written once; P1 writes 5 M) over
    the memory rate."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor)) + 8 * n_mom
    ops_ms = ops / PEAK_FP32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_environment() -> str:
    print("== 1. environment")
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    print(sh(nvcc, "--version").splitlines()[-1])
    try:
        import triton
        print("triton", triton.__version__)
    except ImportError:
        print("triton: not importable")
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    print("card:", card)
    return card


def phase_build() -> None:
    print("== 2. build (one nvcc per source, in parallel)")
    from is3d2_tpu_torch.ops import _build
    from is3d2_tpu_torch.tools.kernel_check import MAIN_PATH_KERNEL
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, (path, compile_s) in built.items():
        _build.load(name)
        print(f"built {path.name}: nvcc {compile_s:.2f} s")
        usage = _build.resource_usage(path)
        kernels = {k: u for k, u in usage.items() if "add_partials" not in k}
        worst = {key: max(u.get(key, 0) for u in kernels.values())
                 for key in ("registers", "smem", "stack", "spill_stores",
                             "spill_loads")}
        print(f"  {len(kernels)} instantiation(s); the most over them: "
              f"{json.dumps(worst)}")
        for k, u in kernels.items():
            if re.search(MAIN_PATH_KERNEL[name], k):
                print(f"  main path's instantiation: {json.dumps(u)}")
    print(f"build+load {time.perf_counter() - t0:.2f} s")


def parity_workdirs(tmp: Path) -> tuple[Path, Path]:
    """The parity workdir, and a copy whose eta table has
    kernel_check.ETA_NODES nodes."""
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import (write_quadrature_tables,
                                                 write_workdir)
    wd = write_workdir(tmp / "compare", n_cells=16,
                       chosen_mcids=PARITY_CHOSEN, include_baryon=True,
                       n_muB=9)
    wd_eta = shutil.copytree(wd, tmp / "compare_eta")
    write_quadrature_tables(wd_eta, 51, 48, kc.ETA_NODES)
    return wd, wd_eta


def check_eta_chunks(r, chunk: int) -> None:
    """An ETA_NODES case: its bars, and one launch per chunk of eta."""
    from is3d2_tpu_torch.tools import kernel_check as kc
    chunks = -(-kc.ETA_NODES // chunk)
    print(f"{kc.ETA_NODES} eta nodes, not folded ({r.launches} launches) "
          f"kernel vs plain {r.vs_plain:.3e}  kernel vs f64 {r.vs_f64:.3e}  "
          f"max |kernel - plain| {np.abs(r.kernel - r.plain).max():.3e}")
    if not (r.ok and r.launches == chunks):
        raise AssertionError(f"{kc.ETA_NODES} eta nodes: kernel disagrees, "
                             f"does not repeat or launched {r.launches} "
                             f"times, not {chunks} ({r.vs_plain:.3e} vs "
                             f"plain, {r.vs_f64:.3e} vs f64)")


def phase_b1_compare(wd: Path, wd_eta: Path) -> None:
    print("== 3. B1 vs plain version vs f64 engine (2048 cells, 16 species, "
          "51 x 48, 24 eta)")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.tools import kernel_check as kc
    for name in kc.CASES:
        r = kc.check_case(wd, name, 2048, 7, "cuda")
        print(f"{name:22s} kernel vs plain {r.vs_plain:.3e}  kernel vs f64 "
              f"{r.vs_f64:.3e}  plain vs f64 {r.plain_vs_f64:.3e}  max |kernel"
              f" - plain| {np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees or does not "
                                 f"repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")
    r = kc.check_ragged_case(wd, 2048, 7, "cuda")
    print(f"{'ragged ' + json.dumps(kc.RAGGED):22s} kernel vs plain "
          f"{r.vs_plain:.3e}  max |kernel - plain| "
          f"{np.abs(r.kernel - r.plain).max():.3e}")
    if not (r.ok and r.launches == 1):
        raise AssertionError(f"B1 ragged case: kernel disagrees or does not "
                             f"repeat ({r.vs_plain:.3e} vs plain)")
    check_eta_chunks(kc.check_case(wd_eta, "df1", 2048, 7, "cuda",
                                   eta_fold=0), ck.ETA_CHUNK)


def phase_b3_compare(wd: Path, wd_eta: Path) -> None:
    print("== 4. B3 vs plain version vs f64 feqmod engine (2048 cells, "
          "16 species, 51 x 48, 24 eta; shear 0.2, bulk 0.1)")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    results = {name: kc.check_feqmod_case(wd, name, 2048, 7, "cuda")
               for name in kc.FEQMOD_CASES}
    results["famod (real prep)"] = kc.check_famod_case(wd, 2048, 7, "cuda",
                                                       cell_block=512)
    results["df4 ragged"] = kc.check_feqmod_ragged_case(wd, 2048, 7, "cuda")
    for name, r in results.items():
        print(f"{name:22s} breakdown cells {r.breakdown_cells:4d}  kernel vs "
              f"plain {r.vs_plain:.3e}  kernel vs f64 {r.vs_f64:.3e}  plain vs"
              f" f64 {r.plain_vs_f64:.3e}  max |kernel - plain| "
              f"{np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees, does not repeat "
                                 f"or no cell breaks down ({r.vs_plain:.3e} vs"
                                 f" plain, {r.vs_f64:.3e} vs f64, "
                                 f"{r.breakdown_cells} breakdowns)")
    check_eta_chunks(kc.check_feqmod_case(wd_eta, "df4", 2048, 7, "cuda",
                                          eta_fold=0), fk.ETA_CHUNK)


def run_main_path(tmp: Path, label: str, kernel: str, params: dict,
                  also: tuple = (), **surface_kw
                  ) -> tuple[dict, dict, Path, str]:
    """Write the full-size workdir and run the operation-1 CLI on it
    (run_cli: ``kernel`` and ``also`` launch, no other), then check its
    spectra files.  Returns every kernel's launches, the stage seconds,
    the workdir and the log."""
    from is3d2_tpu_torch.tools.synthetic import write_workdir

    t0 = time.perf_counter()
    wd = write_workdir(tmp / label, n_cells=MAIN_CELLS, params=params,
                       **surface_kw)
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, out = run_cli(wd, kernel, also)

    res = wd / "results/continuous"
    mcids = [int(v) for v in np.loadtxt(wd / "PDG/chosen_particles.dat")]
    for m in mcids:
        v = np.loadtxt(res / f"dN_pTdpTdphidy_{m}.dat", skiprows=1)[:, 3]
        if v.shape != (51 * 48,) or not np.isfinite(v).all() or (v < 0).any():
            raise AssertionError(f"spectra of {m}: bad shape, value or sign")
    dndy = {m: float(np.loadtxt(res / f"dN_dy_{m}.dat")[1])
            for m in (211, 321, 2212)}
    print(f"{len(mcids)} species; dN/dy pi+ {dndy[211]:.6g}  K+ "
          f"{dndy[321]:.6g}  p {dndy[2212]:.6g}")
    if not dndy[211] > dndy[321] > dndy[2212] > 0:
        raise AssertionError("dN/dy is not ordered pi+ > K+ > p")
    return launches, stages, wd, out


def run_cli(wd: Path, kernel: str, also: tuple = ()
            ) -> tuple[dict, dict, str]:
    """cli.main on a workdir with every launch count set to 0 just before
    and read just after.  Only ``kernel`` and the kernels ``also`` may
    launch, and each must.  Returns every kernel's launches, the driver's
    stage seconds and the log."""
    from is3d2_tpu_torch import cli
    counters = launch_counters()
    log = io.StringIO()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    out = log.getvalue()
    print(out, end="")
    print(f"cli.main returned {rc} after {wall:.2f} s; kernel launches "
          f"{launches}")
    ours = (kernel, *also)
    if rc != 0 or any(launches[k] < 1 for k in ours):
        raise AssertionError(f"the main path did not run through {ours}")
    if any(n for name, n in launches.items() if name not in ours):
        raise AssertionError(f"the {kernel} main path launched another kernel")
    stages = json.loads(re.search(r"^stage seconds: (.*)$", out,
                                  re.M).group(1))
    return launches, stages, out


def phase_b1_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 5. df-1 main path: {MAIN_CELLS} cells, all species, 51 x 48 "
          "x 24, f32c")
    launches, stages, wd, _ = run_main_path(
        tmp, "main_df1", "cooper_frye_comp",
        {"df_mode": 1, "compute_dtype": "f32c"})
    return launches["cooper_frye_comp"], stages, wd


def compare_on_cut(kernel, plain, few_args, cut_args, spectra_units, tol,
                   name):
    """Kernel and plain version on the cut operands, both timed; the plain
    version warms up on ``few_args``.  Returns (kernel ms, plain ms,
    max |kernel - plain| in spectra units)."""
    ms, out = cuda_ms(lambda: kernel(*cut_args))
    plain_ms, ref = cuda_ms(lambda: plain(*cut_args),
                            warmup=lambda: plain(*few_args))
    print(f"cut: kernel {ms:.1f} ms, plain version {plain_ms:.1f} ms "
          f"({plain_ms / ms:.1f}x the kernel)")
    kern = spectra_units(out)
    ref = spectra_units(ref)
    from is3d2_tpu_torch.tools import kernel_check as kc
    rel = kc.max_rel_err(kern, ref)
    max_abs = float(np.abs(kern - ref).max())
    print(f"kernel vs plain: max relative {rel:.3e} on bins >= {kc.FLOOR:g} "
          f"of peak, max |kernel - plain| {max_abs:.3e}")
    if not (np.isfinite(kern).all() and rel <= tol):
        raise AssertionError(f"{name} disagrees with its plain version on the "
                             f"main path's operands ({rel:.3e})")
    return ms, plain_ms, max_abs


def main_path_state(wd: Path, state_fn):
    """(cfg, engine state) of a main path, read back from its workdir."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.io.surface import read_surface

    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", cfg.mode, cfg.dimension,
                        bool(cfg.include_baryon))
    return cfg, state_fn(wd, cfg, surf, "cuda")


def time_on_main_path(name, kernel, plain, ops, args, cut, n_cut, state, tol,
                      ops_of, launched=None) -> dict:
    """Time ``kernel`` on the main path's operands ``args`` (``ops``), then
    hold it to its plain version on the first ``n_cut`` cells (``cut(n)``:
    the operands cut to n cells), both timed there.  ``ops_of(n)``: the
    operations on the first n cells, for the bounds.  ``launched()``: the
    grid geometry of the wrapper's latest launch, where it records one."""
    from is3d2_tpu_torch.tools import kernel_check as kc

    C, Ne, M = args[0].shape[0], ops.eta.shape[0], ops.mom.shape[1]
    print(f"{C} padded cells x {Ne} eta x {M} momenta (M mod 256 = "
          f"{M % 256}) = {ops.evaluations:.4g} evaluations")
    first = kernel(*args)
    full_ms, second = cuda_ms(lambda: kernel(*args), warmup=lambda: None)
    print(f"kernel at full size {full_ms:.1f} ms, "
          f"{ops.evaluations / full_ms * 1e3:.4g} evaluations/s")
    if not torch.equal(first, second):
        raise AssertionError(f"two launches of {name} on the main path's "
                             "operands gave different bits")
    print("two launches at full size gave equal bits")
    del first, second
    shape = {}
    if launched is not None:
        g = launched()
        print(f"launched with {g}")
        shape = {"register_tile": g.r, "cell_split": g.n_split}
    print(f"compared on the first {n_cut} cells at the full M")
    ms, plain_ms, max_abs = compare_on_cut(
        kernel, plain, cut(64), cut(n_cut),
        lambda flat: kc.spectra_units(state, flat), tol, name)
    main_bound = bound(ops_of(C), args, M)["bound_ms"]
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / full_ms:.1f} % of it")
    return {**shape, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(ops_of(n_cut), cut(n_cut), M),
            "main_path_bound_ms": main_bound,
            "main_path_evaluations_per_s": ops.evaluations / full_ms * 1e3,
            "main_path_share_of_bound": main_bound / full_ms,
            # no single PyTorch call computes a Cooper-Frye sum
            "library_ms": None,
            "cells_compared": n_cut, "main_path_ms": full_ms,
            "main_path_evaluations": ops.evaluations}


def phase_b1_full(wd: Path, stages: dict) -> dict:
    print("== 6. B1 on the df-1 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops.spectra_fast_common import comp_operands
    from is3d2_tpu_torch.tools import kernel_check as kc

    print(f"driver stage seconds: {json.dumps(stages)}")
    cfg, state = main_path_state(wd, kc.engine_state)
    ops = comp_operands(*state, cfg)
    args = (*ops.args(), cfg)
    per_cell = (BOUND_OPS_PER_EVALUATION["cooper_frye_comp"] * ops.evaluations
                / ops.cell.shape[0])
    return time_on_main_path(
        "B1", functools.partial(ck.cooper_frye_comp, row_len=ops.row_len),
        ck.cooper_frye_comp_plain, ops, args,
        lambda n: (ops.cell[:n].contiguous(), ops.qm[:n].contiguous(),
                   *args[2:]),
        B1_COMPARE_CELLS, state, kc.TOL, lambda n: per_cell * n,
        lambda: ck.cooper_frye_comp.last_geometry)


def phase_b3_main_path(tmp: Path) -> tuple[int, dict, Path]:
    from is3d2_tpu_torch.tools import kernel_check as kc
    print(f"== 7. df-4 main path: {MAIN_CELLS} cells, all species, 51 x 48 "
          "x 24, f32, shear 0.2, bulk 0.1")
    launches, stages, wd, out = run_main_path(
        tmp, "main_df4", "cooper_frye_feqmod",
        {"df_mode": 4, "compute_dtype": "f32"}, **kc.FEQMOD_SURFACE)
    n_break = int(re.search(r"^feqmod breaks down for (\d+) /", out,
                            re.M).group(1))
    print(f"breakdown cells: {n_break}")
    if n_break < 1:
        raise AssertionError("no cell of the df-4 main path broke down")
    print(f"stage seconds: {json.dumps(stages)}")
    return launches["cooper_frye_feqmod"], stages, wd


def phase_b3_full(wd: Path) -> dict:
    print("== 8. B3 on the df-4 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.feqmod_engine_state)
    ops = fk.feqmod_operands(*state, cfg)
    n_break = int((state[1].breaks_down[:B3_COMPARE_CELLS]
                   & (state[0].mask[:B3_COMPARE_CELLS] > 0)).sum().item())
    print(f"{kc.breakdown_cells(state)} breakdown cells, {n_break} of them "
          f"among the first {B3_COMPARE_CELLS}")
    if n_break < 1:
        raise AssertionError("no breakdown cell among the compared cells")
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod"]
    per_cell = ops.evaluations / ops.cols.shape[0]

    def b3_ops(n):
        """Operations on the first n operand cells: the kernel runs the
        breakdown branch on the cells whose BREAKS column is set."""
        n_b = int((ops.cols[:n, fk.BREAKS] != 0).sum().item())
        return per_cell * (n_b * per_eval["breakdown"]
                           + (n - n_b) * per_eval["modified"])

    return time_on_main_path(
        "B3", functools.partial(fk.cooper_frye_feqmod, row_len=ops.row_len),
        fk.cooper_frye_feqmod_plain, ops, (*ops.args(), cfg, ops.kind),
        lambda n: (ops.cols[:n].contiguous(), ops.mom,
                   ops.renorm[:n].contiguous(), ops.red[:n].contiguous(),
                   ops.eta, ops.n_per_species, cfg, ops.kind),
        B3_COMPARE_CELLS, state, kc.FEQMOD_TOL_PLAIN, b3_ops,
        lambda: fk.cooper_frye_feqmod.last_geometry.grid)


def phase_b2_compare(wd: Path, wd_eta: Path) -> None:
    print("== 9. B2 vs plain version vs f64 engine (2048 cells, 16 species, "
          "51 x 48, 24 eta; f64, use_pallas 1)")
    from is3d2_tpu_torch.ops import cooper_frye_f32 as b2
    from is3d2_tpu_torch.tools import kernel_check as kc
    for name in kc.F32_CASES:
        r = kc.check_f32_case(wd, name, 2048, 7, "cuda")
        print(f"{name:22s} kernel vs plain {r.vs_plain:.3e}  kernel vs f64 "
              f"{r.vs_f64:.3e}  plain vs f64 {r.plain_vs_f64:.3e}  max |kernel"
              f" - plain| {np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees or does not "
                                 f"repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")
    r = kc.check_f32_ragged_case(wd, 2048, 7, "cuda")
    print(f"{'ragged ' + json.dumps(kc.RAGGED):22s} kernel vs plain "
          f"{r.vs_plain:.3e}  max |kernel - plain| "
          f"{np.abs(r.kernel - r.plain).max():.3e}")
    if not (r.ok and r.launches == 1):
        raise AssertionError(f"B2 ragged case: kernel disagrees or does not "
                             f"repeat ({r.vs_plain:.3e} vs plain)")
    check_eta_chunks(kc.check_f32_case(wd_eta, "df2", 2048, 7, "cuda",
                                       eta_fold=0), b2.ETA_CHUNK)


def phase_b2_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 10. use_pallas = 1 main path: {MAIN_CELLS} cells, all species, "
          "51 x 48 x 24, df 2, f64")
    launches, stages, wd, _ = run_main_path(
        tmp, "main_df2_pallas", "cooper_frye_f32",
        {"df_mode": 2, "compute_dtype": "f64", "use_pallas": 1})
    print(f"stage seconds: {json.dumps(stages)}")
    return launches["cooper_frye_f32"], stages, wd


def phase_b2_full(wd: Path) -> dict:
    print("== 11. B2 on the use_pallas = 1 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_f32 as b2
    from is3d2_tpu_torch.ops.spectra_fast_common import f32_operands
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.engine_state)
    ops = f32_operands(*state, cfg)
    args = (*ops.args(), cfg)
    per_cell = (BOUND_OPS_PER_EVALUATION["cooper_frye_f32"] * ops.evaluations
                / ops.cell.shape[0])
    return time_on_main_path(
        "B2", functools.partial(b2.cooper_frye_f32, row_len=ops.row_len),
        b2.cooper_frye_f32_plain, ops, args,
        lambda n: (ops.cell[:n].contiguous(), *args[1:]),
        B2_COMPARE_CELLS, state, kc.F32_TOL_PLAIN, lambda n: per_cell * n,
        lambda: b2.cooper_frye_f32.last_geometry)


SAMPLER_SEED = 20261017
# cuRAND's Poisson draw takes a normal approximation above this mean
CURAND_POISSON_NORMAL = 4000.0


def derived_workdir(tmp: Path, src: Path, label: str, params: dict) -> Path:
    """A copy of a main path's workdir (no results) with its parameters
    updated, e.g. to an operation-2 or operation-0 run."""
    wd = shutil.copytree(src, tmp / label,
                         ignore=shutil.ignore_patterns("results"))
    p = wd / "iS3D_parameters.dat"
    kv = dict(line.split(" = ", 1) for line in p.read_text().splitlines())
    kv.update({k: str(v) for k, v in params.items()})
    p.write_text("".join(f"{k} = {v}\n" for k, v in kv.items()))
    return wd


def run_op2(wd: Path) -> dict:
    """cli.main on an operation-2 workdir with every kernel's launch count
    set to 0 just before and read just after (operation 2 launches none);
    returns what its log says."""
    from is3d2_tpu_torch import cli
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    out = log.getvalue()
    print(out, end="")
    print(f"cli.main returned {rc} after {wall:.2f} s; kernel launches "
          f"{launches}")
    if rc != 0 or any(launches.values()):
        raise AssertionError("the operation-2 path failed or launched a "
                             "Cooper-Frye kernel")
    m = re.search(r"Estimated total particle yield = (\d+) particles; "
                  r"sampling (\d+) events", out, re.M)
    k = re.search(r"sampled hadrons: (\d+) kept / (\d+) drawn", out)
    r = {"wall_s": wall, "Ntot": int(m.group(1)), "n_events": int(m.group(2)),
         "kept": int(k.group(1)), "drawn": int(k.group(2)),
         "stage_seconds": json.loads(re.search(r"^stage seconds: (.*)$", out,
                                               re.M).group(1)),
         "momentum_efficiency_pct": float(re.search(
             r"Momentum sampling efficiency = ([0-9.]+) %", out).group(1)),
         "syncs_per_chunk": float(re.search(
             r"([0-9.]+) device syncs per chunk", out).group(1)),
         "chunks": int(re.search(r"sampler: (\d+) chunk", out).group(1)),
         "dropped_lanes": 0}
    d = re.search(r"WARNING: (\d+) hadron lanes", out)
    if d:
        r["dropped_lanes"] = int(d.group(1))
    comp = r["stage_seconds"]["compute"]
    r.update(drawn_per_kept=r["drawn"] / r["kept"],
             kept_per_s=r["kept"] / comp, drawn_per_s=r["drawn"] / comp)
    print(f"kept {r['kept']} / drawn {r['drawn']} (drawn/kept "
          f"{r['drawn_per_kept']:.4f}) over {r['n_events']} events in "
          f"{r['chunks']} chunks; {r['kept_per_s']:.4g} kept and "
          f"{r['drawn_per_s']:.4g} drawn hadrons per second of compute; "
          f"momentum efficiency {r['momentum_efficiency_pct']:.4f} %; "
          f"{r['syncs_per_chunk']} syncs per chunk")
    Ntot, n = r["Ntot"], r["n_events"]
    per_event = r["kept"] / n
    bar = 0.05 * Ntot + 5.0 * np.sqrt(Ntot / n)
    print(f"kept per event {per_event:.2f} vs the estimate Ntot = {Ntot} "
          f"(bar {bar:.2f})")
    if abs(per_event - Ntot) >= bar:
        raise AssertionError("kept yield outside the estimate's bound")
    if r["dropped_lanes"]:
        raise AssertionError(f"{r['dropped_lanes']} lanes were dropped")
    return r


def phase_timings(wd: Path) -> dict:
    """The six phase functions on one full chunk of the workdir's campaign,
    each timed with CUDA events; a warm-up chunk first, then the timed
    chunk and a repeat with the same seed, which must give equal bits.
    Also checks torch.poisson on the card at the chunk's largest mean."""
    from is3d2_tpu_torch.core import sampler as ps
    from is3d2_tpu_torch.driver import IS3D
    run = IS3D(wd, device="cuda")
    run.load_surface_from_file()
    run._setup()
    setup, species, _ = ps.prepare_setup(
        run.surface, run.species, run.chosen_idx, run.df_data, run.cfg,
        run.laguerre, run.device)
    camp = ps.prepare_campaign(setup, species,
                               run.species.mc_id[run.chosen_idx], run.cfg)
    Ntot = ps.compute_total_yield(run.surface, run.species, run.chosen_idx,
                                  run.df_data, run.cfg, run.laguerre,
                                  run.device)
    n_ev = ps.chunk_plan(camp.mean_1ev, ps.number_of_events(Ntot, run.cfg),
                         run.cfg)
    lam_max = float(camp.lam_1ev.max()) * n_ev
    print(f"one full chunk: {n_ev} events, mean {camp.mean_1ev * n_ev:.4g} "
          f"drawn lanes, largest Poisson mean per cell {lam_max:.1f}")
    lam = torch.full((4_000_000,), lam_max, dtype=torch.float64, device="cuda")
    draws = torch.poisson(lam, generator=ps.chunk_generator(1, 0, "cuda"))
    mean, var = float(draws.mean()), float(draws.var())
    sig = np.sqrt(lam_max / draws.numel())
    print(f"torch.poisson at that mean: mean {mean:.4f} var {var:.4f} "
          f"(mean's sigma {sig:.4f}; cuRAND's normal approximation starts "
          f"above {CURAND_POISSON_NORMAL:g})")
    if abs(mean - lam_max) > 5 * sig or abs(var / lam_max - 1.0) > 0.01:
        raise AssertionError("torch.poisson on the card is off at the "
                             "chunk's largest mean")
    del lam, draws

    def chunk(seed, marks=None):
        stats = ps.ChunkStats()
        out = ps.sample_chunk(camp, n_ev, 0,
                              ps.chunk_generator(seed, 0, "cuda"), stats,
                              mark=marks)
        torch.cuda.synchronize()
        return out, stats

    chunk(SAMPLER_SEED + 1)
    events = [torch.cuda.Event(enable_timing=True)]
    names = []

    def mark(phase):
        names.append(phase)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    t0 = time.perf_counter()
    events[0].record()
    a, stats = chunk(SAMPLER_SEED, mark)
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {n: events[i].elapsed_time(events[i + 1])
          for i, n in enumerate(names)}
    print(f"phase ms on one chunk ({stats.drawn} drawn, {stats.kept} kept, "
          f"{stats.syncs} syncs): {json.dumps(ms)}; sum "
          f"{sum(ms.values()):.1f} ms, host wall {wall_ms:.1f} ms")
    b, _ = chunk(SAMPLER_SEED)
    same = all(torch.equal(a[k], b[k]) for k in a
               if isinstance(a[k], torch.Tensor))
    if not same:
        raise AssertionError("one chunk run twice with one seed gave "
                             "different bits")
    print("one chunk run twice with one seed gave equal bits")
    return {"phase_ms": ms, "chunk_events": n_ev, "chunk_drawn": stats.drawn,
            "chunk_kept": stats.kept, "chunk_syncs": stats.syncs,
            "chunk_wall_ms": wall_ms, "largest_poisson_mean": lam_max}


def phase_sampler_histograms(tmp: Path, wd1: Path) -> dict:
    print(f"== 12. op-2 histogram main path: {MAIN_CELLS} cells, all "
          "species, df 1, test_sampler 1, fast 1, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd1, "op2_hist", {
        "operation": 2, "test_sampler": 1, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    if r["drawn_per_kept"] >= 2.7:
        raise AssertionError("drawn/kept >= 2.7: the tilted envelope is off")
    # (outflow and regulation off in phase 5; they move dN/dy by ~5e-4 here)
    r["closure"] = dndy_closure(wd, wd1, r["n_events"])
    r.update(phase_timings(wd))
    return r


def dndy_closure(wd: Path, wd_op1: Path, n_events: int) -> dict:
    """The sampled dN/dy of pi+, K+ and p (the test histograms of ``wd``)
    against the op-1 dN_dy files of ``wd_op1``: within 5 sigma + 1%."""
    from is3d2_tpu_torch.config import Config
    norm = 2.0 * Config.from_file(wd / "iS3D_parameters.dat").y_cut * n_events
    closure = {}
    for m in (211, 321, 2212):
        smooth = float(np.loadtxt(
            wd_op1 / f"results/continuous/dN_dy_{m}.dat")[1])
        avg = float(np.loadtxt(
            wd / f"results/sampled/dN_dy/dN_dy_{m}_average_test.dat"))
        n = avg * norm
        sigma = np.sqrt(max(n, 1.0)) / norm
        closure[str(m)] = {"sampled": avg, "smooth": smooth, "sigma": sigma}
        print(f"dN/dy {m}: sampled {avg:.6g} (sigma {sigma:.3g}) vs op-1 "
              f"{smooth:.6g}: {(avg - smooth) / smooth:+.3e} relative")
        if abs(avg - smooth) >= 5.0 * sigma + 0.01 * smooth:
            raise AssertionError(f"dN/dy closure of {m} fails")
    return closure


def phase_sampler_oscar(tmp: Path, wd4: Path) -> dict:
    print(f"== 13. op-2 OSCAR path: {MAIN_CELLS} cells, all species, df 4 "
          "(shear 0.2, bulk 0.1), test_sampler 0, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd4, "op2_oscar", {
        "operation": 2, "test_sampler": 0, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    files = sorted((wd / "results").glob("particle_list_osc_*.dat"))
    if len(files) != r["n_events"]:
        raise AssertionError(f"{len(files)} OSCAR files for "
                             f"{r['n_events']} events")
    t0 = time.perf_counter()
    rows = 0
    for f in files:
        data = f.read_bytes()
        head, _, body = data.partition(b"\n")
        if head != b"n pid px py pz E m x y z t":
            raise AssertionError(f"{f.name}: header {head!r}")
        first = body.split(b"\n", 1)[0].split()
        if len(first) != 11:
            raise AssertionError(f"{f.name}: {len(first)} columns")
        rows += body.count(b"\n")
    print(f"{len(files)} files, {rows} rows, "
          f"{sum(f.stat().st_size for f in files) / 1e9:.3f} GB "
          f"(counted in {time.perf_counter() - t0:.1f} s)")
    if rows != r["kept"]:
        raise AssertionError(f"{rows} OSCAR rows, {r['kept']} kept")
    st = r["stage_seconds"]
    print(f"write {st['write']:.3f} s (of it {st['write_boost']:.3f} s the "
          f"host boost, {st['write_overlapped']:.3f} s overlapped with "
          f"compute; {st['write_exposed']:.3f} s exposed after compute), "
          f"waiting for device->host copies "
          f"{st['write_transfer']:.3f} s")
    r["oscar_rows"] = rows
    return r


def phase_famod_main_path(tmp: Path) -> tuple[int, dict, Path, dict]:
    from is3d2_tpu_torch.tools import kernel_check as kc
    print(f"== 14. df-5 main path: {MAIN_CELLS} cells (EOS-consistent), all "
          "species, 51 x 48 x 24, f32, shear 0.1, bulk 0.05")
    launches, stages, wd, out = run_main_path(
        tmp, "main_df5", "cooper_frye_feqmod",
        {"df_mode": 5, "compute_dtype": "f32"}, eos_consistent=True,
        device="cuda", **kc.FAMOD_SURFACE)

    def count(pattern):
        return int(re.search(pattern, out, re.M).group(1))

    info = {"breakdown_cells": count(r"^famod breaks down for (\d+) /"),
            "pl_negative_cells": count(r"^pl went negative for (\d+) /"),
            "reconstruction_failures": count(
                r"^Number of reconstruction failures = (\d+)"),
            "newton_iterations": count(r"(\d+) Newton iterations"),
            "stage_seconds": stages}
    print(f"famod: {json.dumps(info)}")
    if info["breakdown_cells"] < 1:
        raise AssertionError("no cell of the df-5 main path broke down")
    return launches["cooper_frye_feqmod"], stages, wd, info


def phase_famod_full(wd: Path) -> dict:
    print("== 15. B3's famod mode on the df-5 main path's operands")
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.famod_engine_state)
    ops = fk.famod_operands(*state, cfg)
    n_break = int((state[1].breaks_down[:B3_COMPARE_CELLS]
                   & (state[0].mask[:B3_COMPARE_CELLS] > 0)).sum().item())
    print(f"{kc.breakdown_cells(state)} breakdown cells, {n_break} of them "
          f"among the first {B3_COMPARE_CELLS}")
    if n_break < 1:
        raise AssertionError("no breakdown cell among the compared cells")
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod"]
    per_cell = ops.evaluations / ops.cols.shape[0]

    def famod_ops(n):
        """Operations on the first n operand cells, by the branch each
        cell takes."""
        n_b = int((ops.cols[:n, fk.BREAKS] != 0).sum().item())
        return per_cell * (n_b * per_eval["famod_breakdown"]
                           + (n - n_b) * per_eval["famod_modified"])

    return time_on_main_path(
        "B3 famod", functools.partial(fk.cooper_frye_feqmod,
                                      row_len=ops.row_len),
        fk.cooper_frye_feqmod_plain, ops, (*ops.args(), cfg, ops.kind),
        lambda n: (ops.cols[:n].contiguous(), ops.mom,
                   ops.renorm[:n].contiguous(), ops.red[:n].contiguous(),
                   ops.eta, ops.n_per_species, cfg, ops.kind),
        B3_COMPARE_CELLS, state, kc.FEQMOD_TOL_PLAIN, famod_ops,
        lambda: fk.cooper_frye_feqmod.last_geometry.grid)


def phase_famod_sampler(tmp: Path, wd5: Path) -> dict:
    print(f"== 16. op-2 df-5 histograms: phase 14's {MAIN_CELLS} cells, all "
          "species, test_sampler 1, min_num_hadrons 1e7")
    wd = derived_workdir(tmp, wd5, "op2_df5", {
        "operation": 2, "test_sampler": 1, "fast": 1,
        "min_num_hadrons": 1.0e7, "max_num_samples": 1000,
        "sampler_seed": SAMPLER_SEED})
    r = run_op2(wd)
    r["closure"] = dndy_closure(wd, famod_reference(tmp, wd5), r["n_events"])
    r.update(phase_timings(wd))
    return r


def famod_reference(tmp: Path, wd5: Path) -> Path:
    """Phase 14's surface through the op-1 CLI (B3's famod mode) on tables
    that resolve dN/dy: pi+, K+ and p, 96 eta nodes (48 folded) and 64 pT
    up to 6 GeV.  Phase 14's north-star tables (24 eta nodes, pT <= 3 GeV)
    leave protons a few percent low (the 24 nodes ~1.6 %, the pT cut ~2 %
    on this flow), which the sampler, drawing every momentum, does not."""
    from is3d2_tpu_torch import cli
    from is3d2_tpu_torch.tools.synthetic import write_quadrature_tables
    wd = shutil.copytree(wd5, tmp / "main_df5_fine",
                         ignore=shutil.ignore_patterns("results"))
    write_quadrature_tables(wd, 64, 48, 96, pT_max=6.0)
    (wd / "PDG/chosen_particles.dat").write_text("211\n321\n2212\n")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    stages = re.search(r"^stage seconds: (.*)$", log.getvalue(), re.M)
    print(f"op-1 reference (pi+ K+ p, 96 eta, 64 pT to 6 GeV): rc {rc}, "
          f"stage seconds {stages.group(1)}")
    if rc != 0:
        raise AssertionError("the op-1 reference run failed")
    return wd


# The grouping's own error: grouped against ungrouped spectra, the max
# relative error over the species on bins >= 1e-4 of each species' peak.
# The JAX package's group_particles gives 0.0709 on the synthetic list's
# surface (512 cells) at particle_diff_tolerance 0.01, from eta' grouped
# with a radial eta excitation 9.9 MeV below it (CPU; tests/
# test_torch_group.py::test_the_grouping_bar_of_the_chip_check prints it,
# holds the port's error to the JAX package's and both under this bar).
GROUP_BAR = 0.075
GROUP_BAR_SOURCE = ("the JAX package's grouping error on this list, "
                    "0.0709 at 512 cells on the CPU")


def phase_grouped_main_path(tmp: Path) -> dict:
    print(f"== 17. mode-6 grouped main path: {MAIN_CELLS} cells written in "
          "mode 6, all species, 51 x 48 x 24, df 1, f32c, group_particles 1")
    from is3d2_tpu_torch.core.spectra import compute_spectra, df12_state
    from is3d2_tpu_torch.driver import IS3D
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops.spectra_fast_common import comp_operands
    from is3d2_tpu_torch.tools import kernel_check as kc
    launches, stages, wd, _ = run_main_path(
        tmp, "main_mode6_grouped", "cooper_frye_comp",
        {"df_mode": 1, "compute_dtype": "f32c", "group_particles": 1},
        surface_mode=6)
    print(f"stage seconds: {json.dumps(stages)}")
    run = IS3D(wd, device="cuda")
    run.load_surface_from_file()
    run._setup()
    cfg, idx, table = run.cfg, run.chosen_idx, run.species
    rep, group_of = table.group_species(idx, cfg.particle_diff_tolerance,
                                        bool(cfg.include_baryon))
    state = df12_state(run.surface, table, idx[rep], run.grids, run.df_data,
                       cfg, "cuda")
    ops = comp_operands(*state, cfg)
    args = (*ops.args(), cfg)
    ms, _ = cuda_ms(lambda: ck.cooper_frye_comp(*args, row_len=ops.row_len))
    geometry = ck.cooper_frye_comp.last_geometry
    M = ops.mom.shape[1]
    per_species = M // len(rep)
    print(f"{len(idx)} species -> {len(rep)} representatives: M "
          f"{len(idx) * per_species} -> {M}; B1 {ms:.1f} ms "
          f"({ops.evaluations / ms * 1e3:.4g} evaluations/s), launched with "
          f"{geometry}")
    surf = (run.surface, table, idx, run.grids, run.df_data)
    grouped = compute_spectra(*surf, cfg, "cuda")
    plain = compute_spectra(*surf, dataclasses.replace(cfg,
                                                       group_particles=0),
                            "cuda")
    key = np.stack([table.mass, table.sign, table.baryon], axis=1)
    exact = [i for i in range(len(idx))
             if (key[idx[i]] == key[idx[rep[group_of[i]]]]).all()]
    exact_err = kc.max_rel_err(grouped[exact], plain[exact])
    errs = np.array([kc.max_rel_err(grouped[i:i + 1], plain[i:i + 1])
                     for i in range(len(idx))])
    worst = int(np.argmax(errs))
    print(f"{len(exact)} species share (mass, sign, baryon) with their "
          f"representative: grouped vs ungrouped {exact_err:.3e} (bar "
          f"1e-12); every species: max {errs[worst]:.4e} "
          f"({int(table.mc_id[idx[worst]])}), median {np.median(errs):.4e}; "
          f"bar {GROUP_BAR:.4e}, {GROUP_BAR_SOURCE}")
    if not (np.isfinite(grouped).all() and exact_err <= 1e-12
            and errs.max() <= GROUP_BAR):
        raise AssertionError("the grouped main path is off its ungrouped "
                             "run beyond the grouping's bar")
    bnd = bound(BOUND_OPS_PER_EVALUATION["cooper_frye_comp"]
                * ops.evaluations, args, M)
    return {"launches": launches["cooper_frye_comp"],
            "stage_seconds": stages,
            "species": len(idx), "representatives": len(rep), "momenta": M,
            "ms": ms, "evaluations": ops.evaluations, **bnd,
            "exact_multiplets": len(exact), "exact_max_rel_err": exact_err,
            "max_grouping_err": float(errs.max()),
            "cell_split": geometry.n_split}


def dX_main_path_timing(wd: Path, state_fn, kernel, ops_of) -> dict:
    """The operation-0 kernel route on a main path's state, each launch
    timed by CUDA events: the summed kernel ms, the launches, the
    evaluations, the bound (``ops_of(slice operands)``: the operations of
    one launch) and the host wall of the whole route."""
    from is3d2_tpu_torch.core import spacetime
    cfg, state = main_path_state(wd, state_fn)
    ops = spacetime.kernel_operands(*state, cfg)
    events, work = [], {"evaluations": 0, "ops": 0.0, "bytes": 0}

    def timed(o, c):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = spacetime.run_kernel(o, c)
        end.record()
        events.append((start, end))
        work["evaluations"] += o.evaluations
        work["ops"] += ops_of(o)
        work["bytes"] += sum(a.numel() * a.element_size() for a in o.args()
                             if isinstance(a, torch.Tensor)) \
            + 8 * o.mom.shape[1]
        return out

    before = kernel.launches
    t0 = time.perf_counter()
    spacetime.kernel_bins(state[0], ops, *state[2:], cfg, timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = sum(a.elapsed_time(b) for a, b in events)
    ops_ms = work["ops"] / PEAK_FP32_OPS * 1e3
    bytes_ms = work["bytes"] / PEAK_BYTES * 1e3
    print(f"kernel route: {kernel.launches - before} launches, "
          f"{work['evaluations']:.4g} evaluations, kernel {ms:.1f} ms summed "
          f"({work['evaluations'] / ms * 1e3:.4g} evaluations/s), host wall "
          f"{wall * 1e3:.1f} ms; bound {max(ops_ms, bytes_ms):.1f} ms "
          f"({100 * max(ops_ms, bytes_ms) / ms:.1f} %)")
    return {"main_path_ms": ms, "main_path_launches": len(events),
            "main_path_evaluations": work["evaluations"],
            "main_path_wall_ms": wall * 1e3,
            "main_path_bound_ms": max(ops_ms, bytes_ms),
            "main_path_evaluations_per_s": work["evaluations"] / ms * 1e3,
            "state": (cfg, state, ops)}


def dX_bin_vs_plain(name, cfg, state, ops, tol, ops_of,
                    min_breakdown=0) -> dict:
    """The kernel and its plain version on the cells of the fullest tau bin
    (with at least ``min_breakdown`` breakdown cells, for B3), both timed;
    ``ops_of(operands)``: the operations of one launch, for the bound."""
    from is3d2_tpu_torch.core import spacetime
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    cells = state[0]
    idx, n = spacetime.bin_indices(cells, cfg)[0]
    rows, runs = spacetime.binned_cells(idx, n, cells.mask.cpu().numpy())
    sorted_ops = spacetime.cell_rows(ops, torch.as_tensor(rows,
                                                          device="cuda"))
    breaks = None if not hasattr(ops, "cols") else \
        (sorted_ops.cols[:, fk.BREAKS] != 0).cpu().numpy()
    best = None
    for b, begin, end in sorted(runs, key=lambda r: r[1] - r[2]):
        if breaks is None or breaks[begin:end].sum() >= min_breakdown:
            best = (b, begin, end)
            break
    if best is None:
        raise AssertionError(f"{name}: no bin holds a breakdown cell")
    b, begin, end = best
    one = spacetime.cell_rows(sorted_ops, slice(begin, end))
    n_break = 0 if breaks is None else int(breaks[begin:end].sum())
    ms, out = cuda_ms(lambda: spacetime.run_kernel(one, cfg))
    plain_ms, ref = cuda_ms(
        lambda: spacetime.run_kernel(one, cfg, plain=True),
        warmup=lambda: spacetime.run_kernel(
            spacetime.cell_rows(one, slice(0, 4)), cfg, plain=True))
    S = state[2].mass.shape[0]
    kern = out.reshape(S, -1).cpu().numpy()
    plain = ref.reshape(S, -1).cpu().numpy()
    rel = kc.max_rel_err(kern, plain)
    max_abs = float(np.abs(kc.spectra_units(state, out)
                           - kc.spectra_units(state, ref)).max())
    print(f"tau bin {b}: {end - begin} cells ({n_break} breakdown): kernel "
          f"{ms:.1f} ms, plain {plain_ms:.1f} ms; kernel vs plain {rel:.3e} "
          f"(bar {tol:g}), max |kernel - plain| {max_abs:.3e}")
    if not (np.isfinite(kern).all() and rel <= tol):
        raise AssertionError(f"{name} on one bin's cells disagrees with its "
                             "plain version")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs,
            **bound(ops_of(one), one.args(), one.mom.shape[1]),
            "cells_compared": end - begin, "breakdown_compared": n_break}


def dX_check(wd_parity: Path, cfg_fields: dict, surface_kw: dict) -> dict:
    """check_dX_case at 2,048 cells (the parity workdir's 16 species)."""
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.tools import kernel_check as kc
    cfg = Config(operation=0, cell_block=512, **cfg_fields)
    r = kc.check_dX_case(wd_parity, cfg, 2048, 7, "cuda", **surface_kw)
    print(f"2048 cells {json.dumps(cfg_fields)}: {r.launches} launches on "
          f"{r.bins} bins, {r.breakdown_cells} breakdown cells; kernel vs "
          f"plain {r.vs_plain:.3e} (bar {r.tol_plain:g}), kernel vs f64 "
          f"{r.vs_f64:.3e} (bar {r.tol_f64:g}), plain vs f64 "
          f"{r.plain_vs_f64:.3e}")
    feqmod = cfg.df_mode in (3, 4)
    if not (r.ok and r.launches == r.bins
            and (r.breakdown_cells > 0 or not feqmod)):
        raise AssertionError(f"operation 0 {cfg_fields}: the kernel route "
                             "is off its plain version or the f64 engine")
    return {"vs_plain": r.vs_plain, "vs_f64": r.vs_f64,
            "breakdown_cells": r.breakdown_cells}


def check_dX_files(wd: Path, wd_op1: Path | None) -> None:
    """The operation-0 files: three per species, finite, each axis summing
    to a positive yield (a bin of a few breakdown cells may be negative:
    the linearised delta-f is); with ``wd_op1`` (the same surface through
    operation 1), the tau axis summed back to dN/dy against its dN_dy
    files for pi+, K+ and p."""
    from is3d2_tpu_torch.config import Config
    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    res = wd / "results/continuous"
    mcids = [int(v) for v in np.loadtxt(wd / "PDG/chosen_particles.dat")]
    for m in mcids:
        for name, n in (("dN_taudtaudy", cfg.tau_bins),
                        ("dN_2pirdrdy", cfg.r_bins),
                        ("dN_dphidy", cfg.phip_bins)):
            v = np.loadtxt(res / f"{name}_{m}.dat")
            if v.shape != (n, 2) or not np.isfinite(v).all() \
                    or not v[:, 1].sum() > 0:
                raise AssertionError(f"{name}_{m}: bad shape, value or sum")
    print(f"{3 * len(mcids)} files of {len(mcids)} species")
    if wd_op1 is None:
        return
    tau_w = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    for m in (211, 321, 2212):
        v = np.loadtxt(res / f"dN_taudtaudy_{m}.dat")
        total = float((v[:, 0] * v[:, 1]).sum() * tau_w)
        op1 = float(np.loadtxt(wd_op1 / f"results/continuous/dN_dy_{m}.dat")
                    [1])
        print(f"{m}: sum over tau bins {total:.8g} vs op-1 dN/dy {op1:.8g} "
              f"({(total - op1) / op1:+.2e})")
        if abs(total - op1) > 1e-5 * op1:
            raise AssertionError(f"{m}: the tau bins do not sum to dN/dy")


def phase_op0_b1(tmp: Path, wd1: Path, wd_parity: Path) -> dict:
    print(f"== 18. operation 0, df 1, f32c: phase 5's {MAIN_CELLS} cells, all "
          "species, 51 x 48 x 24, through B1 on every bin")
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.tools import kernel_check as kc
    wd = derived_workdir(tmp, wd1, "op0_df1", {"operation": 0})
    launches, stages, _ = run_cli(wd, "cooper_frye_comp")
    launches = launches["cooper_frye_comp"]
    print(f"stage seconds: {json.dumps(stages)}")
    check_dX_files(wd, wd1)
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_comp"]

    def b1_ops(o):
        return per_eval * o.evaluations

    t = dX_main_path_timing(wd, kc.engine_state, ck.cooper_frye_comp, b1_ops)
    cfg, state, ops = t.pop("state")
    cmp = dX_bin_vs_plain("B1", cfg, state, ops, kc.TOL, b1_ops)
    small = dX_check(wd_parity, {"df_mode": 1, "compute_dtype": "f32c"}, {})
    return {"launches": launches, "stage_seconds": stages, **t, **cmp,
            "library_ms": None, "at_2048_cells": small}


def phase_op0_b3(tmp: Path, wd_parity: Path) -> dict:
    from is3d2_tpu_torch.ops import cooper_frye_feqmod as fk
    from is3d2_tpu_torch.tools import kernel_check as kc
    print(f"== 19. operation 0, df 4, f32: {MAIN_CELLS} cells written in "
          f"mode 6 with dsigma_eta / tau in +-{kc.DX_DAN}, shear 0.2, bulk "
          "0.1, all species, 51 x 48 x 24 (not folded), through B3 "
          "(dan-weighted) on every bin")
    from is3d2_tpu_torch.tools.synthetic import write_workdir
    t0 = time.perf_counter()
    wd = write_workdir(tmp / "op0_df4", n_cells=MAIN_CELLS,
                       params={"operation": 0, "df_mode": 4,
                               "compute_dtype": "f32"},
                       surface_mode=6, dan_scale=kc.DX_DAN,
                       **kc.FEQMOD_SURFACE)
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")
    launches, stages, out = run_cli(wd, "cooper_frye_feqmod")
    launches = launches["cooper_frye_feqmod"]
    n_break = int(re.search(r"^feqmod breaks down for (\d+) /", out,
                            re.M).group(1))
    print(f"stage seconds: {json.dumps(stages)}; {n_break} breakdown cells")
    check_dX_files(wd, None)
    per_eval = BOUND_OPS_PER_EVALUATION["cooper_frye_feqmod"]

    def b3_ops(o):
        n_b = int((o.cols[:, fk.BREAKS] != 0).sum().item())
        per_cell = o.evaluations / o.cols.shape[0]
        return per_cell * (n_b * per_eval["breakdown"]
                           + (o.cols.shape[0] - n_b) * per_eval["modified"])

    t = dX_main_path_timing(wd, kc.feqmod_engine_state, fk.cooper_frye_feqmod,
                            b3_ops)
    cfg, state, ops = t.pop("state")
    if not ops.dan_weighted or ops.eta.shape[0] != 24:
        raise AssertionError("B3's operation-0 operands are not dan-weighted "
                             "on the unfolded 24 nodes")
    cmp = dX_bin_vs_plain("B3", cfg, state, ops, kc.FEQMOD_TOL_PLAIN, b3_ops,
                          min_breakdown=1)
    small = {name: dX_check(wd_parity, fields, kc.FEQMOD_SURFACE)
             for name, fields in (
                 ("df4", {"df_mode": 4, "compute_dtype": "f32"}),
                 ("df3-outflow", {"df_mode": 3, "compute_dtype": "f32",
                                  "outflow": 1}))}
    return {"launches": launches, "stage_seconds": stages,
            "breakdown_cells": n_break, **t, **cmp, "library_ms": None,
            "at_2048_cells": small}


def phase_p1_compare(wd: Path, wd_eta: Path) -> None:
    print("== 20. P1 vs plain version vs f64 polarization engine (2048 cells, "
          "16 species, 51 x 48, 24 eta; vorticity)")
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    from is3d2_tpu_torch.tools import kernel_check as kc
    chunks = -(-kc.ETA_NODES // pz.ETA_CHUNK)
    cases = {
        "24 eta": (kc.check_polarization_case(wd, 2048, 7, "cuda",
                                              cell_block=512), 1),
        f"{kc.ETA_NODES} eta, unfolded": (kc.check_polarization_case(
            wd_eta, 2048, 7, "cuda", cell_block=512), chunks),
        "ragged " + json.dumps(kc.RAGGED): (
            kc.check_polarization_ragged_case(wd, 2048, 7, "cuda"), 1)}
    for name, (r, launches) in cases.items():
        print(f"{name:22s} ({r.launches} launches) kernel vs plain: Snorm "
              f"{r.vs_plain[0]:.3e}, P {r.vs_plain[1]:.3e}; kernel vs f64: "
              f"Snorm {r.vs_f64[0]:.3e}, P {r.vs_f64[1]:.3e}; plain vs f64: "
              f"Snorm {r.plain_vs_f64[0]:.3e}, P {r.plain_vs_f64[1]:.3e}")
        if not (r.ok and r.launches == launches):
            raise AssertionError(
                f"P1 {name}: kernel disagrees, does not repeat or launched "
                f"{r.launches} times, not {launches} ({r.vs_plain} vs plain,"
                f" {r.vs_f64} vs f64; bars {kc.POLZN_TOL_PLAIN:g} plain, "
                f"{kc.POLZN_TOL_NORM:g} / {kc.POLZN_TOL_P:g} f64)")


def phase_p1_main_path(tmp: Path) -> tuple[dict, dict, Path]:
    print(f"== 21. mode-5 main path: {MAIN_CELLS} cells with thermal "
          "vorticity, all species, 51 x 48 x 24, df 1, f32c: the spectra "
          "on B1, the polarization on P1")
    from is3d2_tpu_torch.io.fastio import load_table_fast
    from is3d2_tpu_torch.io.output import POLARIZATION_FILES
    launches, stages, wd, _ = run_main_path(
        tmp, "main_mode5", "cooper_frye_comp",
        {"df_mode": 1, "compute_dtype": "f32c"}, also=("polarization_f32",),
        surface_mode=5)
    n_species = len(np.loadtxt(wd / "PDG/chosen_particles.dat"))
    rows = n_species * 48 * 51
    t0 = time.perf_counter()
    for name in POLARIZATION_FILES:
        v = load_table_fast(wd / f"results/{name}.dat")
        if v.shape != (rows, 4) or not np.isfinite(v).all():
            raise AssertionError(f"{name}.dat: shape {v.shape} (want "
                                 f"({rows}, 4)) or a value not finite")
        print(f"{name}.dat: {v.shape[0]} rows, finite, max |P| "
              f"{np.abs(v[:, 3]).max():.4e}")
    print(f"(parsed in {time.perf_counter() - t0:.1f} s); kernel launches "
          f"{json.dumps(launches)}; stage seconds: {json.dumps(stages)}")
    return launches, stages, wd


def phase_p1_full(wd: Path) -> dict:
    print("== 22. P1 on the mode-5 main path's operands")
    from is3d2_tpu_torch.ops import polarization_f32 as pz
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg, state = main_path_state(wd, kc.polarization_engine_state)
    ops = pz.pack_inputs(*state)
    args = ops.args()
    kernel = functools.partial(pz.polarization_f32, row_len=ops.row_len)
    C, Ne, M = ops.cell.shape[0], ops.eta.shape[0], ops.mom.shape[1]
    print(f"{C} padded cells x {Ne} eta x {M} momenta (M mod 256 = "
          f"{M % 256}) = {ops.evaluations:.4g} evaluations")
    first = kernel(*args)
    full_ms, second = cuda_ms(lambda: kernel(*args), warmup=lambda: None)
    print(f"kernel at full size {full_ms:.1f} ms, "
          f"{ops.evaluations / full_ms * 1e3:.4g} evaluations/s")
    if not torch.equal(first, second):
        raise AssertionError("two launches of P1 on the main path's operands "
                             "gave different bits")
    print("two launches at full size gave equal bits")
    if not (torch.isfinite(first).all() and (first[4] > 0).all()):
        raise AssertionError("P1 at full size: a sum not finite or an "
                             "Snorm <= 0")
    print(f"every sum finite, Snorm > 0 on all {M} momenta")
    del first, second
    g = pz.polarization_f32.last_geometry
    print(f"launched with {g}")

    per_eval = BOUND_OPS_PER_EVALUATION["polarization_f32"]

    def cut(n):
        return (ops.cell[:n].contiguous(), *args[1:])

    n = P1_COMPARE_CELLS
    print(f"compared on the first {n} cells at the full M")
    ms, out = cuda_ms(lambda: kernel(*cut(n)))
    plain_ms, ref = cuda_ms(lambda: pz.polarization_f32_plain(*cut(n)),
                            warmup=lambda: pz.polarization_f32_plain(*cut(64)))
    print(f"cut: kernel {ms:.1f} ms, plain version {plain_ms:.1f} ms "
          f"({plain_ms / ms:.1f}x the kernel)")
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    norm_err, p_err = kc.polarization_errors(out, ref)
    max_abs = kc.polarization_units(out, ref)
    print(f"kernel vs plain: Snorm {norm_err:.3e} relative, P {p_err:.3e} of "
          f"max |P| (bar {kc.POLZN_TOL_PLAIN:g}), max |P_kernel - P_plain| "
          f"{max_abs:.3e}")
    if not (np.isfinite(out).all() and max(norm_err, p_err)
            <= kc.POLZN_TOL_PLAIN):
        raise AssertionError("P1 disagrees with its plain version on the "
                             "main path's operands")
    main_bound = bound(per_eval * ops.evaluations, args, 5 * M)["bound_ms"]
    print(f"bound at full size {main_bound:.1f} ms: "
          f"{100 * main_bound / full_ms:.1f} % of it")
    return {"register_tile": g.r, "cell_split": g.n_split,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            **bound(per_eval * n * Ne * M, cut(n), 5 * M),
            "main_path_bound_ms": main_bound,
            "main_path_evaluations_per_s": ops.evaluations / full_ms * 1e3,
            "main_path_share_of_bound": main_bound / full_ms,
            # no single PyTorch call computes a polarization sum
            "library_ms": None,
            "cells_compared": n, "snorm_rel_err": norm_err,
            "p_err": p_err, "main_path_ms": full_ms,
            "main_path_evaluations": ops.evaluations}


def main() -> int:
    card = phase_environment()
    # the package is imported only now: a copy of this script alone, or a
    # machine without a card, fails above or here and prints no result
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import is3d2_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        wd, wd_eta = parity_workdirs(tmp)
        phase_b1_compare(wd, wd_eta)
        phase_b3_compare(wd, wd_eta)
        b1_launches, b1_stages, wd1 = phase_b1_main_path(tmp)
        b1 = phase_b1_full(wd1, b1_stages)
        b3_launches, _, wd4 = phase_b3_main_path(tmp)
        b3 = phase_b3_full(wd4)
        phase_b2_compare(wd, wd_eta)
        b2_launches, _, wd2 = phase_b2_main_path(tmp)
        b2 = phase_b2_full(wd2)
        op2_hist = phase_sampler_histograms(tmp, wd1)
        op2_oscar = phase_sampler_oscar(tmp, wd4)
        b3f_launches, _, wd5, famod = phase_famod_main_path(tmp)
        b3f = phase_famod_full(wd5)
        op2_famod = phase_famod_sampler(tmp, wd5)
        grouped = phase_grouped_main_path(tmp)
        op0_b1 = phase_op0_b1(tmp, wd1, wd)
        op0_b3 = phase_op0_b3(tmp, wd)
        phase_p1_compare(wd, wd_eta)
        p1_launches, p1_stages, wd_m5 = phase_p1_main_path(tmp)
        p1 = phase_p1_full(wd_m5)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print("operations per evaluation: counted from the plain versions "
          f"{json.dumps(OPS_PER_EVALUATION)}; executed by the kernels "
          f"{json.dumps(EXECUTED_OPS_PER_EVALUATION)}; the bounds take the "
          f"smaller {json.dumps(BOUND_OPS_PER_EVALUATION)}")
    print(json.dumps({"sampler": {"card": card, "histograms": op2_hist,
                                  "oscar": op2_oscar, "famod": op2_famod}}))
    print(card)
    print(json.dumps({"kernels": [
        {"name": "cooper_frye_comp", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_comp.cu",
         "replaces": "is3d2_tpu/ops/cooper_frye_pallas.py:241",
         "launches": b1_launches, **b1,
         # phase 17: the grouped mode-6 main path; phase 18: operation 0,
         # one launch per non-empty bin
         "grouped_mode6": grouped, "operation0": op0_b1},
        {"name": "cooper_frye_feqmod", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_feqmod.cu",
         "replaces": "is3d2_tpu/ops/cooper_frye_feqmod_pallas.py:68",
         "launches": b3_launches, **b3,
         # the famod mode (df 5) on its own main path, phases 14-15
         "famod": {"launches": b3f_launches, **b3f, **famod},
         # phase 19: operation 0, dan-weighted, one launch per bin
         "operation0": op0_b3},
        {"name": "cooper_frye_f32", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/cooper_frye_f32.cu",
         "replaces": "is3d2_tpu/ops/cooper_frye_pallas.py:83",
         "launches": b2_launches, **b2},
        {"name": "polarization_f32", "route": "cuda",
         "source": "is3d2_tpu_torch/csrc/polarization_f32.cu",
         # an XLA program: the JAX package has no Pallas kernel for it
         "replaces": "is3d2_tpu/core/polarization_fast.py:96",
         "launches": p1_launches["polarization_f32"], **p1,
         # phase 21: the mode-5 main path, B1 for its spectra beside P1
         "mode5_main_path": {"launches": p1_launches,
                             "stage_seconds": p1_stages}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
