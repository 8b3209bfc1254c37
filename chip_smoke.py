"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises; nothing is caught):
  1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
     fails without a CUDA device;
  2. build the compensated Cooper-Frye kernel with nvcc (sm_90a);
  3. kernel vs its plain torch version and vs the port's f64 engine at a
     reduced shape (2048 cells, 16 species, 51 pT x 48 phi, 24 eta) for df 1
     and df 2 with the clip/outflow/diffusion variants: <= 1e-6 relative on
     bins >= 1e-4 of each species' peak (is3d2_tpu_torch/tools/kernel_check);
  4. the op-1 main path at full size through the CLI: a synthetic workdir of
     1e5 cells, the full ~370-species list, 51 pT x 48 phi x 24 eta, df 1,
     f32c.  The kernel's launch count must move, the spectra must be finite
     and non-negative and dN/dy must order pi+ > K+ > p;
  5. kernel vs plain version on the main path's own operands (102,400
     padded cells x 12 eta x ~9.1e5 momenta, not a multiple of the block):
     both times, and <= 1e-6 relative between them (the plain version takes
     about five minutes there).

The line before the last is a JSON object with each kernel's measurements;
the last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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


def phase_build() -> float:
    print("== 2. build")
    from is3d2_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, compile_s = _build.build("cooper_frye_comp")
    _build.load("cooper_frye_comp")
    print(f"built {path.name}: nvcc {compile_s:.2f} s, "
          f"build+load {time.perf_counter() - t0:.2f} s")
    return compile_s


def phase_compare(tmp: Path) -> None:
    print("== 3. kernel vs plain version vs f64 engine (2048 cells, "
          "16 species, 51 x 48, 24 eta)")
    from is3d2_tpu_torch.tools import kernel_check as kc
    from is3d2_tpu_torch.tools.synthetic import write_workdir

    chosen = (211, -211, 111, 321, -321, 311, 221, 2212, -2212, 2112, 3122,
              -3122, 3222, 3312, 213, 333)
    wd = write_workdir(tmp / "compare", n_cells=16, chosen_mcids=chosen,
                       include_baryon=True, n_muB=9)
    for name in kc.CASES:
        r = kc.check_case(wd, name, 2048, 7, "cuda")
        print(f"{name:22s} kernel vs plain {r.vs_plain:.3e}  kernel vs f64 "
              f"{r.vs_f64:.3e}  plain vs f64 {r.plain_vs_f64:.3e}  max |kernel"
              f" - plain| {np.abs(r.kernel - r.plain).max():.3e}")
        if not (r.ok and r.launches == 1):
            raise AssertionError(f"{name}: kernel disagrees or does not "
                                 f"repeat ({r.vs_plain:.3e} vs plain, "
                                 f"{r.vs_f64:.3e} vs f64)")


def phase_main_path(tmp: Path) -> tuple[int, dict, Path]:
    print(f"== 4. main path: {MAIN_CELLS} cells, all species, 51 x 48 x 24, "
          "df 1, f32c")
    from is3d2_tpu_torch import cli
    from is3d2_tpu_torch.ops.cooper_frye_comp import cooper_frye_comp
    from is3d2_tpu_torch.tools.synthetic import write_workdir

    t0 = time.perf_counter()
    wd = write_workdir(tmp / "main", n_cells=MAIN_CELLS,
                       params={"df_mode": 1, "compute_dtype": "f32c"})
    print(f"workdir written in {time.perf_counter() - t0:.1f} s")

    log = io.StringIO()
    cooper_frye_comp.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(wd)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cooper_frye_comp.launches
    print(log.getvalue(), end="")
    print(f"cli.main returned {rc} after {wall:.2f} s; kernel launches "
          f"{launches}")
    if rc != 0 or launches < 1:
        raise AssertionError("the main path did not run through the kernel")
    stages = json.loads(re.search(r"^stage seconds: (.*)$", log.getvalue(),
                                  re.M).group(1))

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
    return launches, stages, wd


def phase_full_compare(wd: Path, stages: dict) -> tuple[float, float, float]:
    print("== 5. kernel vs plain version on the main path's operands")
    from is3d2_tpu_torch.config import Config
    from is3d2_tpu_torch.io.surface import read_surface
    from is3d2_tpu_torch.ops import cooper_frye_comp as ck
    from is3d2_tpu_torch.ops.spectra_fast_common import comp_operands
    from is3d2_tpu_torch.tools import kernel_check as kc

    cfg = Config.from_file(wd / "iS3D_parameters.dat")
    surf = read_surface(wd / "input/surface.dat", 1, 2, False)
    state = kc.engine_state(wd, cfg, surf, "cuda")
    ops = comp_operands(*state, cfg)
    args = kc.kernel_args(ops, cfg)
    C, Ne, M = ops.cell.shape[0], ops.eta.shape[0], ops.mom.shape[1]
    print(f"{C} padded cells x {Ne} eta x {M} momenta (M mod 256 = "
          f"{M % 256}) = {ops.evaluations:.4g} evaluations")
    ms, out = cuda_ms(lambda: ck.cooper_frye_comp(*args))
    print(f"kernel {ms:.1f} ms, {ops.evaluations / ms * 1e3:.4g} "
          "evaluations/s")
    print(f"driver stage seconds: {json.dumps(stages)}")
    # the plain version warms up on a few cells only: one call at full size
    # takes minutes
    few = (ops.cell[:64].contiguous(), ops.qm[:64].contiguous(), *args[2:])
    plain_ms, plain = cuda_ms(lambda: ck.cooper_frye_comp_plain(*args),
                              warmup=lambda: ck.cooper_frye_comp_plain(*few))
    print(f"plain version {plain_ms:.1f} ms ({plain_ms / ms:.1f}x the kernel)")
    kern = kc.spectra_units(state, out)
    plain = kc.spectra_units(state, plain)
    rel = kc.max_rel_err(kern, plain)
    max_abs = float(np.abs(kern - plain).max())
    print(f"kernel vs plain: max relative {rel:.3e} on bins >= {kc.FLOOR:g} "
          f"of peak, max |kernel - plain| {max_abs:.3e}")
    if not (np.isfinite(kern).all() and rel <= kc.TOL):
        raise AssertionError(f"kernel disagrees with its plain version on the "
                             f"main path's operands ({rel:.3e})")
    return ms, plain_ms, max_abs


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
        phase_compare(tmp)
        launches, stages, wd = phase_main_path(tmp)
        ms, plain_ms, max_abs = phase_full_compare(wd, stages)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "cooper_frye_comp", "route": "cuda",
        "source": "is3d2_tpu_torch/csrc/cooper_frye_comp.cu",
        "replaces": "is3d2_tpu/ops/cooper_frye_pallas.py:241",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
