"""Build the CUDA sources of csrc/ with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher, so it
builds with nvcc alone in seconds (no PyTorch headers).  The library goes to
``build/is3d2_tpu_torch/`` at the repository root, named by a hash of the
source and the flags, so an edited source rebuilds on its next use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "is3d2_tpu_torch"

# no --use_fast_math: it swaps expf for __expf, flushes denormals and
# approximates division, which the compensated kernel cannot afford
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# flags of one source only.  B3 never contracts a multiply and an add by
# itself: its breakdown branch cancels ~1e3-fold on cells with large PTB
# coefficients, where a contracted FMA moved a bin by 4.5e-4 against the
# plain version.  Where nothing cancels the source calls fmaf / fma itself,
# which the flag leaves alone
SOURCE_FLAGS = {"cooper_frye_feqmod": ("-fmad=false",)}

_loaded: dict[Path, ctypes.CDLL] = {}


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile csrc/<name>.cu unless its library is already built.  ptxas'
    resource report goes to a .ptxas file beside the library.  Returns
    (library path, seconds spent compiling; 0.0 when cached)."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_flags(name), "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    lib.with_suffix(".ptxas").write_text(proc.stderr)
    os.replace(tmp, lib)   # atomic: concurrent builders never see a partial file
    return lib, time.perf_counter() - t0


def resource_usage(lib: Path) -> dict[str, dict[str, int]]:
    """ptxas' report of a built library: mangled kernel name -> registers,
    static shared-memory bytes, stack frame and spill bytes."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in lib.with_suffix(".ptxas").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu."""
    path, _ = build(name)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
