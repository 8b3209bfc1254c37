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
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "is3d2_tpu_torch"

# no --use_fast_math: it swaps expf for __expf, flushes denormals and
# approximates division, which the compensated kernel cannot afford
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# flags of one source only.  B3 rounds every f32 operation on its own, as
# its plain version and the TPU kernel do: its breakdown branch cancels
# ~1e3-fold on cells with large PTB coefficients, where a contracted FMA
# moved a bin by 4.5e-4 against the plain version
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
    """Compile csrc/<name>.cu unless its library is already built.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never see a partial file
    return lib, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu."""
    path, _ = build(name)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
