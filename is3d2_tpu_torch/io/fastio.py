"""ctypes bindings for the port's native I/O library (csrc/is3d2_io.cpp).

Counterpart of is3d2_tpu/io/fastio.py.  The library is built with g++ at
first use into ``build/is3d2_tpu_torch/`` at the repository root, named by
a hash of the source and the flags as ops/_build.py names the kernels, so an
edited source rebuilds on its next use.  A failed build, a failed load or a
short parse raises: nothing falls back to numpy.  ``_build_alias_numpy`` is
the alias builder's plain version, which the tests hold the C++ builder to.

Every call into the library releases the GIL (ctypes does), so a writer
thread formats files while the main thread drives the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "is3d2_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "is3d2_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib: ctypes.CDLL | None = None

_dp = ctypes.POINTER(ctypes.c_double)
_llp = ctypes.POINTER(ctypes.c_longlong)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libis3d2_io_{digest}.so"


def build() -> Path:
    """Compile csrc/is3d2_io.cpp unless its library is already built."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never see a partial file
    return lib


def get_lib() -> ctypes.CDLL:
    """Build (at first use) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.i3d_count_rows.restype = ctypes.c_longlong
    lib.i3d_count_rows.argtypes = [ctypes.c_char_p, _llp]
    lib.i3d_parse.restype = ctypes.c_longlong
    lib.i3d_parse.argtypes = [ctypes.c_char_p, _dp, ctypes.c_longlong]
    lib.i3d_write_events.restype = ctypes.c_longlong
    lib.i3d_write_events.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, _llp, _llp,
        ctypes.POINTER(_dp), ctypes.c_int]
    lib.i3d_write_blocks.restype = ctypes.c_longlong
    lib.i3d_write_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.c_longlong, _llp, _llp, ctypes.POINTER(_dp), ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int]
    lib.i3d_build_alias.restype = ctypes.c_longlong
    lib.i3d_build_alias.argtypes = [
        _dp, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    _lib = lib
    return lib


def _build_alias_numpy(r: np.ndarray):
    """Plain version of build_alias_tables: Vose's construction vectorized
    across cells (the per-cell small/large stack pairing is sequential, but
    every cell takes its next pairing step in lockstep)."""
    C, S = r.shape
    p = np.clip(r, 0.0, None)
    tot = p.sum(axis=1)
    ok = tot > 0.0
    p = p * (S / np.where(ok, tot, 1.0))[:, None]
    p[~ok] = 1.0
    prob = np.ones((C, S), np.float32)
    alias = np.tile(np.arange(S, dtype=np.int32), (C, 1))

    is_small = p < 1.0
    ns = is_small.sum(axis=1).astype(np.int64)
    order = np.argsort(~is_small, axis=1, kind="stable")
    small = order.astype(np.int32)            # small[c, :ns[c]]
    large = order[:, ::-1].astype(np.int32)   # large[c, :S-ns[c]]
    nl = (S - ns).copy()
    for _ in range(2 * S):
        act = (ns > 0) & (nl > 0)
        if not act.any():
            break
        c = np.flatnonzero(act)
        s = small[c, ns[c] - 1]
        l = large[c, nl[c] - 1]
        ns[c] -= 1
        nl[c] -= 1
        prob[c, s] = p[c, s]
        alias[c, s] = l
        p[c, l] = (p[c, l] + p[c, s]) - 1.0
        back = p[c, l] < 1.0
        cs, ls = c[back], l[back]
        small[cs, ns[cs]] = ls
        ns[cs] += 1
        cl, ll = c[~back], l[~back]
        large[cl, nl[cl]] = ll
        nl[cl] += 1
    # stack leftovers keep their init (prob 1, alias self)
    return prob, alias


def build_alias_tables(rates: np.ndarray):
    """Walker alias tables (prob f32, alias i32), both (C, S), from the
    per-(cell, species) mean-yield matrix, with the threaded native builder
    (i3d_build_alias)."""
    r = np.ascontiguousarray(rates, dtype=np.float64)
    C, S = r.shape
    prob = np.empty((C, S), np.float32)
    alias = np.empty((C, S), np.int32)
    n = get_lib().i3d_build_alias(
        r.ctypes.data_as(_dp), C, S,
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 0)
    if n != C * S:
        raise ValueError(f"alias build refused a ({C}, {S}) rate matrix "
                         "(needs C > 0 and 0 < S <= 32767)")
    return prob, alias


def _columns(cols):
    cols = [np.ascontiguousarray(c, dtype=np.float64) for c in cols]
    ptrs = (_dp * len(cols))(*[c.ctypes.data_as(_dp) for c in cols])
    return cols, ptrs


def write_events_fast(path_pattern: str, header: str, sep: str,
                      precision: int, include_counter: bool,
                      offsets: np.ndarray, mcid: np.ndarray,
                      cols: list[np.ndarray], event_base: int = 0) -> int:
    """Write per-event particle-list text files with the threaded native
    writer.  Rows are pre-sorted by event; ``offsets`` has n_events + 1
    entries; local event e writes file id ``event_base + e + 1``.  Returns
    the rows written."""
    n_events = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    mcid = np.ascontiguousarray(mcid, dtype=np.int64)
    cols, ptrs = _columns(cols)
    n = get_lib().i3d_write_events(
        path_pattern.encode(), header.encode(), sep.encode(), precision,
        int(include_counter), int(event_base), n_events,
        offsets.ctypes.data_as(_llp), mcid.ctypes.data_as(_llp), ptrs,
        len(cols))
    if n < 0:
        raise OSError(f"native particle-list write failed for {path_pattern}")
    return int(n)


def write_blocks_fast(path_pattern: str, file_ids, header: str, sep: str,
                      precision: int, offsets: np.ndarray,
                      cols: list[np.ndarray], blank_every: int = 0,
                      blank_tail: int = 1) -> int:
    """Write per-id block-table text files (the op-1 continuous writers)
    with the threaded native writer: file i holds rows
    [offsets[i], offsets[i+1]) of the shared float columns, a blank line
    after every ``blank_every`` rows (``blank_tail``: after the final block
    too); an empty ``header`` writes no header line.  Returns the rows
    written."""
    file_ids = np.ascontiguousarray(file_ids, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    cols, ptrs = _columns(cols)
    n = get_lib().i3d_write_blocks(
        path_pattern.encode(), header.encode(), sep.encode(), precision,
        len(file_ids), file_ids.ctypes.data_as(_llp),
        offsets.ctypes.data_as(_llp), ptrs, len(cols), blank_every,
        blank_tail)
    if n < 0:
        raise OSError(f"native block-table write failed for {path_pattern}")
    return int(n)


def load_table_fast(path: str | Path) -> np.ndarray:
    """Parse a whitespace-separated numeric table ('#' comments) into a
    (rows, cols) f64 array with the threaded native parser.  A table whose
    rows do not all have the first row's column count raises."""
    lib = get_lib()
    path = str(path)
    n_cols = ctypes.c_longlong(0)
    n_rows = lib.i3d_count_rows(path.encode(), ctypes.byref(n_cols))
    if n_rows < 0:
        raise OSError(f"cannot read {path}")
    if n_rows == 0 or n_cols.value <= 0:
        raise ValueError(f"{path} holds no numeric rows")
    capacity = n_rows * n_cols.value
    out = np.empty(capacity, dtype=np.float64)
    n = lib.i3d_parse(path.encode(), out.ctypes.data_as(_dp), capacity)
    if n != capacity:
        raise ValueError(f"{path}: parsed {n} values, expected {n_rows} rows "
                         f"x {n_cols.value} columns (ragged or non-numeric)")
    return out.reshape(n_rows, n_cols.value)
