"""Spans around the program's layers, put in from the benchmark's side for
a traced run and taken out after it.

Each span is a ``torch.profiler.record_function`` named
``portbench::<layer>`` around one call into the program; the Cooper-Frye
kernel entries (the ``ops`` functions the spectra routes call) get the
span ``portbench::kernel``.  Device time comes from the profiler's
timeline alone.  Untraced runs run the program untouched."""

from __future__ import annotations

import functools
import importlib

import torch

# (module, attribute path, span name); the kernel entries under the names
# their callers look them up by
SPANS = (
    ("is3d2_tpu_torch.driver", "IS3D._setup", "setup"),
    ("is3d2_tpu_torch.driver", "check_invariants", "invariants"),
    ("is3d2_tpu_torch.driver", "compute_spectra", "compute_spectra"),
    ("is3d2_tpu_torch.core.spectra", "spectra_on_device", "spectra_on_device"),
    ("is3d2_tpu_torch.core.spectra", "prepare_cells", "prepare_cells"),
    ("is3d2_tpu_torch.core.spectra_feqmod", "prepare_feqmod", "feqmod_prep"),
    ("is3d2_tpu_torch.ops.spectra_fast_common", "cooper_frye_comp", "kernel"),
    ("is3d2_tpu_torch.ops.spectra_fast_common", "cooper_frye_comp_3d", "kernel"),
    ("is3d2_tpu_torch.ops.cooper_frye_feqmod", "cooper_frye_feqmod", "kernel"),
    ("is3d2_tpu_torch.ops.cooper_frye_feqmod", "cooper_frye_feqmod_3d", "kernel"),
)


def _resolve(module: str, path: str):
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def _span(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function("portbench::" + name):
            return fn(*args, **kwargs)
    return wrapper


class Instruments:
    """Install with ``install()``, remove with ``remove()``."""

    def __init__(self):
        self._undo = []

    def install(self) -> None:
        for module, path, name in SPANS:
            owner, attr = _resolve(module, path)
            fn = getattr(owner, attr)
            self._undo.append((owner, attr, fn))
            setattr(owner, attr, _span(name, fn))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()
