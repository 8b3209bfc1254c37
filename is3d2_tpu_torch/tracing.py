"""The program's spans on the torch profiler's clock, and the driver's stage
timing.

``span(name)`` opens ``torch.profiler.record_function("is3d2::" + name)``
while a torch profiler records, and enters nothing otherwise: the check
is one read of torch's module-level flag ``_is_profiler_enabled``.
Kineto stamps the spans on the clock of the CUPTI device events, so a
trace shows what the host was doing in every idle gap of the card; the
profiler keeps them with its other events (``export_chrome_trace``).
``stage(name, seconds)`` is a span that also adds the interval's
``time.perf_counter()`` seconds to ``seconds[name]`` (the driver's
``stage_seconds``), profiler or not.

A running profiler is the only switch:

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        IS3D(workdir).run_particlization()
    prof.export_chrome_trace("trace.json")

The spans and the metrics that read them: PERF.md section 3.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "is3d2::"


@contextlib.contextmanager
def span(name: str):
    """``record_function("is3d2::" + name)`` around the block while a
    profiler records; nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


@contextlib.contextmanager
def stage(name: str, seconds: dict):
    """``span(name)`` that adds the block's monotonic seconds to
    ``seconds[name]``."""
    with span(name):
        t0 = time.perf_counter()
        yield
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
