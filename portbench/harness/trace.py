"""A torch.profiler trace reduced to what the per-layer metrics read: the
device's busy intervals (kernels, copies, memsets), the benchmark's own
spans (``torch.profiler.record_function`` names starting with
``portbench::``), the idle gaps and what the host was doing in each, and
the device operations that took most time.

Times in the trace are microseconds on one clock for host and device
(kineto aligns them); spans and busy time are returned in microseconds,
the breakdown lists (``top_ops``, ``idle_gaps``) in seconds."""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
SPAN_PREFIX = "portbench::"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events: list[dict]):
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            rec = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", ""), cat)
            if cat in DEVICE_CATS:
                dev.append(rec)
            elif cat in HOST_CATS:
                host.append(rec)
        self.device = sorted(dev)
        self.host = sorted(host)
        self._busy = _merge([(a, b) for a, b, _, _ in self.device])
        self._busy_starts = [a for a, _ in self._busy]
        self._host_starts = [a for a, _, _, _ in self.host]
        self._spans = [h for h in self.host if h[2].startswith(SPAN_PREFIX)]

    @classmethod
    def from_chrome(cls, path: Path) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    @property
    def has_device(self) -> bool:
        return any(c == "kernel" for _, _, _, c in self.device)

    def spans(self, name: str) -> list[tuple[float, float]]:
        """The (start, end) of each benchmark span ``name``, in order."""
        full = SPAN_PREFIX + name
        return sorted((a, b) for a, b, n, _ in self._spans if n == full)

    def busy_us(self, t0: float, t1: float) -> float:
        """Microseconds of [t0, t1] in which something ran on the device."""
        total = 0.0
        i = max(0, bisect.bisect_right(self._busy_starts, t0) - 1)
        for a, b in self._busy[i:]:
            if a >= t1:
                break
            total += max(0.0, min(b, t1) - max(a, t0))
        return total

    def gaps(self, t0: float, t1: float) -> list[tuple[float, float]]:
        """The idle intervals of the device inside [t0, t1]."""
        out, t = [], t0
        for a, b in self._busy:
            if b <= t0:
                continue
            if a >= t1:
                break
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < t1:
            out.append((t, t1))
        return out

    def kernels(self, patterns, t0: float, t1: float) -> list[tuple]:
        """Device kernels whose name matches one of ``patterns`` (regular
        expressions) and that start inside [t0, t1]."""
        rx = re.compile("|".join(patterns))
        return [(a, b, n) for a, b, n, c in self.device
                if c == "kernel" and t0 <= a < t1 and rx.search(n)]

    def top_ops(self, t0: float, t1: float, n: int = 10) -> list[list]:
        """The ``n`` device operations (by name) with the most time inside
        [t0, t1], in seconds."""
        acc: dict[str, float] = {}
        for a, b, name, _ in self.device:
            if t0 <= a < t1:
                acc[name] = acc.get(name, 0.0) + (b - a)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v * 1e-6] for k, v in top]

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark span
        and the innermost host operation that cover it (the operation
        searched among the 50,000 that started last before ``t``)."""
        span, op = None, None
        span_len = op_len = float("inf")
        i = bisect.bisect_right(self._host_starts, t)
        for a, b, name, _ in self.host[max(0, i - 50_000):i]:
            if b < t:
                continue
            if not name.startswith(SPAN_PREFIX) and b - a < op_len:
                op, op_len = name, b - a
        for a, b, name, _ in self._spans:
            if a <= t <= b and b - a < span_len:
                span, span_len = name[len(SPAN_PREFIX):], b - a
        return f"{span or 'outside spans'} / {_short(op) if op else 'python'}"

    def idle_gaps(self, t0: float, t1: float, n: int = 10) -> list[list]:
        """The ``n`` longest idle gaps inside [t0, t1], each named by what
        the host was doing at its middle, in seconds."""
        gaps = sorted(self.gaps(t0, t1), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_label(0.5 * (a + b)), (b - a) * 1e-6]
                for a, b in gaps]


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
