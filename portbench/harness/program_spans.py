"""The program's own spans in a trace: the ``record_function``s named
``is3d2::<name>`` that is3d2_tpu_torch/tracing.py opens while a profiler
records.  A span belongs to window surface i when it starts inside that
surface's ``portbench::surface`` span.  A trace of a program without them
gives nothing, and the readers then return None."""

from __future__ import annotations

from .trace import _merge

PREFIX = "is3d2::"
# the span of one whole ``run_particlization``: it covers everything the
# other spans name
OUTER = "particlization"


def spans(trace) -> list[tuple[float, float, str]]:
    """(start, end, name without the prefix) of every program span, in
    order of start, in microseconds."""
    n = len(PREFIX)
    return [(a, b, name[n:]) for a, b, name, cat in trace.host
            if cat == "user_annotation" and name.startswith(PREFIX)]


def per_surface(ctx, names, measure=lambda a, b: b - a) -> list | None:
    """Per window surface, ``measure(start, end)`` summed over the program
    spans named in ``names`` that start inside it (by default their
    microseconds); None where no window surface holds one."""
    if ctx.trace is None:
        return None
    found = [(a, b) for a, b, n in spans(ctx.trace) if n in names]
    out, seen = [], False
    for s0, s1 in ctx.trace.spans("surface"):
        inside = [(a, b) for a, b in found if s0 <= a < s1]
        seen = seen or bool(inside)
        out.append(sum(measure(a, b) for a, b in inside))
    return out if seen else None


def mean_ms(ctx, names, measure=lambda a, b: b - a) -> float | None:
    """per_surface's microseconds as milliseconds, the mean over the
    window's surfaces."""
    v = per_surface(ctx, names, measure)
    return 1e-3 * sum(v) / len(v) if v else None


def named(trace) -> list[list[float]]:
    """The merged intervals that a program span other than ``OUTER``
    covers."""
    return _merge([(a, b) for a, b, n in spans(trace) if n != OUTER])


def covered_us(gaps, intervals) -> float:
    """Microseconds of the sorted, disjoint ``gaps`` that the sorted,
    disjoint ``intervals`` cover."""
    total, j = 0.0, 0
    for g0, g1 in gaps:
        while j < len(intervals) and intervals[j][1] <= g0:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < g1:
            total += min(g1, intervals[k][1]) - max(g0, intervals[k][0])
            k += 1
    return total
