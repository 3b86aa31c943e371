"""The program's own spans (``grbaz_tpu_torch.core.trace``) over the
profiled part of a traced window, and the arithmetic the metrics take
from them.

The profiler's session arms the program's tracer, so the spans cover
the same part of the window as the device trace, and are read under the
profiler: their host milliseconds are upper bounds of untraced ones. A
program without the tracer, or a run without a trace, reads None.
"""

from __future__ import annotations

from radiobench import spans as host


def spans(ctx) -> list:
    """The program's spans that start in ``[ctx.trace.start,
    ctx.trace.end)``; None without a trace or a tracer."""
    if ctx.trace is None:
        return None
    try:
        from grbaz_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.spans(ctx.trace.start, ctx.trace.end) or None


def mean_ms(ctx, name: str):
    """Mean host milliseconds a block in spans ``name``: summed over each
    block's spans (a stream's dispatch index), over the blocks that have
    one."""
    got = spans(ctx)
    per = {}
    for s in got or ():
        if s.name == name and s.seq >= 0:
            key = (s.stream, s.seq)
            per[key] = per.get(key, 0.0) + (s.t1 - s.t0)
    return 1e3 * sum(per.values()) / len(per) if per else None


def idle_inside(ctx, name: str):
    """Share (%) of the profiled window in which the card was idle (the
    gaps between device intervals) while a span ``name`` was open."""
    got = spans(ctx)
    if not got or ctx.trace.window_s <= 0:
        return None
    lo, hi = ctx.trace.start, ctx.trace.end
    inside = host.merge(host.clip(
        [(s.t0, s.t1) for s in got if s.name == name], lo, hi))
    if not inside:
        return None
    idle = host.gaps([(s, e) for _, _, s, e in ctx.trace.events], lo, hi)
    return 100.0 * overlap(idle, inside) / ctx.trace.window_s


def overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
