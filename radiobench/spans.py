"""Spans on the host clock, the profiler's device timeline, and the
arithmetic the metrics take from them.

Spans come from the benchmark's own wrappers around the calls into the
port's layers (the pump's source and sinks, ``StreamExecutor.dispatch``
and ``fetch`` wrapped on the instance); they are kept in memory. The
device timeline is a ``torch.profiler`` trace over a bounded part of
the window; markers emitted from the thread that runs the profiler put
the host clock onto the trace's clock.
"""

from __future__ import annotations

import json
import math
import os
import re
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    """Spans ``(name, stream, index, start_s, end_s)`` on
    ``time.perf_counter``."""

    def __init__(self):
        self.spans = []
        self._lock = threading.Lock()

    def add(self, name: str, k: int, j: int, t0: float, t1: float):
        with self._lock:
            self.spans.append((name, k, j, t0, t1))

    def of(self, name: str, t0: float = -math.inf,
           t1: float = math.inf) -> list:
        """Spans ``name`` that start in [t0, t1)."""
        return [s for s in self.spans if s[0] == name and t0 <= s[3] < t1]


def wrap_executor(ex, k: int, recorder: Recorder, clock=time.perf_counter):
    """Record a span around each ``dispatch`` and ``fetch`` of ``ex``
    (the pump calls them through the instance)."""
    dispatch, fetch = ex.dispatch, ex.fetch
    counts = dict(dispatch=0, fetch=0)

    def timed(name, fn):
        def call(*args, **kwargs):
            t = clock()
            out = fn(*args, **kwargs)
            recorder.add(name, k, counts[name], t, clock())
            counts[name] += 1
            return out
        return call
    ex.dispatch = timed("dispatch", dispatch)
    ex.fetch = timed("fetch", fetch)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_gaps(gap_list, spans, top: int = 10) -> list:
    """Idle time by what the host was doing: each gap takes the names of
    the spans open at its middle (``"+"``-joined, ``"none"`` if no span
    was), summed by label; the ``top`` largest ``[label, seconds]``."""
    if not gap_list:
        return []
    names = np.array([s[0] for s in spans]) if spans else np.array([])
    starts = np.array([s[1] for s in spans], dtype=np.float64)
    ends = np.array([s[2] for s in spans], dtype=np.float64)
    total = {}
    for g0, g1 in gap_list:
        mid = 0.5 * (g0 + g1)
        open_ = sorted(set(names[(starts <= mid) & (mid < ends)].tolist())) \
            if len(names) else []
        label = "+".join(open_) or "none"
        total[label] = total.get(label, 0.0) + (g1 - g0)
    return sorted(([k, v] for k, v in total.items()), key=lambda x: -x[1])[
        :top]


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """Device events of a profiled part of the window, in seconds on the
    host clock: ``events`` ``(name, cat, start, end)`` clipped to
    ``[start, end]``."""
    start: float
    end: float
    events: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return covered((s, e) for _, _, s, e in self.events)

    def kernels(self, pattern=None) -> list:
        """Durations of kernel launches (whose names match the regex
        ``pattern``, where given) that lie wholly in the window."""
        rx = re.compile(pattern) if pattern else None
        return [e - s for n, c, s, e in self.events
                if c == "kernel" and (rx is None or rx.search(n))
                and self.start < s and e < self.end]

    def top_ops(self, top: int = 10) -> list:
        total = {}
        for n, _, s, e in self.events:
            total[n] = total.get(n, 0.0) + (e - s)
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda x: -x[1])[:top]


class Profile:
    """A ``torch.profiler`` session over part of the window, started and
    stopped from one thread, read back onto the host clock."""

    START, END = "radiobench.window_start", "radiobench.window_end"

    def __init__(self):
        import torch
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.marks = {}

    def _mark(self, name):
        h0 = time.perf_counter()
        with self.torch.profiler.record_function(name):
            pass
        self.marks[name] = 0.5 * (h0 + time.perf_counter())

    def start(self):
        self.prof.start()
        self._mark(self.START)

    def stop(self):
        self._mark(self.END)
        self.prof.stop()

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return trace_from_events(events, self.marks[self.START])


def trace_from_events(events, host_start: float) -> Trace:
    """Device events of a chrome trace (microseconds) on the host clock:
    the start marker's middle is ``host_start``."""
    marks = {e["name"]: e["ts"] + 0.5 * e.get("dur", 0.0) for e in events
             if e.get("name") in (Profile.START, Profile.END)}
    if Profile.START not in marks or Profile.END not in marks:
        raise RuntimeError("the profiler's trace lacks the window markers")
    offset = host_start - marks[Profile.START] * 1e-6
    start, end = host_start, marks[Profile.END] * 1e-6 + offset
    dev = [(e["name"], e["cat"], e["ts"] * 1e-6 + offset,
            (e["ts"] + e.get("dur", 0.0)) * 1e-6 + offset)
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    clipped = [(n, c, max(s, start), min(e, end)) for n, c, s, e in dev
               if e > start and s < end]
    return Trace(start, end, clipped)
