"""The port's tracer: named spans on the host clock, kept in memory.

A span is ``Span(name, stream, seq, parent, t0, t1, n)``:

* ``t0``, ``t1``: ``time.perf_counter`` seconds;
* ``stream``: the :class:`~grbaz_tpu_torch.core.executor.StreamExecutor`
  it belongs to (each gets a small integer when it is built), -1 for
  none; ``seq``: that executor's dispatch index of the block, -1 for
  none. The spans of one block share ``(stream, seq)``;
* ``parent``: the name of the enclosing span of the same thread, or
  None;
* ``n``: one optional integer (a queue depth, a byte count).

Spans record while :func:`enable` is in force, and also while a
``torch.profiler`` session records (torch's own process-wide flag).
While the thread's own profiler records operators, each span is also
opened as ``torch.profiler.record_function(name)``, so an exported trace
shows it over its operators. The buffer keeps the newest ``CAPACITY``
spans; nothing is written to disk.

Readers use :func:`enable`, :func:`disable`, :func:`spans` and
:func:`clear`. Instrumented code reads :func:`on` once a call and, only
where it is true, calls :func:`begin` / :func:`end` around a part (or
:func:`add` for a span timed elsewhere): with tracing off a site costs
one boolean test.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 20

_enabled = False
_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_clock = time.perf_counter


class Span(NamedTuple):
    name: str
    stream: int
    seq: int
    parent: Optional[str]
    t0: float
    t1: float
    n: Optional[int]


class _Thread(threading.local):
    def __init__(self):
        self.open = []  # frames (name, stream, seq, parent, t0, range)


_thread = _Thread()


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def clear():
    _buf.clear()


def spans(t0: float = -math.inf, t1: float = math.inf) -> list:
    """The kept spans that start in ``[t0, t1)``, in order of start."""
    return sorted((Span(*s) for s in tuple(_buf) if t0 <= s[4] < t1),
                  key=lambda s: s.t0)


def on() -> bool:
    """Whether spans record now."""
    return _enabled or _profiler._is_profiler_enabled


def begin(name: str, stream: Optional[int] = None,
          seq: Optional[int] = None) -> tuple:
    """Open a span on this thread. With ``stream`` given it is a root
    (frames an exception left open are dropped); otherwise it takes its
    parent's ``(stream, seq)``."""
    frames = _thread.open
    if stream is not None:
        while frames:  # left open by an exception
            _exit(frames.pop())
        parent, seq = None, -1 if seq is None else seq
    elif frames:
        parent, stream, seq = frames[-1][:3]
    else:
        parent, stream, seq = None, -1, -1
    rng = None
    if torch.autograd._profiler_enabled():  # this thread's operators record
        rng = _profiler.record_function(name)
        rng.__enter__()
    frame = (name, stream, seq, parent, _clock(), rng)
    frames.append(frame)
    return frame


def end(frame: tuple, n: Optional[int] = None):
    """Close ``frame`` (and any frame an exception left open in it)."""
    t1 = _clock()
    frames = _thread.open
    while frames:
        top = frames.pop()
        if top[5] is not None:
            _exit(top)
        if top is frame:
            break
    _buf.append(frame[:5] + (t1, n))


def add(name: str, stream: int, seq: int, t0: float, t1: float,
        n: Optional[int] = None):
    """Record a span timed elsewhere (another thread's), with no parent."""
    _buf.append((name, stream, seq, None, t0, t1, n))


def _exit(frame: tuple):
    if frame[5] is not None:
        frame[5].__exit__(None, None, None)
