"""Streaming pump: the host pipeline around a StreamExecutor (port of
``grbaz_tpu/core/pump.py``).

:class:`StreamPump` runs two threads around a bounded block queue:

* the **feeder** pulls blocks from the source callable, stages each into
  host memory of the executor's own (:meth:`StreamExecutor.stage`: on the
  card a pinned slot, copied while the runner works on earlier blocks)
  and puts it in the queue. A full queue applies back-pressure (blocking
  mode) or drops the oldest block with an overrun counter (``drop=True``,
  the real-time mode);
* the **runner** keeps up to ``inflight`` steps dispatched on the card
  (``executor.dispatch`` does not wait for it; a staged block is only
  uploaded) before fetching the oldest, so the host's upload of the next
  blocks overlaps the card's work on earlier ones, and hands each named
  output ``(data, count)`` to its sink.

A source returns a dict of input blocks, or a ``(blocks, counts)`` pair
for a partial block (``counts`` as :meth:`StreamExecutor.dispatch` takes
them: the last block of a stream that ends mid-block). Its arrays are
copied before the pump calls it again, so it may reuse them. A source
returning ``None`` means "no data yet": with ``zero_fill=True`` the pump
feeds a zero block (underrun counter + 1) so sinks never stall, the
non_blocker semantic; otherwise the feeder retries. :meth:`stop` drains
the dispatched steps, gives back the slots of the blocks still queued,
and re-raises an error of the runner or of the staging.

While tracing records (``core.trace``) the pump records, under the
executor's ``stream_id`` and the block's dispatch index: ``pump.source``
(the feeder's call into the source; a call that brings no block has
index -1), ``pump.stage`` (the feeder's copy of the block, ``n`` its
bytes), ``pump.queue`` (from the feeder offering the staged block to the
queue to the runner taking it; ``n`` the blocks left queued behind it),
``pump.idle`` (the runner waiting on an empty queue) and ``pump.sinks``.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from grbaz_tpu_torch.core import trace
from grbaz_tpu_torch.core.executor import Staged

log = logging.getLogger(__name__)
_clock = time.perf_counter


class StreamPump:
    def __init__(self, executor, source: Callable[[], Optional[dict]],
                 sinks: Dict[str, Callable], depth: int = 2,
                 drop: bool = False, zero_fill: bool = False,
                 poll_interval: float = 0.002, inflight: int = 3):
        self.ex = executor
        self._stream = executor.stream_id
        self.source = source
        self.sinks = dict(sinks)
        self.depth = max(1, int(depth))
        self.inflight = max(1, int(inflight))
        self.drop = bool(drop)
        self.zero_fill = bool(zero_fill)
        self.poll = float(poll_interval)
        # staged blocks held at once: queued, in the feeder's and the
        # runner's hands, and the slots of the steps in flight
        self._slots = self.depth + self.inflight + 1
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._run = False
        self._feeder: Optional[threading.Thread] = None
        self._runner: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.blocks_in = 0
        self.blocks_out = 0
        self.underruns = 0
        self.overruns = 0
        self.staged = 0
        self._zero_block = {
            name: np.zeros(spec.shape, spec.dtype)
            for name, spec in executor.inputs.items()
        } if zero_fill else None

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._run:
            return
        self._run = True
        self._feeder = threading.Thread(target=self._feed_loop, daemon=True)
        self._runner = threading.Thread(target=self._run_loop, daemon=True)
        self._feeder.start()
        self._runner.start()

    def stop(self, timeout: float = 5.0):
        """Stop both threads; the runner first fetches and delivers every
        step it has dispatched, and the blocks still queued give their slots
        back. Raises what the runner or the staging raised, if any."""
        self._run = False
        for t in (self._feeder, self._runner):
            if t is not None:
                t.join(timeout=timeout)
        self._feeder = self._runner = None
        while True:
            try:
                self._q.get_nowait()[0].release()
            except queue.Empty:
                break
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def stats(self) -> dict:
        with self._lock:
            return dict(blocks_in=self.blocks_in, blocks_out=self.blocks_out,
                        underruns=self.underruns, overruns=self.overruns,
                        staged=self.staged, queued=self._q.qsize())

    # -- threads ---------------------------------------------------------
    def _feed_loop(self):
        while self._run:
            traced = trace.on()
            t = _clock() if traced else None
            try:
                blk = self.source()
            except Exception:  # a failing source reads as "no data yet"
                log.exception("StreamPump source raised")
                blk = None
            src = None if t is None else (t, _clock())  # the source call
            if blk is None:
                if src is not None:
                    trace.add("pump.source", self._stream, -1, *src)
                if self.zero_fill:
                    blk, src = self._zero_block, None
                    with self._lock:
                        self.underruns += 1
                else:
                    time.sleep(self.poll)
                    continue
            # a source's (ins, counts) pair is a partial block
            ins, counts = blk if isinstance(blk, tuple) else (blk, None)
            t = _clock() if traced else None
            try:
                staged = self.ex.stage(ins, counts, slots=self._slots)
            except Exception as e:  # a block the executor refuses: stop()
                self._error, self._run = e, False
                break
            stg = None if t is None else (t, _clock(), staged.nbytes)
            item = (staged, src, stg)
            if self.drop:
                while True:
                    try:
                        self._q.put_nowait(item)
                        break
                    except queue.Full:
                        try:  # drop the oldest: real-time mode
                            self._q.get_nowait()[0].release()
                            with self._lock:
                                self.overruns += 1
                        except queue.Empty:
                            pass
            else:
                while True:  # back-pressure: wait for space
                    try:
                        self._q.put(item, timeout=self.poll)
                        break
                    except queue.Full:
                        if not self._run:
                            staged.release()
                            break
            with self._lock:
                self.blocks_in += 1

    def _deliver(self, pend):
        """Fetch the oldest dispatched step and hand it to the sinks."""
        step = pend.popleft()
        outs = self.ex.fetch(step)
        span = trace.begin("pump.sinks", self._stream, step.seq) \
            if trace.on() else None
        for name, sink in self.sinks.items():
            if name in outs:
                data, count = outs[name]
                sink(data, count)
        if span is not None:
            trace.end(span)
        with self._lock:
            self.blocks_out += 1

    def _dispatch(self, item):
        staged, src, stg = item
        if stg is not None:  # staged while tracing recorded
            t, n = _clock(), self._q.qsize()
        step = self.ex.dispatch(staged)
        with self._lock:
            self.staged += isinstance(staged, Staged)
        if src is not None:
            trace.add("pump.source", self._stream, step.seq, *src)
        if stg is not None:
            trace.add("pump.stage", self._stream, step.seq, *stg)
            trace.add("pump.queue", self._stream, step.seq, stg[1], t, n)
        return step

    def _run_loop(self):
        pend = collections.deque()
        try:
            while self._run:
                while len(pend) < self.inflight:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    pend.append(self._dispatch(item))
                if pend:
                    self._deliver(pend)
                else:
                    span = trace.begin("pump.idle", self._stream) \
                        if trace.on() else None
                    try:
                        item = self._q.get(timeout=self.poll)
                    except queue.Empty:
                        item = None
                    if span is not None:
                        trace.end(span)
                    if item is not None:
                        pend.append(self._dispatch(item))
            while pend:  # drain in-flight work on stop
                self._deliver(pend)
        except BaseException as e:  # handed to stop(), which re-raises it
            self._error = e
            self._run = False
