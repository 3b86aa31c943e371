"""Streaming host executor — feeds a flowgraph from host data (port of
``grbaz_tpu/core/executor.py``, the driver behind the rtl_fm app).

* It owns the source metadata (absolute sample counters, sequence
  numbers) as device state, so stream time stays exact without host work.
* Block states stay on the device between steps.
* Inputs are copied in their own dtype into pinned host buffers and
  uploaded with ``non_blocking=True``; two buffers per input alternate,
  so the next block's copy never overwrites one still in flight.
* Outputs come back with their valid counts; ``counts=`` marks a
  partial last block.
* ``params`` is a host-side dict the caller may change between steps
  (``ex.params[block_name] = ...``); its host values are uploaded each
  step from pinned memory without blocking, so
  :meth:`StreamExecutor.dispatch` never waits for the card and several
  steps can be in flight; :meth:`StreamExecutor.fetch` waits.
* :meth:`StreamExecutor.save` / :meth:`StreamExecutor.restore` checkpoint
  the block states, the params and each input's stream position
  (``core.checkpoint``, the JAX package's file layout).
* While tracing records (``core.trace``), ``dispatch`` and ``fetch``
  record their parts as spans of the executor's ``stream_id`` and the
  block's dispatch index ``seq``: ``dispatch.params``, ``dispatch.stage``
  (the copy into the pinned buffer), ``dispatch.upload``,
  ``dispatch.meta`` and ``dispatch.graph`` (the step's launches; ``n``:
  the steps of other executors dispatched and not yet fetched as they
  start, the work that can run beside them), then ``fetch.wait`` (on a
  CUDA event recorded after those launches) and ``fetch.copy``.

On the card each executor owns two streams. Every launch and allocation
of ``reset``, ``dispatch`` (params, upload, meta, the graph step),
``save`` and ``restore`` runs on its compute stream, so the steps of
several executors (one a recorded pass, a dongle, a channel) run side
by side on the card instead of in a row on one shared stream. ``reset``
and ``restore`` first make the compute stream wait for the stream
current at the call, so what was made there before (the Blocks'
constants, a warm-up) is ready before the first step reads it.
``fetch`` copies on the executor's copy stream after the step's end
event: the copies wait for their step alone, not for the steps queued
behind it. :meth:`StreamExecutor.dispatch` returns a :class:`Step`,
which holds the step's outputs, still on the device and valid only
after that event, for ``fetch`` (or ``step``) to read.

Several executors are driven by as many host threads (a pump's runner
each), and threads that call into torch and the driver a call at a time
in turn slow each other down: on an H100's host, eight lrpt executors
gave 875 steps a second from one thread and 177 from eight. So on the
card the host work of ``dispatch`` and ``fetch`` (uploads, launches,
copies) takes one lock that every executor of the process shares, and
the waits on the card come before it, on events that put the thread to
sleep (``blocking=True``): the wait for the pinned buffer's previous
upload, and ``fetch``'s wait for its step while other executors have
steps in flight (alone, an executor's copies wait for the step
themselves, without the sleep's wake-up). The spans of the lock's turn
are the parts of ``executor.dispatch`` and ``executor.fetch`` that no
child covers. On the CPU there are no streams and no lock, and the order
is the call order.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from grbaz_tpu_torch.convert import params_from_numpy
from grbaz_tpu_torch.core import checkpoint, trace
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.stream import Stream, StreamMeta


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Static description of an executor input port."""
    shape: Tuple[int, ...]
    dtype: str
    sample_rate: float = 1.0


_META_FIELDS = ("abs_lo", "abs_hi", "epoch_sec", "epoch_frac", "flags", "seq")
_STREAM_IDS = itertools.count()
# on the card, the host work of every executor's dispatch and fetch
_HOST = threading.RLock()
# every executor's steps dispatched and not yet fetched, changed under
# _HOST: the work beside a step (``dispatch.graph``'s ``n``, ``fetch``'s sleep)
_in_flight = 0


def _count(k: int):
    """Add ``k`` to every executor's steps in flight."""
    global _in_flight
    with _HOST:
        _in_flight += k


class Step:
    """A dispatched step for :meth:`StreamExecutor.fetch`: its outputs (valid
    after ``done``), dispatch index ``seq`` and end event (None on the CPU)."""
    __slots__ = ("_outs", "seq", "done")

    def __init__(self, outs, seq: int, done):
        self._outs, self.seq, self.done = outs, seq, done


class _Uploader:
    """Two pinned host buffers for one input and their uploads' events, used
    in turn (on the CPU each block is copied: states may keep views of it)."""

    def __init__(self, spec: InputSpec, device: torch.device):
        self.device = device
        self.bufs, self.done, self.turn = [], [], 0
        if device.type == "cuda":
            dtype = torch.from_numpy(np.zeros(0, spec.dtype)).dtype
            self.bufs = [torch.empty(spec.shape, dtype=dtype,
                                     pin_memory=True) for _ in range(2)]
            self.done = [torch.cuda.Event(blocking=True) for _ in range(2)]

    def ready(self):
        """Wait, asleep, until the buffer the next upload takes is free
        (its previous upload has finished)."""
        if self.done:
            self.done[self.turn].synchronize()

    def stage(self, x: np.ndarray) -> torch.Tensor:
        """The block copied to host memory of its own (after :meth:`ready`)."""
        if not self.bufs:
            return torch.from_numpy(np.array(x))
        self.bufs[self.turn].numpy()[...] = x
        return self.bufs[self.turn]

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        """The staged block on the device, on the current stream."""
        dev = host.to(self.device, non_blocking=True)
        if self.done:
            self.done[self.turn].record()
            self.turn = 1 - self.turn
        return dev


class StreamExecutor:
    """Host-side streaming driver for a Flowgraph."""

    def __init__(self, graph: Flowgraph, inputs: Dict[str, InputSpec],
                 device="cuda"):
        # the Steps not yet fetched, oldest first; past 64 the oldest drops out
        self._flight = collections.deque(maxlen=64)
        self.graph = graph
        self.device = resolve_device(device)
        self.inputs = dict(inputs)
        missing = set(graph.in_ports) - set(self.inputs)
        if missing:
            raise ValueError(f"no InputSpec for graph inputs {missing}")
        self._step_fn = graph.build_step()
        self._names = {b.name for b in graph.blocks}
        self._uploaders = {name: _Uploader(spec, self.device)
                           for name, spec in self.inputs.items()}
        self._states = None
        self._meta = None
        self.params = graph.init_params()  # host-side, caller may mutate
        self.stream_id = next(_STREAM_IDS)
        self.seq = 0  # the next dispatch's index
        cuda = self.device.type == "cuda"
        self._compute = torch.cuda.Stream(self.device) if cuda else None
        self._copy = torch.cuda.Stream(self.device) if cuda else None
        self._host = _HOST if cuda else contextlib.nullcontext()
        self._events = []  # end-of-step events free for reuse

    def __del__(self):  # dropped with steps in flight: they leave the count
        if self._flight:
            _count(-len(self._flight))

    def _after_caller(self):
        """The compute stream as the current one (a no-op on the CPU),
        after the work queued so far on the caller's current stream."""
        if self._compute is not None:
            self._compute.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._compute)

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        with self._after_caller():
            self._states = self.graph.init_states()
            self._meta = {name: StreamMeta.start(
                self.inputs[name].sample_rate, device=self.device)
                for name in self.graph.in_ports}
        _count(-len(self._flight))
        self._flight.clear()
        return self

    # -- stepping ----------------------------------------------------------
    def dispatch(self, ins: Dict[str, np.ndarray],
                 counts: Optional[Dict[str, int]] = None,
                 params: Optional[Dict[str, Any]] = None) -> Step:
        """Queue one block on the card without waiting for it; returns its
        :class:`Step`, for :meth:`fetch`. Steps chain through the states
        on the device, so several can be in flight
        (:class:`~grbaz_tpu_torch.core.pump.StreamPump` keeps ``inflight``
        of them pending)."""
        seq, self.seq = self.seq, self.seq + 1
        traced = trace.on()
        top = trace.begin("executor.dispatch", self.stream_id, seq) \
            if traced else None
        if self._states is None:
            self.reset()
        if params is not None:
            self.params = params
        unknown = set(self.params) - self._names
        if unknown:
            raise KeyError(f"params for unknown blocks {sorted(unknown)}; "
                           f"valid names: {sorted(self._names)}")
        for up in self._uploaders.values():
            up.ready()
        with self._host, torch.cuda.stream(self._compute):
            span = trace.begin("dispatch.params") if traced else None
            dev_params = params_from_numpy(self.params, self.device)
            if traced:
                trace.end(span)
            streams = {}
            for name, spec in self.inputs.items():
                x = np.asarray(ins[name])
                if x.dtype.name != spec.dtype or tuple(x.shape) != spec.shape:
                    raise ValueError(
                        f"input {name}: expected {spec.dtype}{spec.shape}, "
                        f"got {x.dtype.name}{x.shape}")
                c = int((counts or {}).get(name, x.shape[0]))
                up = self._uploaders[name]
                span = trace.begin("dispatch.stage") if traced else None
                host = up.stage(x)
                if traced:
                    trace.end(span, x.nbytes)
                    span = trace.begin("dispatch.upload")
                data = up.upload(host)
                if traced:
                    trace.end(span)
                span = trace.begin("dispatch.meta") if traced else None
                count = scalar(c, torch.int32, self.device)
                meta = self._meta[name]
                streams[name] = Stream(data, count, meta)
                self._meta[name] = meta.advanced(count)
                if traced:
                    trace.end(span)
            if traced:
                beside = _in_flight - len(self._flight)
                span = trace.begin("dispatch.graph")
            self._states, outs = self._step_fn(self._states, dev_params,
                                               streams)
            if traced:
                trace.end(span, beside)
            done = None
            if self._copy is not None:  # the end of the step's launches
                done = self._events.pop() if self._events \
                    else torch.cuda.Event(blocking=True)
                done.record(self._compute)
            step = Step(outs, seq, done)
            if len(self._flight) < self._flight.maxlen:  # else one drops out
                _count(1)
            self._flight.append(step)
        if traced:
            trace.end(top)
        return step

    def fetch(self, step: Step) -> Dict[str, Tuple[np.ndarray, int]]:
        """Wait for a dispatched step's outputs and bring them to the host."""
        traced = trace.on()
        done = step.done
        if traced:
            top = trace.begin("executor.fetch", self.stream_id, step.seq)
            span = trace.begin("fetch.wait")
        if done is not None and (traced or _in_flight > len(self._flight)):
            done.synchronize()  # asleep, while other executors' work runs
        if traced:
            trace.end(span)
        with self._host:
            span = trace.begin("fetch.copy") if traced else None
            if done is not None:
                self._copy.wait_event(done)
                self._events.append(done)
            with torch.cuda.stream(self._copy):
                got = {name: (s.data.cpu().numpy(), int(s.count))
                       for name, s in step._outs.items()}
            if step in self._flight:  # not dropped by reset, or as the oldest
                self._flight.remove(step)
                _count(-1)
            if traced:
                trace.end(span, sum(d.nbytes for d, _ in got.values()))
        if traced:
            trace.end(top)
        return got

    def step(self, ins: Dict[str, np.ndarray],
             counts: Optional[Dict[str, int]] = None,
             params: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Tuple[np.ndarray, int]]:
        """Process one block. Returns {out_port: (np_data, valid_count)}."""
        return self.fetch(self.dispatch(ins, counts, params))

    # -- checkpoint ----------------------------------------------------------
    def save(self, path: str, extra: Optional[Dict[str, Any]] = None):
        """Checkpoint the block states, the params and each input's
        stream meta (as ``extra`` entries ``meta/<input>/<field>``) to
        ``path`` (.npz). Waits for the steps dispatched so far."""
        if self._states is None:
            self.reset()
        extra = dict(extra or {})
        for name, meta in self._meta.items():
            for field in _META_FIELDS:
                extra[f"meta/{name}/{field}"] = getattr(meta, field)
        with torch.cuda.stream(self._compute):
            checkpoint.save_state(path, self._states, self.params, extra)

    def restore(self, path: str) -> Dict[str, np.ndarray]:
        """Resume from a checkpoint of :meth:`save` (or any file of the
        same layout; an input without meta entries starts at sample 0).
        Validates it against this graph's init trees; returns the
        caller's ``extra`` entries."""
        with self._after_caller():
            states, params, extra = checkpoint.load_state(
                path, self.graph.init_states(), self.graph.init_params())
        self.reset()
        self._states, self.params = states, params
        with torch.cuda.stream(self._compute):
            for name, meta in self._meta.items():
                fields = {f: extra.pop(f"meta/{name}/{f}")
                          for f in _META_FIELDS
                          if f"meta/{name}/{f}" in extra}
                self._meta[name] = dataclasses.replace(meta, **{
                    f: params_from_numpy(v, self.device)
                    for f, v in fields.items()})
        return extra

    def run(self, blocks: Iterable[Dict[str, np.ndarray]]):
        """Generator over an iterator of input-block dicts."""
        for ins in blocks:
            yield self.step(ins)
