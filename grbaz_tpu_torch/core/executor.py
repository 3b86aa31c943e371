"""Streaming host executor — feeds a flowgraph from host data (port of
``grbaz_tpu/core/executor.py``, the driver behind the rtl_fm app).

* It owns the source metadata (absolute sample counters, sequence
  numbers) as device state, so stream time stays exact without host work.
* Block states stay on the device between steps.
* Inputs are copied in their own dtype into pinned host slots and
  uploaded with ``non_blocking=True``. Each input has a ring of slots; a
  slot is written again only once the upload that last read it has
  finished. :meth:`StreamExecutor.stage` makes that copy ahead of the
  dispatch, on the caller's thread (a pump's feeder), and
  :meth:`StreamExecutor.dispatch` takes its :class:`Staged` block or, given
  raw arrays, stages them itself.
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
  block's dispatch index ``seq``: ``dispatch.stage`` (for raw arrays the
  copy into a pinned slot, ``n`` its bytes; for a staged block what is left
  of staging, ``n`` 0), ``dispatch.params``, ``dispatch.upload``,
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
the staging and the waits on the card come before it, the waits on
events that put the thread to sleep (``blocking=True``): staging's wait
for its slot's last upload, and ``fetch``'s wait for its step while
other executors have steps in flight (alone, an executor's copies wait
for the step themselves, without the sleep's wake-up). The spans of the
lock's turn are the parts of ``executor.dispatch`` and
``executor.fetch`` that no child covers. On the CPU there are no
streams, no slots and no lock: each block is copied afresh (states may
keep views of it), and the order is the call order.
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
    after ``done``), dispatch index ``seq``, end event (None on the CPU) and
    the :class:`Staged` block it uploaded (its slots; each slot's ``done``
    event in its ring is that upload's until the slot is taken again)."""
    __slots__ = ("_outs", "seq", "done", "staged")

    def __init__(self, outs, seq: int, done, staged):
        self._outs, self.seq, self.done = outs, seq, done
        self.staged = staged


class _Slots:
    """The ring of pinned host slots of one input and the events of their
    last uploads. A slot is taken, written, and given back once its upload
    is queued (or, unused, by :meth:`Staged.release`); the slot given back
    first is taken first, and written only after its last upload has
    finished. On the CPU there are no slots."""

    def __init__(self, spec: InputSpec, device: torch.device):
        self.spec = spec
        self.cuda = device.type == "cuda"
        self.bufs, self.done = [], []
        self.free = collections.deque()  # slot indices, oldest given back first
        self.lock = threading.Lock()

    def fill(self, x: np.ndarray, size: int):
        """``(host tensor, slot)``: the block copied to host memory of its
        own. On the card into a slot of a ring of at least ``size`` slots
        (one more where every slot is held), once that slot's last upload
        has finished (asleep); on the CPU a fresh copy, slot None."""
        if not self.cuda:
            return torch.from_numpy(np.array(x)), None
        with self.lock:
            while len(self.bufs) < size or not self.free:
                self.free.append(len(self.bufs))
                self.bufs.append(torch.empty(
                    self.spec.shape, pin_memory=True,
                    dtype=torch.from_numpy(np.zeros(0, self.spec.dtype)).dtype))
                self.done.append(torch.cuda.Event(blocking=True))
            i = self.free.popleft()
        if not self.done[i].query():  # (a finished one costs no GIL handoff)
            self.done[i].synchronize()
        self.bufs[i].numpy()[...] = x
        return self.bufs[i], i

    def give(self, i: int):
        with self.lock:
            self.free.append(i)


class Staged:
    """One block copied into host memory of its own by
    :meth:`StreamExecutor.stage`, for one :meth:`StreamExecutor.dispatch` of
    the same executor: each input's host tensor and slot (None on the CPU),
    valid count and the bytes copied. Its slots stay held until the
    dispatch has queued their uploads, or :meth:`release` gives them back."""
    __slots__ = ("owner", "hosts", "slots", "counts", "nbytes")

    def __init__(self, owner, hosts, slots, counts, nbytes):
        self.owner, self.hosts, self.slots = owner, hosts, slots
        self.counts, self.nbytes = counts, nbytes

    def take(self, ex) -> Dict[str, torch.Tensor]:
        """The host tensors, once, for ``ex``'s dispatch."""
        if self.owner is not ex:
            raise ValueError("a block staged by another executor")
        if self.hosts is None:
            raise ValueError("a staged block already dispatched or released")
        hosts, self.hosts = self.hosts, None
        return hosts

    def release(self):
        """Give the slots back unused (a block dropped, never dispatched)."""
        if self.hosts is not None:
            self.hosts = None
            for name, i in self.slots.items():
                if i is not None:
                    self.owner._slots[name].give(i)


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
        self._slots = {name: _Slots(spec, self.device)
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
    def stage(self, ins: Dict[str, np.ndarray],
              counts: Optional[Dict[str, int]] = None,
              slots: int = 2) -> Staged:
        """Copy one block into host memory of its own, ahead of its
        :meth:`dispatch`: on the card into the next free pinned slot of each
        input's ring, once that slot's last upload has finished (asleep),
        outside the host lock. ``slots``: the least number of slots the
        ring keeps, at least the staged blocks the caller holds plus the
        steps it keeps in flight plus one, so that no copy waits.
        ``counts`` marks a partial block, as in :meth:`dispatch`."""
        xs = {}
        for name, spec in self.inputs.items():
            x = xs[name] = np.asarray(ins[name])
            if x.dtype.name != spec.dtype or tuple(x.shape) != spec.shape:
                raise ValueError(
                    f"input {name}: expected {spec.dtype}{spec.shape}, "
                    f"got {x.dtype.name}{x.shape}")
        hosts, held = {}, {}
        for name, x in xs.items():
            hosts[name], held[name] = self._slots[name].fill(x, slots)
        return Staged(self, hosts, held,
                      {name: int((counts or {}).get(name, x.shape[0]))
                       for name, x in xs.items()},
                      sum(x.nbytes for x in xs.values()))

    def dispatch(self, ins, counts: Optional[Dict[str, int]] = None,
                 params: Optional[Dict[str, Any]] = None) -> Step:
        """Queue one block on the card without waiting for it; returns its
        :class:`Step`, for :meth:`fetch`. ``ins`` is a :class:`Staged` block
        of :meth:`stage` (which carries its counts) or a dict of host
        arrays, staged here. Steps chain through the states on the
        device, so several can be in flight
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
        span = trace.begin("dispatch.stage") if traced else None
        if isinstance(ins, Staged):
            if counts is not None:
                raise ValueError("a staged block carries its own counts")
            staged, copied = ins, 0
        else:
            staged = self.stage(ins, counts)
            copied = staged.nbytes
        hosts = staged.take(self)
        if traced:
            trace.end(span, copied)
        with self._host, torch.cuda.stream(self._compute):
            span = trace.begin("dispatch.params") if traced else None
            dev_params = params_from_numpy(self.params, self.device)
            if traced:
                trace.end(span)
            streams = {}
            for name, host in hosts.items():
                span = trace.begin("dispatch.upload") if traced else None
                data = host.to(self.device, non_blocking=True)
                i = staged.slots[name]
                if i is not None:  # the slot is free once this upload is
                    self._slots[name].done[i].record()
                    self._slots[name].give(i)
                if traced:
                    trace.end(span)
                span = trace.begin("dispatch.meta") if traced else None
                count = scalar(staged.counts[name], torch.int32, self.device)
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
            step = Step(outs, seq, done, staged)
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
