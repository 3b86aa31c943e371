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
  (the wait for the pinned buffer's previous upload and the copy into
  it), ``dispatch.upload``, ``dispatch.meta`` and ``dispatch.graph`` (the
  step's launches), then ``fetch.wait`` (on a CUDA event recorded after
  those launches) and ``fetch.copy``.
* On the card ``fetch`` copies on the executor's own copy stream, after
  that end-of-step event: the copies wait for their step alone, not for
  the steps queued behind it on the compute stream (this executor's in
  flight, or other executors' sharing the stream).
"""

from __future__ import annotations

import dataclasses
import itertools
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


class _Uploader:
    """Two pinned host buffers for one input, used in turn (on the CPU
    each block is simply copied: block states may keep views of it)."""

    def __init__(self, spec: InputSpec, device: torch.device):
        self.device = device
        self.bufs, self.done, self.turn = [], [None, None], 0
        if device.type == "cuda":
            dtype = torch.from_numpy(np.zeros(0, spec.dtype)).dtype
            self.bufs = [torch.empty(spec.shape, dtype=dtype,
                                     pin_memory=True) for _ in range(2)]

    def upload(self, x: np.ndarray, traced: bool = False) -> torch.Tensor:
        span = trace.begin("dispatch.stage") if traced else None
        if self.device.type != "cuda":
            host = np.array(x)
            if traced:
                trace.end(span, host.nbytes)
                span = trace.begin("dispatch.upload")
            dev = torch.from_numpy(host)
        else:
            i, self.turn = self.turn, 1 - self.turn
            if self.done[i] is not None:
                self.done[i].synchronize()  # the copy out of bufs[i] finished
            self.bufs[i].numpy()[...] = x
            if traced:
                trace.end(span, x.nbytes)
                span = trace.begin("dispatch.upload")
            dev = self.bufs[i].to(self.device, non_blocking=True)
            self.done[i] = torch.cuda.Event()
            self.done[i].record()
        if traced:
            trace.end(span)
        return dev


def _to_host(outs) -> Dict[str, Tuple[np.ndarray, int]]:
    return {name: (s.data.cpu().numpy(), int(s.count))
            for name, s in outs.items()}


class StreamExecutor:
    """Host-side streaming driver for a Flowgraph."""

    def __init__(self, graph: Flowgraph, inputs: Dict[str, InputSpec],
                 device="cuda"):
        self.graph = graph
        self.device = resolve_device(device)
        self.inputs = dict(inputs)
        missing = set(graph.in_ports) - set(self.inputs)
        if missing:
            raise ValueError(f"no InputSpec for graph inputs {missing}")
        self._step_fn = graph.build_step()
        self._uploaders = {name: _Uploader(spec, self.device)
                           for name, spec in self.inputs.items()}
        self._states = None
        self._meta = None
        self.params = graph.init_params()  # host-side, caller may mutate
        self.stream_id = next(_STREAM_IDS)
        self.seq = 0  # the next dispatch's index
        self._copy = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # id(outs) -> (seq, end-of-step event) of the steps not yet fetched
        # (on the card, or traced)
        self._pending = {}
        self._events = []  # end-of-step events free for reuse

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        self._states = self.graph.init_states()
        self._meta = {name: StreamMeta.start(self.inputs[name].sample_rate,
                                             device=self.device)
                      for name in self.graph.in_ports}
        self._pending.clear()
        return self

    # -- stepping ----------------------------------------------------------
    def dispatch(self, ins: Dict[str, np.ndarray],
                 counts: Optional[Dict[str, int]] = None,
                 params: Optional[Dict[str, Any]] = None):
        """Queue one block on the card without waiting for it; returns
        the output streams, still on the device, for :meth:`fetch`. Steps
        chain through the states on the device, so several can be in
        flight (:class:`~grbaz_tpu_torch.core.pump.StreamPump` keeps
        ``inflight`` of them pending)."""
        seq, self.seq = self.seq, self.seq + 1
        traced = trace.on()
        top = trace.begin("executor.dispatch", self.stream_id, seq) \
            if traced else None
        if self._states is None:
            self.reset()
        if params is not None:
            self.params = params
        names = {b.name for b in self.graph.blocks}
        unknown = set(self.params) - names
        if unknown:
            raise KeyError(f"params for unknown blocks {sorted(unknown)}; "
                           f"valid names: {sorted(names)}")
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
            data = self._uploaders[name].upload(x, traced)
            span = trace.begin("dispatch.meta") if traced else None
            count = scalar(c, torch.int32, self.device)
            meta = self._meta[name]
            streams[name] = Stream(data, count, meta)
            self._meta[name] = meta.advanced(count)
            if traced:
                trace.end(span)
        span = trace.begin("dispatch.graph") if traced else None
        self._states, outs = self._step_fn(self._states, dev_params, streams)
        if traced:
            trace.end(span)
        if traced or self._copy is not None:
            done = None
            if self._copy is not None:  # the end of the step's launches
                done = self._events.pop() if self._events \
                    else torch.cuda.Event()
                done.record()
            if len(self._pending) > 64:  # steps dispatched but never fetched
                self._pending.clear()
            self._pending[id(outs)] = (seq, done)
        if traced:
            trace.end(top)
        return outs

    def fetch(self, outs) -> Dict[str, Tuple[np.ndarray, int]]:
        """Wait for a dispatched step's outputs and bring them to the host."""
        traced = trace.on()
        seq, done = self._pending.pop(id(outs), (-1, None))
        if traced:
            top = trace.begin("executor.fetch", self.stream_id, seq)
            span = trace.begin("fetch.wait")
            if done is not None:
                done.synchronize()
            trace.end(span)
            span = trace.begin("fetch.copy")
        if done is not None:
            self._copy.wait_event(done)
            with torch.cuda.stream(self._copy):
                got = _to_host(outs)
            self._events.append(done)
        else:
            got = _to_host(outs)
        if traced:
            trace.end(span, sum(d.nbytes for d, _ in got.values()))
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
        checkpoint.save_state(path, self._states, self.params, extra)

    def restore(self, path: str) -> Dict[str, np.ndarray]:
        """Resume from a checkpoint of :meth:`save` (or any file of the
        same layout; an input without meta entries starts at sample 0).
        Validates it against this graph's init trees; returns the
        caller's ``extra`` entries."""
        states, params, extra = checkpoint.load_state(
            path, self.graph.init_states(), self.graph.init_params())
        self.reset()
        self._states, self.params = states, params
        for name, meta in self._meta.items():
            fields = {f: extra.pop(f"meta/{name}/{f}") for f in _META_FIELDS
                      if f"meta/{name}/{f}" in extra}
            self._meta[name] = dataclasses.replace(meta, **{
                f: params_from_numpy(v, self.device)
                for f, v in fields.items()})
        return extra

    def run(self, blocks: Iterable[Dict[str, np.ndarray]]):
        """Generator over an iterator of input-block dicts."""
        for ins in blocks:
            yield self.step(ins)
