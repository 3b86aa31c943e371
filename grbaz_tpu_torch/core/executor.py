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
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from grbaz_tpu_torch.convert import params_from_numpy
from grbaz_tpu_torch.core import checkpoint
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

    def upload(self, x: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(x))
        i, self.turn = self.turn, 1 - self.turn
        if self.done[i] is not None:
            self.done[i].synchronize()  # the copy out of bufs[i] finished
        self.bufs[i].numpy()[...] = x
        dev = self.bufs[i].to(self.device, non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return dev


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
        self.stats = dict(steps=0, samples_in=0, wall_time=0.0)

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        self._states = self.graph.init_states()
        self._meta = {name: StreamMeta.start(self.inputs[name].sample_rate,
                                             device=self.device)
                      for name in self.graph.in_ports}
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
        if self._states is None:
            self.reset()
        if params is not None:
            self.params = params
        names = {b.name for b in self.graph.blocks}
        unknown = set(self.params) - names
        if unknown:
            raise KeyError(f"params for unknown blocks {sorted(unknown)}; "
                           f"valid names: {sorted(names)}")
        dev_params = params_from_numpy(self.params, self.device)
        streams = {}
        n_in = 0
        for name, spec in self.inputs.items():
            x = np.asarray(ins[name])
            if x.dtype.name != spec.dtype or tuple(x.shape) != spec.shape:
                raise ValueError(
                    f"input {name}: expected {spec.dtype}{spec.shape}, "
                    f"got {x.dtype.name}{x.shape}")
            c = int((counts or {}).get(name, x.shape[0]))
            n_in += c
            count = scalar(c, torch.int32, self.device)
            meta = self._meta[name]
            streams[name] = Stream(self._uploaders[name].upload(x), count,
                                   meta)
            self._meta[name] = meta.advanced(count)
        self._states, outs = self._step_fn(self._states, dev_params, streams)
        self.stats["steps"] += 1
        self.stats["samples_in"] += n_in
        return outs

    def fetch(self, outs) -> Dict[str, Tuple[np.ndarray, int]]:
        """Wait for a dispatched step's outputs and bring them to the host."""
        return {name: (s.data.cpu().numpy(), int(s.count))
                for name, s in outs.items()}

    def step(self, ins: Dict[str, np.ndarray],
             counts: Optional[Dict[str, int]] = None,
             params: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Tuple[np.ndarray, int]]:
        """Process one block. Returns {out_port: (np_data, valid_count)}."""
        t0 = time.monotonic()
        result = self.fetch(self.dispatch(ins, counts, params))
        self.stats["wall_time"] += time.monotonic() - t0
        return result

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

    def throughput(self) -> float:
        """Host-observed samples/s over all steps so far."""
        return (self.stats["samples_in"] / self.stats["wall_time"]
                if self.stats["wall_time"] else 0.0)

    @contextlib.contextmanager
    def profile(self, log_dir: str):
        """Capture a torch.profiler trace (chrome format, written to
        ``log_dir/trace.json``) of the steps run inside the context."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield self
        prof.export_chrome_trace(f"{log_dir}/trace.json")

    def run(self, blocks: Iterable[Dict[str, np.ndarray]]):
        """Generator over an iterator of input-block dicts."""
        for ins in blocks:
            yield self.step(ins)
