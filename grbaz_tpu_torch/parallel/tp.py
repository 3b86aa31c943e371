"""Tap-sharded decimating FIR over the ranks of a mesh dim (port of
``grbaz_tpu/parallel/tp.py``).

The taps of a filter too long for one card are split over the dim
``'tp'``: rank p owns tap chunk ``h[p*T/P : (p+1)*T/P]``, convolves it
against the frame shifted by ``p*chunk`` and a ``psum`` over the dim
sums the partials into the full output on every rank. Each output is a
sum of disjoint partial sums, so it regroups the serial sum's terms
only in float32 rounding.

Each rank's partial is a plain decimating FIR: the CUDA kernel B3
(``ops/cuda/fir_decimate.fir_decimate_frame``) on the card, its plain
polyphase product on the CPU.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.cuda.fir_decimate import fir_decimate_frame
from grbaz_tpu_torch.parallel._collectives import dim, mesh_device, psum


def shard_taps(taps: Sequence[float], decim: int, n_shards: int) -> np.ndarray:
    """Reverse + pad taps to ``n_shards`` equal chunks of a multiple of
    ``decim`` each. Returns ``[n_shards, chunk]`` (chunk = padded_T /
    n_shards); the concatenation equals ``prepare_taps`` output padded
    at the *front* (leading zeros shift harmlessly — they multiply
    samples older than the filter span, which the frame provides)."""
    h_rev = np.asarray(taps, np.float32)[::-1]
    chunk = int(math.ceil(len(h_rev) / (decim * n_shards))) * decim
    tpad = chunk * n_shards
    h = np.concatenate([np.zeros(tpad - len(h_rev), np.float32), h_rev])
    return h.reshape(n_shards, chunk)


def tp_fir_decimate(frame: torch.Tensor, h_chunk: torch.Tensor, decim: int,
                    mesh: DeviceMesh, axis: str = "tp") -> torch.Tensor:
    """The full decimated output of ``frame`` (the same on every rank)
    from this rank's tap chunk ``h_chunk`` [1, chunk] of the [P, chunk]
    bank: rank p's partial is ``sum_t h[p*chunk + t] * frame[k*decim +
    p*chunk + t]``, a decimating FIR over the frame shifted by
    ``p*chunk``."""
    group, p, n_shards = dim(mesh, axis)
    chunk = h_chunk.shape[-1]
    tpad = chunk * n_shards
    n_out = (frame.shape[0] - (tpad - 1)) // decim
    # fir_decimate_frame wants (chunk-1) samples of history and then
    # n_out*decim new ones; for p = P-1 this ends at the frame's end
    start = p * chunk
    local = frame[start:start + chunk - 1 + n_out * decim]
    partial = fir_decimate_frame(local, h_chunk.reshape(chunk), decim)
    return psum(partial, group)


class TPFIRDecimator(Block):
    """Tap-sharded decimating FIR block over the mesh dim ``axis``.

    The streaming contract of ``ops.fir.FIRDecimator`` (the carried tail
    is the filter history, ``tpad - 1`` samples), with the taps sharded:
    ``init_params()['h']`` is this rank's row ``[1, chunk]`` of the
    ``[P, chunk]`` bank (``h_chunks``). Every rank feeds the same block
    and gets the same output."""

    def __init__(self, taps, decim: int, mesh: DeviceMesh, axis: str = "tp",
                 dtype=torch.complex64, name=None):
        super().__init__(name)
        self.decim = int(decim)
        self.mesh = mesh
        self.axis = axis
        self.device = mesh_device(mesh)
        _, self.rank, self.n_shards = dim(mesh, axis)
        self.h_chunks = shard_taps(taps, self.decim, self.n_shards)
        self.tpad = self.h_chunks.size
        self.hist = self.tpad - 1
        self.dtype = dtype

    def init_state(self):
        return dict(tail=torch.zeros(self.hist, dtype=self.dtype,
                                     device=self.device))

    def init_params(self):
        return dict(h=torch.from_numpy(
            self.h_chunks[self.rank:self.rank + 1].copy()).to(self.device))

    def _run(self, tail, h, x):
        frame = torch.cat([tail, x])
        y = tp_fir_decimate(frame, h, self.decim, self.mesh, self.axis)
        return frame[-self.hist:], y

    def make_step(self):
        """``(state, params, x_data) -> (state', y)`` on raw tensors."""
        def step(state, params, x):
            tail, y = self._run(state["tail"], params["h"], x)
            return dict(tail=tail), y
        return step

    def apply(self, state, params, x: Stream):
        tail, y = self._run(state["tail"], params["h"], x.data)
        out = x.like(y, count=x.count // self.decim,
                     rate_scale=1.0 / self.decim)
        return dict(tail=tail), (out,)
