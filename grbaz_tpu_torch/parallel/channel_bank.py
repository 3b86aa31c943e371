"""Dynamic channel bank: channels added and removed at runtime over one
wideband stream (port of ``grbaz_tpu/parallel/channel_bank.py``).

The bank is built once for ``capacity`` slots. Each slot has an LO
increment and an active flag in ``params``; ``add_channel``,
``remove_channel`` and ``retune`` write those device tensors in place
and never wait for the card. Inactive slots still compute, but their
outputs are zeroed and their state frozen, so a re-activated slot starts
where it stopped.

Every slot rotates the shared block by its LO, low-pass filters and
decimates it (B1's math), then FM-demodulates: the scanner front end of
BASELINE config 5. The state is the JAX package's, so a checkpoint loads
both ways: ``phase`` [C] (uint32 as int64), ``tail`` [C, tpad-1] of
ROTATED samples (the last ``tpad-1`` of ``x * lo``) and ``prev`` [C].

``backend``: the kernel arm (``'kernel'``, or ``'auto'`` on the card)
runs all slots in one launch of the bank's own kernel
(``ops/cuda/channel_bank.channel_bank``), which takes and gives back the
rotated tail as it is carried, so no tail is derotated or rotated on
the host; on CPU tensors that wrapper runs its plain version. The plain
arm (``'plain'``, or 'auto' on the CPU) is the JAX package's
rotate-then-filter (``channel_bank_plain``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.cuda.channel_bank import (channel_bank,
                                                   channel_bank_plain)
from grbaz_tpu_torch.ops.fir import BACKENDS, low_pass_taps, prepare_taps


class DynamicChannelBank(Block):
    """Wideband in -> [capacity, N/decim] FM-demodulated channels out.

    Outputs: (quad [C, N/decim] float32, active [C] uint8).
    """

    n_out = 2

    def __init__(self, capacity: int, sample_rate: float, decim: int,
                 channel_width: float, transition: float,
                 max_deviation: float = 5e3, name=None, backend: str = "auto",
                 device="cuda"):
        super().__init__(name)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.device = resolve_device(device)
        self.backend = backend
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self.decim = int(decim)
        taps = low_pass_taps(1.0, sample_rate,
                             channel_width / 2 + transition / 2, transition)
        self.h_rev_pad = torch.from_numpy(
            prepare_taps(taps, self.decim)).to(self.device)
        self.hist = self.h_rev_pad.shape[0] - 1
        self.demod_gain = float(np.float32(
            (sample_rate / decim) / (2 * np.pi * max_deviation)))
        self._slots: Dict[int, float] = {}  # host bookkeeping: slot -> freq

    # -- host control API (add/remove at runtime): each write is an
    # in-place fill on the card, queued after the steps already
    # dispatched and never waited for --------------------------------------
    def add_channel(self, params: dict, freq: float) -> int:
        """Activate a free slot at ``freq``; returns the slot id."""
        free = [i for i in range(self.capacity) if i not in self._slots]
        if not free:
            raise RuntimeError("channel bank at capacity")
        slot = free[0]
        self._slots[slot] = freq
        params["lo_inc"][slot] = int(
            exact.freq_to_turns_u32(-freq, self.sample_rate))
        params["active"][slot] = 1
        return slot

    def remove_channel(self, params: dict, slot: int):
        self._slots.pop(slot, None)
        params["active"][slot] = 0

    def retune(self, params: dict, slot: int, freq: float):
        if slot not in self._slots:
            raise KeyError(f"slot {slot} not active")
        self._slots[slot] = freq
        params["lo_inc"][slot] = int(
            exact.freq_to_turns_u32(-freq, self.sample_rate))

    def channels(self) -> Dict[int, float]:
        return dict(self._slots)

    # -- block protocol ------------------------------------------------------
    def init_state(self):
        c, dev = self.capacity, self.device
        return dict(phase=torch.zeros(c, dtype=torch.int64, device=dev),
                    tail=torch.zeros(c, self.hist, dtype=torch.complex64,
                                     device=dev),
                    prev=torch.ones(c, dtype=torch.complex64, device=dev))

    def init_params(self):
        c, dev = self.capacity, self.device
        return dict(lo_inc=torch.zeros(c, dtype=torch.int64, device=dev),
                    active=torch.zeros(c, dtype=torch.uint8, device=dev))

    def _use_kernel(self) -> bool:
        if self.backend == "plain":
            return False
        return self.backend == "kernel" or self.device.type == "cuda"

    def _channelize(self, x, phase0, inc, tail):
        """(rotated outputs [C, n/decim], new rotated tail [C, hist])."""
        if self._use_kernel():
            return channel_bank(x, tail, self.h_rev_pad, self.decim, phase0,
                                inc)
        return channel_bank_plain(x, tail, self.h_rev_pad, self.decim,
                                  phase0, inc)

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        active = params["active"].to(torch.bool)
        phase0, inc = state["phase"], params["lo_inc"]
        y, new_tail = self._channelize(x.data, phase0, inc, state["tail"])
        shifted = torch.cat([state["prev"][:, None], y[:, :-1]], dim=1)
        prod = y * torch.conj(shifted)
        quad = torch.atan2(prod.imag, prod.real) * self.demod_gain
        # inactive slots: outputs zeroed, state frozen
        new_state = dict(
            phase=torch.where(active, (phase0 + n * inc) & U32_MASK, phase0),
            tail=torch.where(active[:, None], new_tail, state["tail"]),
            prev=torch.where(active, y[:, -1], state["prev"]))
        quad = torch.where(active[:, None], quad, 0.0)
        out = Stream(quad, (x.count // self.decim).to(torch.int32),
                     x.meta.with_rate(x.meta.sample_rate / self.decim))
        # a copy: the host API writes the params in place later
        return new_state, (out, Stream(
            params["active"].to(torch.uint8, copy=True),
            scalar(self.capacity, torch.int32, x.data.device), x.meta))
