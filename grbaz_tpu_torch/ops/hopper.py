"""In-graph frequency-hop demux (port of ``grbaz_tpu/ops/hopper.py``).

The hop schedule is deterministic (a fixed dwell on the absolute sample
grid), so each sample's frequency is a function of its index: every
block computes its dwell phase from a small int32 carry, drops the
``drop_length`` retune transient after each hop, and compacts each
frequency's samples to the front of its output lane (a running count
gives each kept sample its slot, one scatter places them all).
"""

from __future__ import annotations

import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream


class HopperDemux(Block):
    """Demux a hopped RX stream into ``n_freqs`` lanes: ``dwell`` samples
    a frequency, cycling through the channels, the first ``drop_length``
    samples after each retune discarded. Lane i holds its kept samples
    first, with their number as its count."""

    def __init__(self, n_freqs: int, dwell: int, drop_length: int = 0,
                 name=None, device="cuda"):
        super().__init__(name)
        if not 0 <= drop_length < dwell:
            raise ValueError("need 0 <= drop_length < dwell")
        self.device = resolve_device(device)
        self.n_freqs = int(n_freqs)
        self.dwell = int(dwell)
        self.drop_length = int(drop_length)
        self.n_out = self.n_freqs

    def init_state(self):
        return dict(chan=scalar(0, torch.int32, self.device),  # frequency
                    off=scalar(0, torch.int32, self.device))   # in the dwell

    def apply(self, state, params, x: Stream):
        n = x.capacity
        d, f = self.dwell, self.n_freqs
        dev = x.data.device
        i = torch.arange(n, dtype=torch.int32, device=dev)
        pos = state["off"] + i
        chan = (state["chan"] + torch.div(pos, d, rounding_mode="floor")) % f
        keep = (pos % d >= self.drop_length) & (i < x.count)
        sel = (chan[None, :] == torch.arange(f, dtype=torch.int32,
                                             device=dev)[:, None]) \
            & keep[None, :]                                     # [F, N]
        # each kept sample's slot in its lane; the others go to column n,
        # which is cut off
        slot = torch.where(sel, torch.cumsum(sel.to(torch.int32), dim=1) - 1,
                           n)
        src = torch.where(sel, x.data[None, :], torch.zeros(
            (), dtype=x.data.dtype, device=dev))
        lanes = torch.zeros(f, n + 1, dtype=x.data.dtype, device=dev) \
            .scatter_(1, slot.long(), src)[:, :n]
        counts = sel.to(torch.int32).sum(dim=1).to(torch.int32)
        end = state["off"] + n
        new_state = dict(
            chan=((state["chan"] + torch.div(end, d, rounding_mode="floor"))
                  % f).to(torch.int32),
            off=(end % d).to(torch.int32))
        meta = x.meta.advanced(0, rate_scale=1.0 / f)
        return new_state, tuple(Stream(lanes[k], counts[k], meta)
                                for k in range(f))
