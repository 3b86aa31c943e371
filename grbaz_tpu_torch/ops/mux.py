"""In-graph event dispatch and the future-sample-time mux (port of
``grbaz_tpu/ops/mux.py``).

* :class:`NativeCallbackX` (baz_native_callback_x): rising threshold
  crossings of a float stream as a fixed-capacity event stream, ``[E, 2]``
  rows ``(relative sample index, value)`` plus a count, which later
  blocks consume on the card; :func:`dispatch_events` calls Python
  callbacks from it on the host.
* :class:`NativeMux` (baz_native_mux): a 2->1 mux that switches to the
  alternate input at a future sample time (event time + ``latency``) and
  holds it for ``trigger_count`` samples, optionally substituting values
  from a cycling table. The pending deadlines are a fixed-size sorted
  carry; selection is a window test over the block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.segments import shift_in

# "no pending deadline": far beyond any block length
_INF = 2 ** 30


def threshold_events(x: torch.Tensor, level, prev_above: torch.Tensor,
                     max_events: int, *, enabled=True):
    """Rising-edge crossings of ``x`` to >= ``level`` (``prev_above`` is
    the carried flag of the previous block); with ``enabled`` false every
    sample is an event. Returns ``(times [E] int32, values [E] float32,
    n_events int32, prev_above')`` with E = min(max_events, n); slots
    past ``n_events`` hold ``_INF`` / 0. The first E events are found by
    ``searchsorted`` on the running event count."""
    n = x.shape[0]
    above = x >= level
    prev = shift_in(prev_above, above)
    enabled = torch.as_tensor(enabled, device=x.device)
    trig = torch.where(enabled, above & ~prev, torch.ones_like(above))
    csum = torch.cumsum(trig.to(torch.int64), 0)
    k = min(max_events, n)
    sel = torch.searchsorted(csum, torch.arange(1, k + 1, device=x.device))
    valid = sel < n
    times = torch.where(valid, sel, _INF).to(torch.int32)
    values = torch.where(valid, x.index_select(0, sel.clamp(max=n - 1)), 0.0)
    n_events = valid.to(torch.int32).sum().to(torch.int32)
    return times, values.to(torch.float32), n_events, above[-1]


class NativeCallbackX(Block):
    """Threshold-crossing event emitter (baz_native_callback_x). Input: a
    float stream. Output: events ``[E, 2]`` float32 ``(relative index,
    value)`` with the count of this block's events (those inside the
    block's valid count)."""

    def __init__(self, threshold_enable: bool = False,
                 threshold_level: float = 0.0, max_events: int = 16,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.max_events = int(max_events)
        self._enable0 = bool(threshold_enable)
        self._level0 = float(threshold_level)

    def init_state(self):
        return scalar(False, torch.bool, self.device)  # hysteresis flag

    def init_params(self):
        return dict(
            threshold_enable=scalar(self._enable0, torch.bool, self.device),
            threshold_level=scalar(float(np.float32(self._level0)),
                                   torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        times, values, _, above = threshold_events(
            x.data.to(torch.float32), params["threshold_level"], state,
            self.max_events, enabled=params["threshold_enable"])
        # events in the invalid tail of a short block are dropped
        live = times < x.count
        times = torch.where(live, times, _INF)
        ev = torch.stack([times.to(torch.float32), values], dim=1)
        return above, (x.like(ev, count=live.to(torch.int32).sum(),
                              rate_scale=0.0),)


def dispatch_events(target, events, n_events, abs_base: int = 0) -> int:
    """Host-side dispatch: ``target.callback(value, abs_index)`` for each
    event (baz_native_callback's callback_target interface)."""
    if isinstance(events, torch.Tensor):
        events = events.detach().cpu().numpy()
    n = int(n_events)
    for t, v in np.asarray(events)[:n]:
        target.callback(float(v), int(t) + int(abs_base))
    return n


class NativeMux(Block):
    """2->1 mux switching at scheduled future sample times
    (baz_native_mux). Inputs ``(main, alt, events)``, the events a
    :class:`NativeCallbackX` output. Each event schedules a switch at
    ``event_index + latency``; from the deadline the mux emits input 1
    for ``trigger_count`` samples, then input 0 again. With ``values``,
    an active window substitutes the next value of the cycling table
    instead.

    Carry: up to ``pending`` deadlines (block-relative, re-based each
    block; beyond capacity the latest are dropped) and the substitution
    cycle offset."""

    n_in = 3

    def __init__(self, latency: int = 16384 * 8 + 2048,
                 trigger_count: int = 2048,
                 values: Optional[Sequence[float]] = None,
                 pending: int = 16, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.latency = int(latency)
        self.trigger_count = int(trigger_count)
        self.values = None if values is None else torch.from_numpy(
            np.asarray(values, np.float32)).to(self.device)
        self.pending = int(pending)

    def init_state(self):
        return (torch.full((self.pending,), _INF, dtype=torch.int32,
                           device=self.device),       # deadlines
                scalar(0, torch.int32, self.device))  # value cycle offset

    def apply(self, state, params, main: Stream, alt: Stream,
              events: Stream):
        deadlines, voff = state
        n = main.capacity
        dev = main.data.device
        tc = self.trigger_count
        ev_times = events.data[:, 0].to(torch.int32)
        ev_valid = torch.arange(ev_times.shape[0], device=dev) < events.count
        new_dl = torch.where(ev_valid, ev_times + self.latency, _INF)
        q = torch.sort(torch.cat([deadlines, new_dl])).values[:self.pending]
        t = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        win = (t >= q[None, :]) & (t < q[None, :] + tc)       # [N, pending]
        selected = win.any(dim=1)
        out = torch.where(selected, alt.data, main.data)
        if self.values is not None:
            # the window's value: cycle offset + rank of its deadline
            rank = torch.argmax(win.to(torch.int32), dim=1)
            vidx = (voff + rank) % self.values.shape[0]
            sub = self.values.index_select(0, vidx).to(out.dtype)
            out = torch.where(selected, sub, out)
        # retire windows that end inside this block; re-base the rest
        done = (q + tc) <= n
        q2 = torch.where(q >= _INF, _INF, torch.clamp(q - n, min=-tc))
        q2 = torch.where(done, _INF, q2)
        new_state = (torch.sort(q2).values,
                     (voff + done.to(torch.int32).sum()).to(torch.int32))
        return new_state, (main.like(out, count=main.count),)
