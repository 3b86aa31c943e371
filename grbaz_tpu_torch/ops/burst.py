"""Burst and timing blocks: gate, burst tagger and buffer, burster, merge,
time keeper, sweep, non-blocker (port of ``grbaz_tpu/ops/burst.py``).

Stream tags become *event arrays*: fixed-capacity ``[cap, fields]``
float32 rows with a validity count, travelling through the graph like
any other stream. Each event row carries the burst's absolute start
sample as a (hi, lo) pair of uint32 limbs BITCAST into the first two
float32 fields (``core.stream.bits_to_f32``), exact for any stream
length; decode on the host with :func:`decode_abs_events`. A bitcast
field may hold a NaN or denormal bit pattern, so the blocks move rows
only by copies (``where``, ``cat``, index gathers) and never by
arithmetic.

The JAX package's event-level scans (a ``lax.scan`` of ``MAX_BURSTS``
jumps between trigger edges in the non-retriggerable ``Gate`` and in
``BurstBuffer``) become pointer doubling (``segments.orbit``): the same
``MAX_BURSTS`` positions, the same cap, from a few whole-tensor gathers.
Nothing in an ``apply`` waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar
from grbaz_tpu_torch.core.stream import (Stream, bits_to_f32,
                                         decode_abs_index, f32_to_bits,
                                         limbs_add_i32)
from grbaz_tpu_torch.ops.segments import (NO_POS, next_true_index, orbit,
                                          running_last_true, seg_prefix_max,
                                          shift_in)

_NEG_INF = float("-inf")


def decode_abs_events(rows, count=None) -> np.ndarray:
    """Host-side decode of Gate/Burster event rows: fields 0/1 are the
    bitcast (hi, lo) limbs of the absolute start sample, fields 2+ plain
    float32. Returns ``[n, F-1]`` float64 rows ``(abs_start, field2,
    ...)``."""
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    rows = np.asarray(rows, np.float32)
    n = int(count) if count is not None else len(rows)
    rows = rows[:n]
    abs_idx = decode_abs_index(rows[:, 0], rows[:, 1]).astype(np.float64)
    return np.concatenate([abs_idx[:, None], rows[:, 2:].astype(np.float64)],
                          axis=1)


def _event_pack(emits: torch.Tensor, rows: torch.Tensor, cap: int):
    """Compact the emitting rows of ``rows`` [n, F] into ``[cap, F]``
    float32 (the first ``cap`` of them, in order; zeros past the count)
    and the count, clamped to ``cap`` (int32 0-d).

    The k-th emitting row is found by ``searchsorted`` on the running
    count of emits, so only ``cap`` rows are gathered; the rows move as
    their int32 bit patterns, so bitcast limb fields stay exact."""
    n = emits.shape[0]
    bits = rows.to(torch.float32).view(torch.int32)
    csum = torch.cumsum(emits.to(torch.int64), 0)
    want = torch.arange(1, cap + 1, dtype=torch.int64, device=emits.device)
    sel = torch.searchsorted(csum, want)  # n where fewer than k emit
    got = bits.index_select(0, sel.clamp(max=n - 1))
    out = torch.where((sel < n)[:, None], got, 0).view(torch.float32)
    return out, torch.clamp(csum[-1], max=cap).to(torch.int32)


def _index_add(base: torch.Tensor, index: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """``base.index_add_(0, index, src)``, complex through its float
    planes (an atomic float add on the card); returns ``base``."""
    if base.is_complex():
        torch.view_as_real(base).index_add_(0, index, torch.view_as_real(src))
    else:
        base.index_add_(0, index, src)
    return base


def _abs_rows(meta, rel_starts, *fields):
    """Event rows ``(start_hi, start_lo, *fields)``: the absolute start is
    the block's first sample plus the signed ``rel_starts``."""
    lo, hi = limbs_add_i32(meta.abs_lo, meta.abs_hi, rel_starts)
    return torch.stack([bits_to_f32(hi), bits_to_f32(lo),
                        *(f.to(torch.float32) for f in fields)], dim=1)


class TimeKeeper(Block):
    """Absolute stream-time tracker (baz_time_keeper). Outputs the input
    unchanged plus a per-block time report event ``[abs_hi, abs_lo,
    epoch_sec, epoch_frac, sample_rate]``, the limbs bitcast (decode with
    ``stream.decode_abs_index``). The ``offset`` param (seconds) is added
    to the reports."""

    n_out = 2

    def __init__(self, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)

    def init_params(self):
        return dict(offset=scalar(0.0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        m = x.meta
        dev = m.abs_lo.device
        report = torch.stack([
            bits_to_f32(m.abs_hi), bits_to_f32(m.abs_lo),
            m.epoch_sec.to(torch.float32) + params["offset"],
            m.epoch_frac.to(torch.float32),
            scalar(m.sample_rate, torch.float32, dev)])[None, :]
        return state, (x, Stream(report, scalar(1, torch.int32, dev), m))


class Gate(Block):
    """Threshold/byte-triggered burst gate (baz_gate).

    Inputs (signal, trigger). A burst opens when the trigger exceeds
    ``threshold`` (float mode) or is nonzero (byte mode), stays open while
    retriggered within ``trigger_length`` samples, and closes after.
    Outputs: the gated signal (zeros outside bursts), and burst events
    ``[MAX_BURSTS, 4]``: (start_abs_hi, start_abs_lo, length,
    trigger_peak), the start including ``delay_samples``.

    The retriggerable gate is a running-max rule (a sample is in a burst
    iff the most recent trigger is younger than ``trigger_length``),
    exact for any number of bursts. The non-retriggerable gate jumps
    between trigger edges: the jump table ``J(p) = min(next_fire(p) +
    trigger_length + 1, n)`` over ``[n+1]`` positions, walked for exactly
    ``MAX_BURSTS`` steps by pointer doubling, as the JAX package's scan
    (exact up to ``MAX_BURSTS`` bursts a block, the event capacity).
    """

    n_in = 2
    n_out = 2
    MAX_BURSTS = 64

    def __init__(self, threshold: float = 0.0, trigger_length: int = 0,
                 delay_samples: int = 0, byte_trigger: bool = False,
                 retriggerable: bool = True, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.threshold0 = float(threshold)
        self.trigger_length = int(trigger_length)
        self.delay = int(delay_samples)
        self.byte_trigger = bool(byte_trigger)
        self.retriggerable = bool(retriggerable)

    def init_state(self):
        def s(v, dtype):
            return scalar(v, dtype, self.device)
        return dict(open_count=s(0, torch.int32),      # samples left in burst
                    in_burst=s(False, torch.bool),
                    burst_start_rel=s(0, torch.int32),  # vs block base, < 0 ok
                    peak=s(0.0, torch.float32))

    def init_params(self):
        return dict(
            threshold=scalar(float(np.float32(self.threshold0)),
                             torch.float32, self.device),
            trigger_length=scalar(max(self.trigger_length, 1), torch.int32,
                                  self.device))

    def _fire(self, params, trig: Stream) -> torch.Tensor:
        if self.byte_trigger:
            return trig.data.to(torch.int32) != 0
        return trig.data.to(torch.float32) > params["threshold"]

    def _retriggerable(self, state, tl, fire, lvl, idx):
        n = idx.shape[0]
        # in a burst <=> the most recent fire is younger than tl; the
        # carried open_count is a virtual fire at open_count - tl - 1
        last_fire = running_last_true(fire, idx, state["open_count"] - tl - 1)
        in_burst = (idx - last_fire) < tl
        prev_ib = shift_in(state["in_burst"], in_burst)
        opening = fire & ~prev_ib
        closing = prev_ib & ~in_burst
        # a burst's start: the most recent opening (the carried start,
        # maybe negative, when it opened in an earlier block)
        starts = running_last_true(opening, idx, torch.where(
            state["in_burst"], state["burst_start_rel"], NO_POS))
        pref = seg_prefix_max(opening, torch.where(fire, lvl, _NEG_INF))
        before_first = torch.cumsum(opening.to(torch.int32), 0) == 0
        carry_pk = torch.where(state["in_burst"], state["peak"], _NEG_INF)
        pref = torch.where(before_first, torch.maximum(pref, carry_pk), pref)
        end = dict(in_burst=in_burst[-1],
                   open_count=torch.clamp(last_fire[-1] + tl - (n - 1), min=0),
                   start=starts[-1], peak=pref[-1])
        return (in_burst | prev_ib, closing, starts, idx - starts,
                shift_in(carry_pk, pref), end)

    def _fixed_length(self, state, tl, fire, lvl, idx):
        n = idx.shape[0]
        # fires during a burst (and at its closing sample) are swallowed:
        # walk from each burst's close to the next fire after it
        nf = torch.cat([next_true_index(fire, fill=n),
                        torch.full((1,), n, dtype=torch.int32,
                                   device=idx.device)])
        oc0 = torch.where(state["in_burst"], state["open_count"], 0)
        carry_close = oc0 - 1            # closing sample of the carried burst
        pos0 = torch.where(state["in_burst"],
                           torch.clamp(carry_close + 1, 0, n), 0)
        pos = orbit(torch.clamp(nf + tl + 1, max=n), pos0, self.MAX_BURSTS)
        opens = nf.index_select(0, pos)
        valid = opens < n
        closes = opens + tl              # closing sample index
        # burst-open mask via edge differencing (an open never meets a
        # close: the next open is at least one sample past it)
        step = valid.to(torch.int32)
        delta = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
        delta.index_add_(0, torch.where(valid, opens, n).long(), step)
        delta.index_add_(0, torch.clamp(closes, 0, n).long(), -step)
        open_edge = delta[:-1] > 0
        in_new = torch.cumsum(delta[:-1], 0) > 0
        in_carry = (idx <= carry_close - 1) & state["in_burst"]
        in_burst = in_new | in_carry
        prev_ib = shift_in(state["in_burst"], in_burst)
        # each new burst's trigger peak: a segmented max from its open,
        # read at its last sample in the block
        pm = seg_prefix_max(open_edge, torch.where(fire & in_new, lvl,
                                                   _NEG_INF))
        last_in = torch.clamp(torch.clamp(closes, max=n) - 1, 0, n - 1)
        pk_rows = torch.where(valid, pm.index_select(0, last_in.long()),
                              _NEG_INF)
        # events: the carried burst first, then the new bursts
        carry_pk = torch.maximum(
            torch.where(state["in_burst"], state["peak"], _NEG_INF),
            torch.where(fire & (idx <= carry_close - 1), lvl, _NEG_INF).max())
        emits = torch.cat([(state["in_burst"] & (carry_close <= n - 1))
                           .reshape(1), valid & (closes <= n - 1)])
        ev_starts = torch.cat([state["burst_start_rel"].reshape(1), opens])
        ev_lens = torch.cat([(carry_close - state["burst_start_rel"])
                             .reshape(1), tl.reshape(1).expand(
                                 self.MAX_BURSTS)])
        ev_peaks = torch.cat([carry_pk.reshape(1), pk_rows])
        last_open = torch.where(valid, opens, NO_POS).max()
        open_is_new = last_open + tl >= n   # its closing sample lies beyond
        end = dict(
            in_burst=in_burst[-1],
            open_count=torch.where(open_is_new, last_open + tl - (n - 1),
                                   torch.clamp(oc0 - n, min=0)),
            start=torch.where(open_is_new, last_open,
                              state["burst_start_rel"]),
            peak=torch.where(open_is_new, torch.where(
                (idx >= last_open) & fire, lvl, _NEG_INF).max(), carry_pk))
        return (in_burst | prev_ib, emits, ev_starts, ev_lens, ev_peaks, end)

    def apply(self, state, params, x: Stream, trig: Stream):
        fire = self._fire(params, trig)
        tl = params["trigger_length"]
        n = x.data.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=x.data.device)
        lvl = trig.data.to(torch.float32)
        form = self._retriggerable if self.retriggerable \
            else self._fixed_length
        gate_open, emits, ev_starts, ev_lens, ev_peaks, end = form(
            state, tl, fire, lvl, idx)
        y = torch.where(gate_open, x.data, torch.zeros(
            (), dtype=x.data.dtype, device=x.data.device))
        # the absolute start rides as exact limbs (f32 indices would
        # round past 2^24, ~5 s at 3.2 Msamp/s)
        rows = _abs_rows(x.meta, ev_starts + self.delay, ev_lens,
                         torch.where(torch.isfinite(ev_peaks), ev_peaks, 0.0))
        events, n_ev = _event_pack(emits, rows, self.MAX_BURSTS)
        end_ib = end["in_burst"]
        new_state = dict(
            open_count=torch.where(end_ib, end["open_count"], 0),
            in_burst=end_ib,
            burst_start_rel=torch.where(end_ib, end["start"] - n, 0),
            peak=torch.where(end_ib & torch.isfinite(end["peak"]),
                             end["peak"], 0.0))
        return new_state, (x.like(y, count=x.count),
                           Stream(events, n_ev, x.meta))


class BurstTagger(Block):
    """Trigger marks -> (sob_marks, eob_marks) streams, ``length`` samples
    apart (baz_burst_tagger). An eob that lands past the block is carried
    (one per block)."""

    n_in = 1
    n_out = 2

    def __init__(self, length: int, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.length = int(length)

    def init_state(self):
        return dict(pending_eob=scalar(-1, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        dev = x.data.device
        marks = (x.data.to(torch.int32) != 0).to(torch.int32)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        # a mark's eob lands d samples later
        d = self.length - 1
        zeros = torch.zeros(min(abs(d), n), dtype=torch.int32, device=dev)
        if d >= 0:
            eob = torch.cat([zeros, marks[:max(n - d, 0)]])
        else:
            eob = torch.cat([marks[min(-d, n):], zeros])
        eob = eob + (idx == state["pending_eob"]).to(torch.int32)
        eob_pos = torch.where(marks != 0, idx + d, -1)
        new_pend = torch.where(eob_pos >= n, eob_pos - n, -1).max()
        return dict(pending_eob=new_pend), (
            x.like(marks.to(torch.uint8), count=x.count),
            x.like(eob.to(torch.uint8), count=x.count))


class BurstBuffer(Block):
    """Accumulate a trigger-delimited burst and emit it as one frame
    (baz_burst_buffer). Inputs (signal, sob_marks, eob_marks); outputs
    frames ``[MAX_BURSTS, max_len]`` and their lengths.

    The block jumps between edges: ``K(p) = min(close(next_sob(p)) + 1,
    n)`` with ``close(o) = min(next_eob(o), o + max_len - 1)``, walked
    for ``MAX_BURSTS`` steps by pointer doubling as the JAX package's
    scan (exact up to ``MAX_BURSTS`` bursts a block); each frame is one
    gather of ``[MAX_BURSTS, max_len]`` indices. State: ``buf`` (the open
    burst so far), ``fill`` and ``active``.
    """

    n_in = 3
    n_out = 2
    MAX_BURSTS = 16

    def __init__(self, max_len: int, dtype=torch.complex64, name=None,
                 device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.max_len = int(max_len)
        self.dtype = dtype

    def init_state(self):
        return dict(buf=torch.zeros(self.max_len, dtype=self.dtype,
                                    device=self.device),
                    fill=scalar(0, torch.int32, self.device),
                    active=scalar(False, torch.bool, self.device))

    def apply(self, state, params, x: Stream, sob: Stream, eob: Stream):
        ml, cap = self.max_len, self.MAX_BURSTS
        n = x.data.shape[0]
        dev = x.data.device
        xd = x.data.to(self.dtype)
        tail = torch.full((1,), n, dtype=torch.int32, device=dev)
        next_sob = torch.cat([next_true_index(
            sob.data.to(torch.int32) != 0, fill=n), tail])
        next_eob = torch.cat([next_true_index(
            eob.data.to(torch.int32) != 0, fill=n), tail])
        j = torch.arange(ml, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=self.dtype, device=dev)
        active = state["active"]

        # ---- the burst carried in from earlier blocks ----
        fc = torch.where(active, state["fill"], 0)
        # the buffer fills at sample ml-fc-1; an eob also closes it
        carry_close = torch.minimum(next_eob[0], ml - fc - 1)
        carry_emit = active & (carry_close <= n - 1)
        src = j - fc
        carry_buf = torch.where((src >= 0) & (src < n), xd.index_select(
            0, torch.clamp(src, 0, n - 1)), state["buf"])
        carry_len = torch.clamp(fc + carry_close + 1, max=ml)

        # ---- new bursts: jump sob -> close -> next sob ----
        pos0 = torch.where(active, torch.where(carry_emit, carry_close + 1, n),
                           0)
        close_of = torch.minimum(next_eob, torch.arange(
            n + 1, dtype=torch.int32, device=dev) + (ml - 1))
        jump = torch.clamp(close_of.index_select(0, next_sob.long()) + 1,
                           max=n)
        opens = next_sob.index_select(0, orbit(jump, pos0, cap))
        closes = close_of.index_select(0, opens.long())
        valid = opens < n
        new_emits = valid & (closes <= n - 1)
        new_lens = torch.clamp(closes - opens + 1, max=ml)
        xpad = torch.cat([xd, torch.zeros(ml, dtype=self.dtype, device=dev)])
        win = torch.clamp(opens, 0, n - 1)[:, None] + j[None, :]
        new_frames = xpad.index_select(0, win.reshape(-1).long()) \
            .reshape(cap, ml)

        # ---- pack: the carried frame first, then the new bursts ----
        emits = torch.cat([carry_emit.reshape(1), new_emits])
        frames_all = torch.cat([carry_buf[None], new_frames])
        lens_all = torch.cat([carry_len.reshape(1), new_lens])
        keep = (j[None, :] < lens_all[:, None]) & emits[:, None]
        slot = torch.where(emits, torch.clamp(
            torch.cumsum(emits.to(torch.int32), 0) - 1, 0, cap - 1), cap - 1)
        frames = _index_add(
            torch.zeros(cap, ml, dtype=self.dtype, device=dev), slot.long(),
            torch.where(keep, frames_all, zero))
        lens = torch.zeros(cap, dtype=torch.int32, device=dev).index_add_(
            0, slot.long(), torch.where(emits, lens_all, 0))
        n_b = torch.clamp(emits.to(torch.int32).sum(), max=cap) \
            .to(torch.int32)

        # ---- carried state out ----
        carry_still = active & ~carry_emit
        last_open = torch.where(valid, opens, NO_POS).max()
        last_close = torch.where(valid, closes, NO_POS).max()
        new_still = valid.any() & (last_close > n - 1)
        nfill = torch.where(carry_still, torch.clamp(fc + n, max=ml),
                            torch.where(new_still, n - last_open, 0))
        last_frame = xpad.index_select(
            0, (torch.clamp(last_open, 0, n - 1) + j).long())
        nbuf = torch.where(carry_still, carry_buf,
                           torch.where(new_still, last_frame, zero))
        new_state = dict(buf=torch.where(j < nfill, nbuf, zero),
                         fill=nfill.to(torch.int32),
                         active=carry_still | new_still)
        return new_state, (Stream(frames, n_b, x.meta),
                           Stream(lens, n_b, x.meta))


class Merge(Block):
    """Schedule burst frames into the main sample timeline by absolute
    time (baz_merge). Inputs: (main, burst_frames [cap, L],
    burst_starts_lo [cap]), the low 32 bits of each burst's absolute
    start as a uint32/int32 stream or the bitcast-f32 limb field of a
    Gate/Burster event row. The parts of each burst inside the block are
    added into it with ``index_add_``: exact where bursts do not overlap;
    overlapping bursts sum in the card's atomic order (within f32
    rounding of each other)."""

    n_in = 3
    n_out = 1

    def __init__(self, max_burst_len: int, name=None):
        super().__init__(name)
        self.max_burst_len = int(max_burst_len)

    def apply(self, state, params, main: Stream, bursts: Stream,
              starts: Stream):
        n = main.data.shape[0]
        dev = main.data.device
        cap, length = bursts.data.shape
        if starts.data.dtype == torch.float32:
            starts_u32 = f32_to_bits(starts.data)  # the bitcast limb field
        else:
            starts_u32 = starts.data.to(torch.int64) & U32_MASK
        # each burst's start relative to this block (wrap-aware)
        d = (starts_u32 - main.meta.abs_lo) & U32_MASK
        rel = torch.where(d >= 2 ** 31, d - 2 ** 32, d)
        valid = (torch.arange(cap, device=dev) < bursts.count)[:, None]
        offs = rel[:, None] + torch.arange(length, device=dev)[None, :]
        in_blk = (offs >= 0) & (offs < n) & valid
        contrib = torch.where(in_blk, bursts.data, torch.zeros(
            (), dtype=bursts.data.dtype, device=dev))
        y = _index_add(main.data.clone(), torch.clamp(offs, 0, n - 1)
                       .reshape(-1), contrib.reshape(-1).to(main.data.dtype))
        return state, (main.like(y, count=main.count),)


class Sweep(Block):
    """Frequency-sweep ramp source (baz_sweep): a float ramp from the
    current value toward ``target`` at ``rate`` Hz/s, then holding. The
    input only paces it (its length and rate)."""

    n_in = 1
    n_out = 1

    def __init__(self, start: float = 0.0, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.start0 = float(start)

    def init_state(self):
        return dict(current=scalar(float(np.float32(self.start0)),
                                   torch.float32, self.device))

    def init_params(self):
        return dict(target=scalar(float(np.float32(self.start0)),
                                  torch.float32, self.device),
                    rate=scalar(0.0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        dev = x.data.device
        step = params["rate"] / scalar(x.meta.sample_rate, torch.float32, dev)
        k = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
        cur, target = state["current"], params["target"]
        up = torch.minimum(cur + k * step, target)
        down = torch.maximum(cur - k * step, target)
        ramp = torch.where(target >= cur, up, down)
        return dict(current=ramp[-1]), (x.like(ramp, count=x.count),)


class NonBlocker(Block):
    """Real-time decoupler (baz_non_blocker): full blocks whatever the
    input's validity, the shortfall zero-filled."""

    def apply(self, state, params, x: Stream):
        return state, (Stream(x.masked_data(), scalar(
            x.data.shape[0], torch.int32, x.data.device), x.meta),)


def rx_time_of(s: Stream):
    """Host-side rx_time of a block's first sample: ``(whole_seconds,
    fractional_seconds)`` from its exact stream meta (reads the meta
    back from the card)."""
    m = s.meta
    abs_idx = (int(m.abs_hi) << 32) | int(m.abs_lo)
    t = float(m.epoch_frac) + abs_idx / float(m.sample_rate)
    whole = int(m.epoch_sec) + int(t)
    return whole, t - int(t)


class BursterConfig:
    """kwargs-style burster config (baz_burster_config): the fields
    :class:`Burster` reads."""

    def __init__(self, sample_rate: int = 1, burst_length: int = 256,
                 interval: float = 1.0, sample_interval: bool = False,
                 trigger_on_tags: bool = False, use_tag_lengths: bool = False,
                 max_bursts: int = 16):
        self.sample_rate = int(sample_rate)
        self.burst_length = int(burst_length)
        self.interval = float(interval)
        self.sample_interval = bool(sample_interval)
        self.trigger_on_tags = bool(trigger_on_tags)
        self.use_tag_lengths = bool(use_tag_lengths)
        self.max_bursts = int(max_bursts)

    def interval_samples(self) -> int:
        if self.sample_interval:
            return max(int(self.interval), 1)
        return max(int(round(self.interval * self.sample_rate)), 1)


class Burster(Block):
    """Stream -> timed bursts (baz_burster).

    Interval mode (default): a ``burst_length`` window every ``interval``
    (seconds or samples, ``config.sample_interval``) on the absolute
    sample grid, sample-exact across blocks through a ``burst_length``
    history. Trigger mode (``config.trigger_on_tags``): a second input
    carries an event stream whose rows ``(rel_index, ...)`` open bursts,
    with per-burst lengths from field 2 when ``config.use_tag_lengths``.

    Outputs: frames ``[max_bursts, burst_length]`` (count = bursts), and
    events ``[max_bursts, 4]``: (start_abs_hi, start_abs_lo, length,
    interval_index), the limbs bitcast as in :class:`Gate`.
    """

    n_out = 2

    def __init__(self, config: BursterConfig, dtype=torch.complex64,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.n_in = 2 if config.trigger_on_tags else 1

    def init_state(self):
        return dict(hist=torch.zeros(self.config.burst_length,
                                     dtype=self.dtype, device=self.device),
                    # first start not yet emitted, relative to the block
                    # base; in [-L+1, inf)
                    next_start=scalar(0, torch.int32, self.device))

    def init_params(self):
        return dict(interval=scalar(self.config.interval_samples(),
                                    torch.int32, self.device))

    def apply(self, state, params, x: Stream, *trig):
        cfg = self.config
        L, cap = cfg.burst_length, cfg.max_bursts
        n = x.capacity
        dev = x.data.device
        ext = torch.cat([state["hist"], x.data.to(self.dtype)])
        k = torch.arange(cap, dtype=torch.int32, device=dev)
        full = torch.full((cap,), L, dtype=torch.int32, device=dev)
        if cfg.trigger_on_tags:
            ev = trig[0]
            starts = ev.data[:cap, 0].to(torch.int32)
            valid = (k < ev.count) & (starts + L <= n)
            lengths = torch.clamp(ev.data[:cap, 2].to(torch.int32), 0, L) \
                if cfg.use_tag_lengths and ev.data.shape[1] > 2 else full
            next_start = state["next_start"]  # unused in trigger mode
        else:
            interval, ns = params["interval"], state["next_start"]
            starts = ns + k * interval
            valid = starts + L <= n
            lengths = full
            # advance past every start emitted this block, then re-base
            n_emit = torch.clamp(torch.div(n - L - ns, interval,
                                           rounding_mode="floor") + 1, min=0)
            next_start = (ns + n_emit * interval - n).to(torch.int32)
        starts_c = torch.clamp(starts, -L, n)
        # the window into [hist, x]; its start clamped so it fits, as a
        # dynamic_slice is
        first = torch.clamp(starts_c + L, 0, n)
        win = first[:, None] + torch.arange(L, dtype=torch.int32,
                                            device=dev)[None, :]
        frames = ext.index_select(0, win.reshape(-1).long()).reshape(cap, L)
        mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]) \
            & valid[:, None]
        frames = torch.where(mask, frames, torch.zeros(
            (), dtype=self.dtype, device=dev))
        rows = torch.where(valid[:, None],
                           _abs_rows(x.meta, starts_c, lengths, k), 0.0)
        new_state = dict(hist=ext[-L:], next_start=next_start)
        n_bursts = valid.to(torch.int32).sum().to(torch.int32)
        return new_state, (Stream(frames, n_bursts, x.meta),
                           Stream(rows, n_bursts, x.meta))
