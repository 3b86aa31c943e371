"""Misc stream blocks: interleaver, FasTrak decoder, test counter,
swap_ff, field tracker, block-status probe (port of
``grbaz_tpu/ops/misc.py``).

* :class:`MatrixInterleaver` (baz_interleaver): accumulate ``vlen_out``
  rows of ``vlen_in`` and read out the transpose as columns.
* :class:`FastrakDecoder` (baz_fastrak_decoder): threshold sync,
  oversampled hard bits, the 12-bit sync word 0xAAC, a 16-bit type
  (PT_ID = 1 -> a 32-bit ID), a CRC16-CCITT check and last-ID tracking.
  The JAX package walks it as a per-sample ``lax.scan``; here it runs on
  the FSM kernel ``csrc/fastrak_fsm.cu`` on the card and on
  :func:`fastrak_fsm_plain`, a serial host loop, on the CPU.
* :class:`TestCounter` (baz_test_counter_cc): checks a monotonic counter
  stream across blocks.
* :class:`SwapFF` (baz_swap_ff): swap float pairs, runtime-switchable.
* :class:`FieldTracker` (baz_field_tracker): field parity from the even
  and odd sync correlators.
* :class:`BlockStatus` (baz_block_status): a status report every
  ``interval`` samples.

Two behaviours of the JAX package are kept as they are: the FasTrak
decoder walks every sample of a block whatever its ``count``, and the
field tracker carries the parity of the block's last sample, not of
sample ``count - 1``.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import (U32_MASK, resolve_device, scalar,
                                         take)
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.segments import running_max


class MatrixInterleaver(Block):
    """Frames [n, vlen_in] -> transposed frames [m, vlen_out].

    Accumulates ``vlen_out`` rows, then emits ``vlen_in`` columns (each a
    ``vlen_out``-vector). ``n`` must be a multiple of ``vlen_out``.
    """

    def __init__(self, vlen_in: int, vlen_out: int, dtype=torch.complex64,
                 name=None):
        super().__init__(name)
        self.vlen_in = int(vlen_in)
        self.vlen_out = int(vlen_out)
        self.dtype = dtype

    def apply(self, state, params, x: Stream):
        n, vi = x.data.shape
        if vi != self.vlen_in or n % self.vlen_out:
            raise ValueError(f"{self.name}: rows of {self.vlen_in} in "
                             f"multiples of {self.vlen_out}, not {(n, vi)}")
        groups = x.data.reshape(-1, self.vlen_out, self.vlen_in)
        cols = groups.transpose(1, 2).reshape(-1, self.vlen_out)
        n_out = torch.div(x.count, self.vlen_out,
                          rounding_mode="floor") * self.vlen_in
        return state, (x.like(cols, count=n_out,
                              rate_scale=self.vlen_in / self.vlen_out),)


def _crc16_ccitt_update(crc, byte):
    """One byte of the reference's crc16_compute (int32 arithmetic; ints
    or integer tensors)."""
    t = ((crc >> 8) ^ byte) & 0xFF
    t = t ^ (t >> 4)
    return ((crc << 8) ^ (t << 12) ^ (t << 5) ^ t) & 0xFFFF


# ---------------------------------------------------------------------------
# the FasTrak FSM
# ---------------------------------------------------------------------------

SEARCH, SYNC, TYPE, DECODE, CRC = 0, 1, 2, 3, 4
SYNC_WORD = 0xAAC
PT_ID = 0x0001
MAX_EVENTS = 32
# the decoder's state, in the order of the kernel's int32 state rows
FT_FIELDS = ("state", "sub", "bit_buf", "bit_ctr", "crc", "crc_buf",
             "crc_bits", "compute_crc", "payload_len", "id", "last_id",
             "last_id_count")
# fields held as uint32 (int64 masked to 32 bits in torch)
FT_U32 = ("bit_buf", "id", "last_id")


def _i32(v: int) -> int:
    """``v`` wrapped to int32, as the JAX package's int32 arithmetic."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def ft_step(s: list, bit: int, hit: bool, os_: int) -> bool:
    """One step of ``FastrakDecoder``'s scan, in place on the first ten
    entries of ``s``, the fields of :data:`FT_FIELDS` as Python ints (``bit_buf`` and
    ``id`` as uint32 values, ``compute_crc`` 0 or 1). ``bit`` is 1 where
    the metric is >= 0, ``hit`` whether the sync stream is >= the
    threshold. Follows the JAX step's order of updates line by line.
    Returns whether the step emits (the ID is then ``s[9]``)."""
    st, sub, bb, bc, crc, cb, cbits, cc, plen, ident = s[:10]
    searching = st == SEARCH
    fire = searching and hit
    sampling = not searching and sub == 0
    if searching:
        sub = 0 if fire else sub
    else:
        sub = os_ - 1 if sampling else max(sub - 1, 0)
    take_ = fire or sampling
    if fire:
        st, bb, bc, sub = SYNC, bit, 1, os_ - 1
    elif take_:
        bb = ((bb << 1) | bit) & U32_MASK
        bc = _i32(bc + 1)
    if fire:
        cc = 0
    byte_done = False
    if take_ and cc:
        cb = _i32(cb << 1 | bit)
        cbits = _i32(cbits + 1)
        byte_done = cbits % 8 == 0
    if fire:
        crc = 0
    elif byte_done:
        crc = _crc16_ccitt_update(crc, cb & 0xFF)
    if byte_done:
        cb = 0
    sync_done = take_ and st == SYNC and bc == 12
    if sync_done:
        st = TYPE if bb == SYNC_WORD else SEARCH
        if bb == SYNC_WORD:
            cc, cbits = 1, 0
    type_done = take_ and st == TYPE and bc == 16 and not sync_done
    if type_done:
        st = DECODE if bb == PT_ID else SEARCH
        if bb == PT_ID:
            plen = 32
    dec_done = (take_ and st == DECODE and bc == plen and not type_done
                and not sync_done)
    if dec_done:
        ident, st = bb, CRC
    crc_done = (take_ and st == CRC and bc == 16 and not dec_done
                and not type_done and not sync_done)
    if crc_done:
        st = SEARCH
    if sync_done or type_done or dec_done or crc_done:
        bb, bc = 0, 0
    s[:10] = st, sub, bb, bc, crc, cb, cbits, cc, plen, ident
    return crc_done and crc == 0


def ft_state_list(st: dict, r: int) -> list:
    """Row ``r`` of the numpy state ``st`` as a list of Python ints in
    :data:`FT_FIELDS` order."""
    return [int(st[k][r]) for k in FT_FIELDS]


def ft_emit(events: np.ndarray, n_emitted: int, ident: int, count: int):
    """Add one emission row (id_hi16, id_lo16, count) to ``events``
    [MAX_EVENTS, 3] float32 at slot ``min(n_emitted, MAX_EVENTS - 1)``, as
    the JAX block's ``.at[slot].add``: rows past the 31st are summed into
    the last one, in order."""
    slot = min(n_emitted, MAX_EVENTS - 1)
    row = np.array([ident >> 16, ident & 0xFFFF, count], np.float32)
    events[slot] = events[slot] + row


def fastrak_fsm_plain(metric: torch.Tensor, sync: torch.Tensor, state: dict,
                      threshold: torch.Tensor, oversampling: int):
    """The FasTrak FSM over rows ``metric``, ``sync`` [B, n], one stream a
    row, from ``state`` ([B] tensors of :data:`FT_FIELDS`) with
    ``threshold`` [B] or [1]. Returns (events [B, MAX_EVENTS, 3] float32,
    event count [B] int32, the new state) on ``metric``'s device.

    The serial mirror of the JAX block's scan, a host loop of
    :func:`ft_step`. The loop skips the steps that change nothing but the
    sub-symbol counter: in SEARCH every field holds until the sync stream
    reaches the threshold, and inside a frame only ``sub`` counts down
    until the next bit is sampled."""
    os_ = int(oversampling)
    m = metric.detach().to("cpu", torch.float32).numpy()
    sy = sync.detach().to("cpu", torch.float32).numpy()
    rows, n = m.shape
    thr = np.broadcast_to(threshold.detach().cpu().numpy()
                          .astype(np.float32).reshape(-1), (rows,))
    events = np.zeros((rows, MAX_EVENTS, 3), np.float32)
    n_ev = np.zeros(rows, np.int32)
    st = {k: v.detach().cpu().numpy().reshape(rows).astype(np.int64)
          for k, v in state.items()}
    for r in range(rows):
        s = ft_state_list(st, r)
        bits = (m[r] >= np.float32(0.0)).astype(np.int64)
        hits = np.flatnonzero(sy[r] >= thr[r])
        emitted, i = 0, 0
        while i < n:
            if s[0] == SEARCH:
                h = np.searchsorted(hits, i)
                if h == len(hits):
                    break
                i = int(hits[h])
            elif s[1] > 0:
                d = min(s[1], n - i)
                s[1] -= d
                i += d
                continue
            if ft_step(s, int(bits[i]),
                       bool(sy[r, i] >= thr[r]), os_):
                ident = s[9]
                s[11] = _i32(s[11] + 1) if ident == s[10] else 1
                s[10] = ident
                ft_emit(events[r], emitted, ident, s[11])
                emitted += 1
            i += 1
        n_ev[r] = min(emitted, MAX_EVENTS)
        for k, v in zip(FT_FIELDS, s):
            st[k][r] = v
    dev = metric.device
    new = {k: torch.from_numpy(v.astype(np.int64 if k in FT_U32 else
                                        np.int32)).to(dev)
           for k, v in st.items()}
    new["compute_crc"] = new["compute_crc"] != 0
    return (torch.from_numpy(events).to(dev), torch.from_numpy(n_ev).to(dev),
            new)


class FastrakDecoder(Block):
    """FasTrak toll-transponder decoder. Inputs: the bit metric and the
    sync correlation (float). Output: ID events [MAX_EVENTS, 3] =
    (id_hi16, id_lo16, consecutive-repeat count), the 32-bit ID split so
    that float32 rows carry it exactly."""

    n_in = 2
    n_out = 1
    MAX_EVENTS = MAX_EVENTS
    SYNC_WORD = SYNC_WORD
    PT_ID = PT_ID
    SEARCH, SYNC, TYPE, DECODE, CRC = SEARCH, SYNC, TYPE, DECODE, CRC

    def __init__(self, sync_threshold: float = 1.0, oversampling: int = 8,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.thr0 = float(sync_threshold)
        self.os = int(oversampling)
        if self.os < 1:
            raise ValueError("oversampling must be >= 1")

    def init_state(self):
        st = {k: scalar(0, torch.int64 if k in FT_U32 else torch.int32,
                        self.device) for k in FT_FIELDS}
        st["compute_crc"] = scalar(False, torch.bool, self.device)
        return st

    def init_params(self):
        return dict(threshold=scalar(self.thr0, torch.float32, self.device))

    def apply(self, state, params, x: Stream, sync: Stream):
        from grbaz_tpu_torch.ops.cuda.fastrak_fsm import fastrak_fsm
        ev, n_ev, new = fastrak_fsm(
            x.data.to(torch.float32).reshape(1, -1),
            sync.data.to(torch.float32).reshape(1, -1),
            {k: v.reshape(1) for k, v in state.items()},
            params["threshold"].reshape(1), self.os)
        return ({k: v.reshape(()) for k, v in new.items()},
                (Stream(ev[0], n_ev[0], x.meta),))


# ---------------------------------------------------------------------------
# the small blocks
# ---------------------------------------------------------------------------

class TestCounter(Block):
    """Checks an incrementing counter stream (baz_test_counter_cc),
    counting discontinuities across block boundaries too. The stream
    passes through; the counts live in the state."""

    __test__ = False  # not a pytest class

    def __init__(self, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)

    def init_state(self):
        return dict(last=scalar(-1.0, torch.float32, self.device),
                    errors=scalar(0, torch.int32, self.device),
                    total=scalar(0, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        d = x.data
        v = (d.real if d.is_complex() else d).to(torch.float32)
        prev = torch.cat([state["last"].reshape(1), v[:-1]])
        idx = torch.arange(v.shape[0], device=v.device)
        first_ever = (state["last"] < 0) & (idx == 0)
        bad = (v != prev + 1.0) & x.valid_mask() & ~first_ever
        iend = torch.clamp(x.count - 1, 0, v.shape[0] - 1)
        new = dict(last=torch.where(x.count > 0, take(v, iend),
                                    state["last"]),
                   errors=state["errors"] + bad.sum(dtype=torch.int32),
                   total=state["total"] + x.count)
        return new, (x,)


class SwapFF(Block):
    """Swap adjacent float pairs (baz_swap_ff), runtime-switchable."""

    def __init__(self, swap: bool = True, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.swap0 = bool(swap)

    def init_params(self):
        return dict(swap=scalar(self.swap0, torch.bool, self.device))

    def apply(self, state, params, x: Stream):
        swapped = x.data.reshape(-1, 2).flip(1).reshape(-1)
        y = torch.where(params["swap"], swapped, x.data)
        return state, (x.like(y, count=x.count),)


class FieldTracker(Block):
    """Three-input field synchronizer (baz_field_tracker): passes the
    signal and outputs the field parity, +1 after the even sync fired and
    -1 after the odd one, held from the latest mark (a running max over
    mark positions and a gather), carried across blocks."""

    n_in = 3
    n_out = 2

    def __init__(self, threshold: float = 0.5, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.thr0 = float(threshold)

    def init_state(self):
        return dict(parity=scalar(0.0, torch.float32, self.device))

    def init_params(self):
        return dict(threshold=scalar(self.thr0, torch.float32, self.device))

    def apply(self, state, params, sig: Stream, even: Stream, odd: Stream):
        t = params["threshold"]
        mark = ((even.data.to(torch.float32) > t).to(torch.float32)
                - (odd.data.to(torch.float32) > t).to(torch.float32))
        n = mark.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=mark.device)
        last = running_max(torch.where(mark != 0, idx, -1))
        held = mark.index_select(0, torch.clamp(last, 0, n - 1))
        parity = torch.where(last >= 0, held, state["parity"])
        return dict(parity=parity[-1]), (sig, sig.like(parity,
                                                       count=sig.count))


class BlockStatus(Block):
    """In-stream observability probe (baz_block_status): passes the data
    through and emits a report every ``interval`` samples:
    [total samples, blocks seen, valid in block, flags]."""

    n_out = 2

    def __init__(self, interval: int = 1 << 20, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.interval = int(interval)

    def init_state(self):
        return dict(total=scalar(0.0, torch.float32, self.device),
                    blocks=scalar(0, torch.int32, self.device),
                    since_report=scalar(0, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        total = state["total"] + x.count.to(torch.float32)
        since = state["since_report"] + x.count
        fire = since >= self.interval
        blocks = state["blocks"] + 1
        report = torch.stack([total, blocks.to(torch.float32),
                              x.count.to(torch.float32),
                              x.meta.flags.to(torch.float32)])[None, :]
        new = dict(total=total, blocks=blocks,
                   since_report=torch.where(fire, 0, since))
        return new, (x, Stream(report, fire.to(torch.int32), x.meta))
