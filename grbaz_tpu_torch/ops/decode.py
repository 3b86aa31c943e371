"""Bit-level decoders: Manchester, DPLL bit sync, ACARS (port of
``grbaz_tpu/ops/decode.py``).

The JAX package walks each decoder as a per-sample ``lax.scan``. Here each
walk is a serial FSM over rows ``[B, n]`` (one stream a row, [B] state
fields): on the card a CUDA kernel with one thread a row
(``csrc/manchester_fsm.cu``, ``csrc/dpll_walk.cu``, ``csrc/acars_fsm.cu``,
through the wrappers in ``ops/cuda/``), on the CPU the plain versions
below, host loops of numpy scalars that mirror the JAX scans step for
step. The blocks call them with one row.

Behaviours of the JAX package kept as they are:

* every decoder walks all samples of a block whatever its ``count``:
  Manchester masks its emissions by the valid prefix but its state walks
  the padding; the DPLL and ACARS mask nothing, and the DPLL's
  ``global_idx`` counts every sample;
* variable-count outputs are compacted by a scatter-add, so emissions
  past the capacity are summed into the last slot (:func:`_compact`;
  ACARS's fifth and later packets of a block into row 3, the DPLL's
  overflow events into row 511, both in emission order);
* XLA rewrites the DPLL's ``phase / (1 / period)`` as ``phase * period``
  and contracts ``(1 - g) * period + g * clamped`` on the CPU into one
  fused multiply-add: ``fma(1 - g, period, g * clamped)``, or, where
  ``1 - g`` equals a clamp bound ``1 -+ rel`` in float32 (the default
  ``gain = relative_limit = 0.05``) so that the product ``period * (1 -
  g)`` is shared with the clamp, ``fma(g, clamped, (1 - g) * period)``.
  The plain version and the kernel compute exactly that
  (:func:`dpll_fuses_gain`).
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream


def _compact(values: torch.Tensor, keep: torch.Tensor, capacity=None):
    """Pack ``values[keep]`` to the front (zeros after): (out[cap], count).

    The JAX package's scatter-add: kept element j goes to slot
    ``cumsum(keep)[j] - 1`` clipped to the last slot, where the overflow
    is summed; dropped elements add a zero to the last slot."""
    n = values.shape[0]
    cap = capacity or n
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep, pos.clamp(0, cap - 1), cap - 1)
    contrib = torch.where(keep, values, torch.zeros((), dtype=values.dtype,
                                                    device=values.device))
    out = torch.zeros((cap,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, slot, contrib)
    count = torch.clamp(keep.sum(dtype=torch.int32), max=cap)
    return out, count


def _i32(v: int) -> int:
    """``v`` wrapped to int32, as the JAX package's int32 arithmetic."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _rows_state(state: dict, rows: int) -> dict:
    """[B] numpy copies of a state dict's fields: float32 for float
    fields, int64 for the others (uint32 held as int64, bools 0/1)."""
    return {k: v.detach().cpu().numpy().reshape(rows).astype(np.int64)
            if not v.is_floating_point() else
            v.detach().cpu().numpy().reshape(rows).astype(np.float32)
            for k, v in state.items()}


# ---------------------------------------------------------------------------
# Manchester decoder
# ---------------------------------------------------------------------------

# the decoder's state, in the order of the kernel's int32 state rows
MAN_FIELDS = ("phase", "prev", "viol_hist", "hist_len")


def manchester_plain(bits: torch.Tensor, count: torch.Tensor, state: dict,
                     original: bool, window: int, threshold: int):
    """The Manchester FSM over rows ``bits`` [B, n] (nonzero = 1) from
    ``state`` ([B] tensors of :data:`MAN_FIELDS`, ``viol_hist`` uint32 in
    int64), emitting only at samples before ``count`` [B]. Returns (bits
    [B, n // 2 + 1] uint8, emitted [B] int32, the new state) on ``bits``'s
    device. A host loop, the serial mirror of the JAX block's scan."""
    x = (bits.detach().cpu().numpy() != 0).astype(np.int64)
    rows, n = x.shape
    cap = n // 2 + 1
    cnt = np.broadcast_to(count.detach().cpu().numpy().reshape(-1), (rows,))
    st = _rows_state(state, rows)
    out = np.zeros((rows, cap), np.uint8)
    n_out = np.zeros(rows, np.int32)
    wmask = (1 << window) - 1
    for r in range(rows):
        phase, prev, hist, hlen = (int(st[k][r]) for k in MAN_FIELDS)
        valid, k = int(cnt[r]), 0
        for i, xi in enumerate(x[r].tolist()):
            if phase == 1:
                if prev != xi:
                    if i < valid:
                        bit = int(((prev == 0) and (xi == 1)) != original)
                        slot = min(k, cap - 1)
                        out[r, slot] = (int(out[r, slot]) + bit) & 0xFF
                        k += 1
                    hist = (hist << 1) & wmask
                else:
                    hist = ((hist << 1) | 1) & wmask
                hlen = min(hlen + 1, window)
                if hlen >= window and bin(hist).count("1") >= threshold:
                    phase, prev, hist, hlen = 1, xi, 0, 0
                else:
                    phase = 0
            else:
                phase, prev = 1, xi
        n_out[r] = min(k, cap)
        for name, v in zip(MAN_FIELDS, (phase, prev, hist, hlen)):
            st[name][r] = v
    dev = bits.device
    new = {k: torch.from_numpy(v.astype(np.int64 if k == "viol_hist" else
                                        np.int32)).to(dev)
           for k, v in st.items()}
    return torch.from_numpy(out).to(dev), torch.from_numpy(n_out).to(dev), new


class ManchesterDecode(Block):
    """Manchester decoder with violation-windowed resync
    (baz_manchester_decode_bb). Pairs (first, second) decode to
    ``first == 0 and second == 1`` (inverted with ``original=True``);
    equal pairs are violations, and ``threshold`` of them in a full
    sliding ``window`` of pairs slip the pair alignment by one sample.
    Output: decoded bit-bytes, about half rate, with their count."""

    def __init__(self, original: bool = False, window: int = 16,
                 threshold: int = 8, name=None, device="cuda"):
        super().__init__(name)
        if window > 31:
            raise ValueError("violation window limited to 31 pairs")
        self.device = resolve_device(device)
        self.original = bool(original)
        self.window = int(window)
        self.threshold = int(threshold)

    def init_state(self):
        return {k: scalar(0, torch.int64 if k == "viol_hist" else torch.int32,
                          self.device) for k in MAN_FIELDS}

    def apply(self, state, params, x: Stream):
        from grbaz_tpu_torch.ops.cuda.manchester_fsm import manchester_fsm
        out, n_out, new = manchester_fsm(
            x.data.reshape(1, -1), x.count.reshape(1),
            {k: v.reshape(1) for k, v in state.items()}, self.original,
            self.window, self.threshold)
        return ({k: v.reshape(()) for k, v in new.items()},
                (Stream(data=out[0], count=n_out[0],
                        meta=x.meta.with_rate(x.meta.sample_rate * 0.5)),))


# ---------------------------------------------------------------------------
# DPLL bit synchronizer
# ---------------------------------------------------------------------------

DPLL_MAX_EVENTS = 512
# the int32 fields of the DPLL's state, in the kernel's row order
DPLL_INTS = ("count", "last_idx", "global_idx")


def fma32(a, b, c) -> np.float32:
    """``a * b + c`` rounded once to float32 (the fused multiply-add XLA
    emits), from float32 operands: the product is exact in float64, the
    sum's rounding error comes from a TwoSum, and a float64 sum that sits
    exactly halfway between two float32 values is resolved by the sign
    of that error."""
    p = float(a) * float(b)
    c = float(c)
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    r = np.float32(s)
    if e != 0.0 and float(r) != s:
        r2 = np.nextafter(r, np.float32(np.inf if s > float(r) else -np.inf))
        if 2.0 * s == float(r) + float(r2):      # a tie for float32
            return r2 if (e > 0) == (float(r2) > float(r)) else r
    return r


def dpll_fuses_gain(gain: float, relative_limit: float) -> bool:
    """Whether XLA's fused multiply-add in the DPLL update takes the
    ``gain * clamped`` product (else ``(1 - gain) * period``): when
    ``period * (1 - gain)`` is also a clamp bound, the product is computed
    once for both and is not fused."""
    f = np.float32
    return f(1.0 - gain) in (f(1.0 - relative_limit), f(1.0 + relative_limit))


def dpll_plain(pulses: torch.Tensor, state: dict, gain: float,
               relative_limit: float, ignore_limit: float):
    """The DPLL over rows ``pulses`` [B, n] (nonzero = a pulse) from
    ``state`` ([B] tensors: ``period``, ``phase`` float32 and
    :data:`DPLL_INTS` int32). Returns (pulses [B, n] uint8, period
    estimates [B, n] float32, events [B, 512, 3] float32, event count [B]
    int32, the new state) on ``pulses``'s device.

    The serial mirror of the JAX block's scan in float32 with its XLA
    rounding (module docstring, :func:`dpll_fuses_gain`). Between pulses
    only the phase moves, by the same increment each sample:
    ``np.add.accumulate`` adds it in order, one float32 rounding a
    sample, as the scan does."""
    f = np.float32
    x = pulses.detach().cpu().numpy() != 0
    rows, n = x.shape
    st = _rows_state(state, rows)
    one, omg, g = f(1.0), f(1.0 - gain), f(gain)
    fuse_gain = dpll_fuses_gain(gain, relative_limit)
    lo, hi, ign = f(1.0 - relative_limit), f(1.0 + relative_limit), \
        f(ignore_limit)
    periods = np.zeros((rows, n), f)
    events = np.zeros((rows, DPLL_MAX_EVENTS, 3), f)
    n_ev = np.zeros(rows, np.int32)
    for r in range(rows):
        per, ph = f(st["period"][r]), f(st["phase"][r])
        cnt, last, gidx = (int(st[k][r]) for k in DPLL_INTS)
        k, i = 0, 0
        for p in np.flatnonzero(x[r]).tolist() + [n]:
            freq = one / per
            if p > i:    # no pulse in [i, p): the phase accumulates
                acc = np.add.accumulate(np.concatenate(
                    [[ph], np.full(p - i, freq, f)]), dtype=f)
                ph = acc[-1]
                periods[r, i:p] = per
            if p == n:
                break
            phase = f(ph + freq)
            cur = f(phase * per)
            ratio = f(f(cur - per) / per)
            new = per
            if cnt > 0 and abs(ratio) < ign:
                clamped = min(max(cur, f(per * lo)), f(per * hi))
                new = (fma32(g, clamped, f(omg * per)) if fuse_gain else
                       fma32(omg, per, f(g * clamped)))
            g_now = _i32(gidx + p)
            if last >= 0:
                slot = min(k, DPLL_MAX_EVENTS - 1)
                row = np.array([_i32(g_now - last), new, cur], f)
                events[r, slot] = events[r, slot] + row
                k += 1
            periods[r, p] = new
            per, ph, cnt, last = new, f(0.0), _i32(cnt + 1), g_now
            i = p + 1
        n_ev[r] = min(k, DPLL_MAX_EVENTS)
        st["period"][r], st["phase"][r] = per, ph
        st["count"][r], st["last_idx"][r] = cnt, last
        st["global_idx"][r] = _i32(gidx + n)
    dev = pulses.device
    new_state = {k: torch.from_numpy(
        v.astype(np.float32 if k in ("period", "phase") else np.int32)
    ).to(dev) for k, v in st.items()}
    return (torch.from_numpy(x.astype(np.uint8)).to(dev),
            torch.from_numpy(periods).to(dev),
            torch.from_numpy(events).to(dev),
            torch.from_numpy(n_ev).to(dev), new_state)


class DPLLBitSync(Block):
    """Pulse-train digital PLL (baz_dpll_bb). Tracks the period of a
    pulse train (bit-bytes, nonzero = pulse): each pulse's measured
    period updates the estimate through a gain-weighted EWMA, clamped to
    ``relative_limit`` and ignored beyond ``ignore_limit``. Outputs: the
    pulses, the period estimate per sample, and period-measurement events
    [512, 3] = (index diff, period, measured period)."""

    n_out = 3
    MAX_EVENTS = DPLL_MAX_EVENTS

    def __init__(self, period: float, gain: float = 0.05,
                 relative_limit: float = 0.05, ignore_limit: float = 0.5,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.period0 = float(period)
        self.gain = float(gain)
        self.rel = float(relative_limit)
        self.ign = float(ignore_limit)

    def init_state(self):
        d = self.device
        return dict(period=scalar(np.float32(self.period0), torch.float32, d),
                    phase=scalar(0.0, torch.float32, d),
                    count=scalar(0, torch.int32, d),
                    last_idx=scalar(-1, torch.int32, d),
                    global_idx=scalar(0, torch.int32, d))

    def apply(self, state, params, x: Stream):
        from grbaz_tpu_torch.ops.cuda.dpll_walk import dpll_walk
        pulses, periods, ev, n_ev, new = dpll_walk(
            x.data.reshape(1, -1), {k: v.reshape(1) for k, v in state.items()},
            self.gain, self.rel, self.ign)
        return ({k: v.reshape(()) for k, v in new.items()},
                (x.like(pulses[0], count=x.count),
                 x.like(periods[0], count=x.count),
                 Stream(data=ev[0], count=n_ev[0], meta=x.meta)))


# ---------------------------------------------------------------------------
# ACARS decoder
# ---------------------------------------------------------------------------

ACARS_PREAMBLE = 0x3FFE5C5C  # air-interface encoded
ACARS_MAX_PACKET = 252
ACARS_MAX_PKTS = 4
ACARS_STX_INDEX = 1 + 1 + 7 + 1 + 2 + 1  # SOH+mode+addr7+ack+label2+dbi
# the decoder's scalar state, in the order of the kernel's int32 rows
# (``searching`` and ``got_etx`` as 0/1, ``shift`` as its bits)
ACARS_FIELDS = ("searching", "shift", "prev_bit", "cur_byte", "bit_count",
                "byte_count", "parity_errors", "etx_index", "got_etx")
_REV8 = [int(f"{b:08b}"[::-1], 2) for b in range(256)]
_POP8 = np.array([bin(b).count("1") for b in range(256)], np.int64)


def _popcount32(v: np.ndarray) -> np.ndarray:
    """Set bits of each uint32 value held in int64."""
    return sum(_POP8[(v >> s) & 0xFF] for s in (0, 8, 16, 24))


def acars_plain(metrics: torch.Tensor, state: dict, threshold: int):
    """The ACARS FSM over rows ``metrics`` [B, n] (> 0: air bit 0) from
    ``state`` ([B] tensors of :data:`ACARS_FIELDS`, ``shift`` uint32 in
    int64, and ``pkt`` [B, 252] float32). Returns (packets [B, 4, 254]
    float32, packet count [B] int32, the new state) on ``metrics``'s
    device.

    The serial mirror of the JAX block's scan. While the FSM searches,
    every field but the correlator's register and ``prev_bit`` holds; the
    register is the last 32 air bits whatever the state, and ``prev_bit``
    the running XOR of the air bits since the last sync. So the loop
    finds the next sync among the precomputed correlations and walks bit
    by bit only inside a packet."""
    m = metrics.detach().cpu().numpy().astype(np.float32)
    rows, n = m.shape
    st = _rows_state({k: v for k, v in state.items() if k != "pkt"}, rows)
    pkt = state["pkt"].detach().cpu().numpy().reshape(
        rows, ACARS_MAX_PACKET).astype(np.float32).copy()
    out = np.zeros((rows, ACARS_MAX_PKTS, 2 + ACARS_MAX_PACKET), np.float32)
    n_pk = np.zeros(rows, np.int32)
    for r in range(rows):
        bits = (~(m[r] > np.float32(0.0))).astype(np.int64)
        s = {k: int(st[k][r]) for k in ACARS_FIELDS}
        # the register after each step: the last 32 air bits, the carried
        # register's bits before the block's
        hist = np.concatenate([(s["shift"] >> np.arange(31, -1, -1)) & 1,
                               bits])
        win = np.lib.stride_tricks.sliding_window_view(hist, 33)[:, 1:]
        shifts = (win << np.arange(31, -1, -1)).sum(1)
        wrong = _popcount32(shifts ^ ACARS_PREAMBLE)
        syncs = np.flatnonzero(wrong <= threshold)
        cxor = np.cumsum(bits) & 1           # XOR of bits[0..i]
        k, i = 0, 0
        while i < n:
            if s["searching"]:
                j = np.searchsorted(syncs, i)
                if j == len(syncs):
                    s["prev_bit"] ^= int(cxor[n - 1] ^ (cxor[i - 1] if i
                                                        else 0))
                    break
                j = int(syncs[j])
                s.update(searching=0, prev_bit=0, cur_byte=0, bit_count=0,
                         byte_count=0, parity_errors=0, etx_index=-1,
                         got_etx=0)
                pkt[r] = 0.0
                i = j + 1
                continue
            dec = s["prev_bit"] ^ int(bits[i])
            s["prev_bit"] = dec
            cur = (s["cur_byte"] << 1) | dec
            bc_bits = s["bit_count"] + 1
            if bc_bits != 8:
                s["cur_byte"], s["bit_count"] = cur, bc_bits
                i += 1
                continue
            # a byte is done
            bc = s["byte_count"]
            val = _REV8[cur & 0xFF] & 0x7F
            pkt[r, min(max(bc, 0), ACARS_MAX_PACKET - 1)] = val
            is_etx = bc > ACARS_STX_INDEX and val == 0x03
            got_del = (s["etx_index"] > 0 and bc == s["etx_index"] + 3
                       and val == 0x7F)
            if is_etx:
                s["got_etx"] = 1
                if s["etx_index"] < 0:
                    s["etx_index"] = bc
            if bin(cur).count("1") % 2 == 0:
                s["parity_errors"] += 1
            s["cur_byte"], s["bit_count"] = 0, 0
            if got_del or bc + 1 >= ACARS_MAX_PACKET:
                slot = min(k, ACARS_MAX_PKTS - 1)
                row = np.concatenate([np.array(
                    [bc + 1, s["parity_errors"]], np.float32), pkt[r]])
                out[r, slot] = out[r, slot] + row
                k += 1
                s.update(searching=1, byte_count=0, parity_errors=0,
                         etx_index=-1, got_etx=0)
                pkt[r] = 0.0
            else:
                s["byte_count"] = bc + 1
            i += 1
        s["shift"] = int(shifts[-1]) if n else s["shift"]
        n_pk[r] = min(k, ACARS_MAX_PKTS)
        for name in ACARS_FIELDS:
            st[name][r] = s[name]
    dev = metrics.device
    new = {k: torch.from_numpy(v.astype(np.int64 if k == "shift" else
                                        np.int32)).to(dev)
           for k, v in st.items()}
    new["searching"] = new["searching"] != 0
    new["got_etx"] = new["got_etx"] != 0
    new["pkt"] = torch.from_numpy(pkt).to(dev)
    return torch.from_numpy(out).to(dev), torch.from_numpy(n_pk).to(dev), new


class ACARSDecoder(Block):
    """ACARS aviation telemetry decoder (baz_acars_decoder).

    Input: float bit metrics (> 0: air bit 0, else air bit 1). A 32-bit
    preamble correlator with a wrong-bit threshold, then differential
    decoding, LSB-first bytes with odd parity, bit reversal & 0x7F and
    SOH/STX/ETX/DEL framing. Completed packets are rows of
    ``[MAX_PKTS, 2 + 252]`` float32: [n_bytes, parity errors, bytes...]."""

    MAX_PKTS = ACARS_MAX_PKTS
    STX_INDEX = ACARS_STX_INDEX

    def __init__(self, preamble_threshold: int = 2, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.thr = int(preamble_threshold)

    def init_state(self):
        d = self.device
        st = {k: scalar(0, torch.int32, d) for k in ACARS_FIELDS}
        st.update(searching=scalar(True, torch.bool, d),
                  shift=scalar(0, torch.int64, d),
                  etx_index=scalar(-1, torch.int32, d),
                  got_etx=scalar(False, torch.bool, d),
                  pkt=torch.zeros(ACARS_MAX_PACKET, dtype=torch.float32,
                                  device=d))
        return st

    def apply(self, state, params, x: Stream):
        from grbaz_tpu_torch.ops.cuda.acars_fsm import acars_fsm
        out, n_pk, new = acars_fsm(
            x.data.to(torch.float32).reshape(1, -1),
            {k: v.reshape(1, -1) if k == "pkt" else v.reshape(1)
             for k, v in state.items()}, self.thr)
        return ({k: v.reshape(-1) if k == "pkt" else v.reshape(())
                 for k, v in new.items()},
                (Stream(data=out[0], count=n_pk[0], meta=x.meta),))
