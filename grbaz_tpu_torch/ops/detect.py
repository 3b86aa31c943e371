"""Detectors: peak detector, sync correlator, radar pulse detector (port
of ``grbaz_tpu/ops/detect.py``).

* :class:`PeakDetector`: the rise/fall peak FSM with min_diff, min_len,
  drop, alpha smoothing and an optional threshold. Block-parallel for
  ``lockout == 0`` and ``look_ahead == 0``: a "rise" is a maximal run of
  ``cond = (x >= thr) & (x > ave*(1-drop))`` samples, so the FSM
  decomposes into segment structure, a segmented prefix max with the
  first position of the max (the peak and its index) and qualification
  at run ends (:mod:`.segments`); carried state seeds a rise that spans
  blocks. ``lockout > 0`` or ``look_ahead > 0`` couple emissions back
  into the segment structure, a serial chain that the JAX package runs
  as a per-sample ``lax.scan``: on the card it is the hand-written FSM
  kernel (``ops/cuda/peak_fsm.py``, one thread walks each stream), and
  :func:`peak_fsm_plain` is its plain version. The state's integers are
  int32, as in the JAX package, so checkpoints load both ways.
* :class:`Correlator`: sliding correlation against a known sync, per
  window peak picking and a correlation surface.
* :class:`RadarDetector`: threshold pulse detector emitting per-burst
  reports as an event array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream, bits_to_f32, decode_i32
from grbaz_tpu_torch.ops.burst import _event_pack
from grbaz_tpu_torch.ops.fir import fft_fir_frame
from grbaz_tpu_torch.ops.iir import onepole_scan
from grbaz_tpu_torch.ops.segments import (NO_POS, running_last_true,
                                          running_max, seg_prefix_max,
                                          seg_prefix_maxpos, seg_prefix_sum,
                                          shift_in)


def _shift_out(x: torch.Tensor, last) -> torch.Tensor:
    """``concat(x[1:], [last])``."""
    return torch.cat([x[1:], torch.full((1,), last, dtype=x.dtype,
                                        device=x.device)])


class PeakDetector(Block):
    """Rise/fall peak detection FSM. Outputs (marks, idx_diff): ``marks``
    is 1.0 at each detected peak (0 elsewhere); ``idx_diff`` (int32) is
    the distance to the previous peak at mark positions."""

    n_out = 2

    def __init__(self, min_diff: float = 0.0, min_len: int = 1,
                 lockout: int = 0, drop: float = 0.0, alpha: float = 1.0,
                 look_ahead: int = 0, threshold: Optional[float] = None,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.min_diff = float(min_diff)
        self.min_len = int(min_len)
        self.lockout = int(lockout)
        self.drop = float(drop)
        self.alpha = float(alpha)
        self.look_ahead = int(look_ahead)
        self.threshold = threshold

    def init_state(self):
        def s(v, dtype):
            return scalar(v, dtype, self.device)
        f32, i32 = torch.float32, torch.int32
        return dict(ave=s(0.0, f32), prev=s(0.0, f32),
                    rising=s(False, torch.bool), rise_count=s(0, i32),
                    first=s(0.0, f32), peak=s(0.0, f32),
                    peak_age=s(0, i32),         # samples since the peak
                    lockout_count=s(1, i32),
                    last_peak_global=s(-1, i32),
                    global_idx=s(0, i32))

    def init_params(self):
        thr = self.threshold
        return dict(threshold=scalar(
            float(np.float32(-np.inf if thr is None else thr)),
            torch.float32, self.device))

    def fsm_config(self) -> dict:
        """The FSM's constants, as :func:`peak_fsm_plain` and the kernel
        take them."""
        return dict(min_diff=self.min_diff, min_len=self.min_len,
                    lockout=self.lockout, drop=self.drop, alpha=self.alpha,
                    look_ahead=self.look_ahead)

    def apply(self, state, params, x: Stream):
        if self.lockout > 0 or self.look_ahead > 0:
            return self._apply_fsm(state, params, x)
        md, ml = float(np.float32(self.min_diff)), self.min_len
        thr = params["threshold"]
        neg_inf = float("-inf")

        xf = x.data.to(torch.float32).contiguous()
        n = xf.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=xf.device)
        base = state["global_idx"]
        gidx = base + idx

        # smoothed average of the PREVIOUS sample (the reference updates
        # its average from in[i-1] before examining in[i])
        xprev = shift_in(state["prev"], xf)
        if self.alpha == 1.0:
            ave = xprev
        else:
            ave = onepole_scan(float(np.float32(self.alpha)) * xprev,
                               1.0 - self.alpha, state["ave"])
        cond = (xf >= thr) & (xf > ave * (1.0 - self.drop))
        # the carried lockout prefix (a new stream starts with one locked
        # sample, as the reference's d_lockout_count = 1)
        cond = cond & (idx >= state["lockout_count"])

        prev_in = shift_in(state["rising"], cond)
        start_e = cond & ~prev_in
        end_e = ~cond & prev_in

        # segment structure in global coordinates; a carried rise began
        # rise_count samples before this block
        seed_start = torch.where(state["rising"], base - state["rise_count"],
                                 NO_POS)
        seg_start = running_last_true(start_e, gidx, seed_start)
        in_carried = (torch.cumsum(start_e.to(torch.int32), 0) == 0) \
            & state["rising"]
        # first value of each segment: the value's bits ride as the
        # payload of a segmented "pick the start sample" max
        _, first_bits = seg_prefix_maxpos(
            start_e, torch.where(start_e, 1.0, 0.0), xf.view(torch.int32))
        first_arr = torch.where(in_carried, state["first"],
                                first_bits.view(torch.float32))

        # segmented prefix max + first position of the max. An end sample
        # contributes -inf, so the prefix AT the end sample equals the
        # state before it
        pv, pp = seg_prefix_maxpos(start_e, torch.where(cond, xf, neg_inf),
                                   gidx)
        carried_pos = base - 1 - state["peak_age"]
        take_c = in_carried & (state["peak"] >= pv)
        pv = torch.where(take_c, state["peak"], pv)
        pp = torch.where(take_c, carried_pos, pp)
        rc_at = gidx - seg_start      # rise length at an end sample

        qual = (rc_at >= ml) & ((pv - first_arr) >= md)
        emits = end_e & qual

        # sample i is marked iff it is the FINAL first-max of a segment
        # whose end edge emits: (a) the running first-max at i, (b)
        # nothing strictly greater later in the segment (a reversed
        # segmented max), (c) the segment's end edge emits (its emit bit
        # carried backward over the segment)
        cond_next = _shift_out(cond, False)
        rst_rev = torch.flip(cond & ~cond_next, (0,))
        vals_seg = torch.where(cond, xf, neg_inf)
        suf = torch.flip(seg_prefix_max(rst_rev, torch.flip(vals_seg, (0,))),
                         (0,))
        later = torch.where(cond_next, _shift_out(suf, neg_inf), neg_inf)
        emit_on_last = _shift_out(emits, False)
        eback = torch.flip(seg_prefix_max(
            rst_rev, torch.flip(emit_on_last, (0,)).to(torch.int32)),
            (0,)) > 0
        marks_b = cond & (pp == gidx) & (later <= xf) & eback

        # a carried segment whose emitted peak lies in an EARLIER block
        # marks sample 0
        carried_emit = emits & (pp < base)
        m0 = carried_emit.any()
        pos0 = torch.where(carried_emit, pp, NO_POS).max()

        # previous-peak chain for idx_diff (marked positions are
        # monotone, so "last emitted peak before me" is a running max)
        seed_last = torch.where(state["last_peak_global"] >= 0,
                                state["last_peak_global"], NO_POS)
        seed_chain = torch.maximum(seed_last, torch.where(m0, pos0, NO_POS))
        incl = running_max(torch.where(marks_b, gidx, NO_POS))
        lastb = torch.maximum(
            shift_in(scalar(NO_POS, torch.int32, xf.device), incl),
            seed_chain)
        diffs = torch.where(lastb > NO_POS, gidx - lastb, 0)
        diff0 = torch.where(seed_last > NO_POS, pos0 - seed_last, 0)

        at0 = (idx == 0) & m0
        marks = marks_b.to(torch.float32) + at0.to(torch.float32)
        idx_out = torch.where(marks_b, diffs, 0) + torch.where(at0, diff0, 0)

        rising_end = cond[-1]
        m_last = torch.maximum(incl[-1], seed_chain)
        zero_i = torch.zeros((), dtype=torch.int32, device=xf.device)
        new_state = dict(
            ave=ave[-1],
            prev=xf[-1],
            rising=rising_end,
            rise_count=torch.where(rising_end, gidx[-1] - seg_start[-1] + 1,
                                   zero_i),
            first=torch.where(rising_end, first_arr[-1], 0.0),
            peak=torch.where(rising_end, pv[-1], 0.0),
            peak_age=torch.where(rising_end, gidx[-1] - pp[-1], zero_i),
            lockout_count=torch.clamp(state["lockout_count"] - n, min=0),
            last_peak_global=torch.where(m_last > NO_POS, m_last, -1),
            global_idx=base + n)
        return new_state, (x.like(marks, count=x.count),
                           x.like(idx_out.to(torch.int32), count=x.count))

    def _apply_fsm(self, state, params, x: Stream):
        """The serial FSM over the block as one stream: the kernel on the
        card, :func:`peak_fsm_plain` on the CPU."""
        from grbaz_tpu_torch.ops.cuda.peak_fsm import peak_fsm
        marks, idx_out, new = peak_fsm(
            x.data.to(torch.float32).reshape(1, -1),
            {k: v.reshape(1) for k, v in state.items()},
            params["threshold"].reshape(1), **self.fsm_config())
        return ({k: v.reshape(()) for k, v in new.items()},
                (x.like(marks[0], count=x.count),
                 x.like(idx_out[0], count=x.count)))


# ---------------------------------------------------------------------------
# the serial FSM (lockout / look-ahead), plain version
# ---------------------------------------------------------------------------

# the FSM state: float32 and int32 fields (``rising`` is a bool)
FSM_F32 = ("ave", "prev", "first", "peak")
FSM_I32 = ("rise_count", "peak_age", "lockout_count", "last_peak_global",
           "global_idx")
# the fields one step reads and writes, in fsm_step's order
FSM_FIELDS = ("ave", "prev", "first", "peak", "rising", "rise_count",
              "peak_age", "lockout_count")


def fsm_state_list(st: dict, r: int) -> list:
    """Row ``r`` of the numpy state ``st`` as :func:`fsm_step`'s list."""
    return [np.float32(st[k][r]) for k in FSM_FIELDS[:4]] + [
        bool(st["rising"][r])] + [int(st[k][r]) for k in FSM_FIELDS[5:]]


def fsm_constants(min_diff, drop, alpha):
    """(alpha, 1 - alpha, 1 - drop, min_diff) rounded to float32 the way
    the JAX package's weakly typed Python floats are."""
    return (np.float32(alpha), np.float32(1.0 - alpha), np.float32(1.0 - drop),
            np.float32(min_diff))


def _fma32(a, p, c):
    """``fma(a, p, c)`` of float32 values, rounded to float32 once.

    The product is exact in float64 and the float64 sum ``s`` differs from
    the exact sum by ``err`` (TwoSum); rounding ``s`` to float32 is then
    the fused result unless ``s`` falls on a float32 midpoint, where the
    sign of ``err`` decides the side."""
    prod = float(a) * float(p)
    s = prod + float(c)
    r = np.float32(s)
    back = s - prod
    err = (prod - (s - back)) + (float(c) - back)
    if err and float(r) != s:
        other = np.nextafter(r, np.float32(np.inf if s > r else -np.inf))
        if float(r) + float(other) == 2.0 * s:
            r = other if (err > 0) == (other > r) else r
    return r


def _i32(v: int) -> int:
    """``v`` wrapped to int32, as the JAX package's int32 arithmetic."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def fsm_step(s: list, xi, t, gidx: int, k: tuple):
    """One step of the lockout / look-ahead FSM, in place on the state
    list ``s`` = [ave, prev, first, peak, rising, rise_count, peak_age,
    lockout_count] (numpy float32 and Python bool / int), for the sample
    ``xi`` at global index ``gidx`` with threshold ``t``; ``k`` is
    :func:`fsm_constants` followed by (min_len, lockout, look_ahead).
    Returns the emitted peak's global position, or None."""
    a, b, keep, md, min_len, lockout, look_ahead = k
    ave, prev, first, peak, rising, rc, pa, lc = s
    ave = _fma32(a, prev, b * ave)
    in_lock = lc > 0
    cond = bool(xi >= t) and bool(xi > ave * keep)
    rising_n, first_n, peak_n, pa_n, rc_n = rising, first, peak, pa, rc
    if not in_lock:
        start = cond and not rising
        rising_n = cond
        if start:
            first_n = xi
        if start or (cond and rising and xi > peak):
            peak_n, pa_n = xi, 0
        else:
            pa_n = _i32(pa + 1)
        rc_n = 1 if start else (_i32(rc + 1) if cond else rc)
    ended = rising and (not cond or (look_ahead > 0 and pa_n >= look_ahead))
    pos = None
    if (ended and not in_lock and rc_n >= min_len
            and peak_n - first_n >= md):
        pos = _i32(gidx - pa_n)
        lc = lockout
    else:
        lc = max(lc - 1, 0)
    rising = False if (ended and not in_lock) else rising_n
    rc = 0 if ended else rc_n
    s[:] = ave, xi, first_n, peak_n, rising, rc, pa_n, lc
    return pos


def peak_fsm_plain(x: torch.Tensor, state: dict, threshold: torch.Tensor, *,
                   min_diff: float, min_len: int, lockout: int, drop: float,
                   alpha: float, look_ahead: int):
    """The lockout / look-ahead peak FSM over ``x`` [B, n], one
    independent stream a row; ``state`` holds [B] tensors of the
    PeakDetector fields and ``threshold`` is [B] or [1]. Returns (marks
    [B, n] float32, idx_diff [B, n] int32, the new state) on ``x``'s
    device.

    The serial mirror of ``PeakDetector._apply_scan`` of the JAX package,
    a per-sample loop of :func:`fsm_step`. It runs over the rows' values
    on the host with numpy float32 scalars: one torch op for each FSM
    operation would cost ~150 us a sample on the CPU (~50 ops of ~3 us),
    minutes for one 2^20-sample block. The average is ``fma(alpha, prev,
    (1-alpha)*ave)``, one rounding for the product and one for the fused
    multiply-add, as XLA compiles the JAX scan's ``alpha*prev +
    (1-alpha)*ave`` on the CPU (and as the kernel computes it with
    ``__fmul_rn`` and ``__fmaf_rn``); every other product, sum and
    compare rounds on its own. A peak is marked by adding 1 at
    ``clip(peak_pos - base, 0, n-1)``, so peaks of earlier blocks sum at
    sample 0."""
    k = fsm_constants(min_diff, drop, alpha) + (min_len, lockout, look_ahead)
    xs = x.detach().to("cpu", torch.float32).numpy()
    rows, n = xs.shape
    thr = np.broadcast_to(threshold.detach().cpu().numpy()
                          .astype(np.float32).reshape(-1), (rows,))
    marks = np.zeros((rows, n), np.float32)
    idx_out = np.zeros((rows, n), np.int32)
    st = {k: v.detach().cpu().numpy().reshape(rows).copy()
          for k, v in state.items()}
    for r in range(rows):
        s = fsm_state_list(st, r)
        last, base = int(st["last_peak_global"][r]), int(st["global_idx"][r])
        for i in range(n):
            pos = fsm_step(s, xs[r, i], thr[r], _i32(base + i), k)
            if pos is not None:
                rel = min(max(_i32(pos - base), 0), n - 1)
                marks[r, rel] += 1.0
                if last >= 0:
                    idx_out[r, rel] = _i32(int(idx_out[r, rel]) + pos - last)
                last = pos
        for name, v in zip(FSM_FIELDS, s):
            st[name][r] = v
        st["last_peak_global"][r] = last
        st["global_idx"][r] = _i32(base + n)
    dev = x.device
    return (torch.from_numpy(marks).to(dev), torch.from_numpy(idx_out).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in st.items()})


# ---------------------------------------------------------------------------
# sync-sequence correlator
# ---------------------------------------------------------------------------

class Correlator(Block):
    """Sliding correlation against a known complex sync sequence
    (baz_correlator): ``corr[m] = sum_l frame[m+l] * conj(s[l])``. Per
    window of ``window_length`` inputs, the correlation-magnitude peak;
    at or above ``threshold`` it triggers. Outputs (surface [n_windows,
    width] float32 of ``width`` bins centred on each window's peak,
    trigger [n_windows] float32: the peak, 0 below threshold).

    A sync starting at input sample p peaks at output index ``p + L-1 +
    width//2`` (filter latency plus the surface margin). Syncs of 64
    samples or more correlate through :func:`.fir.fft_fir_frame`, as in
    the JAX package; shorter ones as a two-channel real ``conv1d`` over
    the real and imaginary planes (the JAX package's window matrix would
    be [n, L]: 528 MB at 2^20 x 63), with cuDNN's TF32 turned off for the
    call.
    """

    n_out = 2

    def __init__(self, sync, window_length: int, threshold: float,
                 width: int, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.sync = np.asarray(sync, np.complex64)
        self.L = len(self.sync)
        self.window_length = int(window_length)
        self.threshold0 = float(threshold)
        self.width = int(width)
        self.hist = self.L - 1 + self.width // 2
        c = np.conj(self.sync)
        self.taps = torch.from_numpy(c).to(self.device)
        # conv1d weights [out, in, L] over the planes (re, im):
        # re = re*c.re - im*c.im, im = re*c.im + im*c.re
        self.planes = torch.from_numpy(np.stack([
            np.stack([c.real, -c.imag]), np.stack([c.imag, c.real])])
            .astype(np.float32)).to(self.device)

    def init_state(self):
        return dict(tail=torch.zeros(self.hist, dtype=torch.complex64,
                                     device=self.device))

    def init_params(self):
        return dict(threshold=scalar(float(np.float32(self.threshold0)),
                                     torch.float32, self.device))

    def _correlate(self, frame: torch.Tensor) -> torch.Tensor:
        if self.L >= 64:
            return fft_fir_frame(frame, self.taps, decim=1)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            out = torch.nn.functional.conv1d(
                torch.view_as_real(frame).T[None].contiguous(), self.planes)
        return torch.complex(out[0, 0], out[0, 1])

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        w = self.window_length
        if n % w:
            raise ValueError("block size must be a multiple of window_length")
        frame = torch.cat([state["tail"], x.data.to(torch.complex64)])
        n_corr = n + self.width // 2
        mag = self._correlate(frame).abs().to(torch.float32)
        n_w = n // w
        wmag = mag[:n].reshape(n_w, w)
        pk = torch.argmax(wmag, dim=1)     # the first of equal maxima
        pkv = wmag.gather(1, pk[:, None])[:, 0]
        trig = torch.where(pkv >= params["threshold"], pkv, 0.0)
        dev = mag.device
        centers = pk + torch.arange(n_w, device=dev) * w
        off = torch.arange(self.width, device=dev) - self.width // 2
        sidx = torch.clamp(centers[:, None] + off[None, :], 0, n_corr - 1)
        surface = mag.index_select(0, sidx.reshape(-1)).reshape(n_w, -1)
        new_state = dict(tail=frame[-self.hist:])
        return new_state, (
            x.like(surface, count=n_w, rate_scale=1.0 / w),
            x.like(trig, count=n_w, rate_scale=1.0 / w))


# ---------------------------------------------------------------------------
# radar pulse detector
# ---------------------------------------------------------------------------

class RadarDetector(Block):
    """Pulse burst detector (baz_radar_detector). Input: a power stream.
    Emits per-burst reports (start_idx, length, max, sum) as an event
    array of ``MAX_EVENTS`` rows with a count; a report fires at the first
    sample below ``base_level * 10^(threshold_db/10)`` after a burst.

    Block-parallel on :mod:`.segments` (threshold edges, running-max
    segment starts, segmented prefix sum and max): per-burst values and
    the carried open burst are exact for any number of bursts; only the
    event list has a capacity, whose overflow ``state['dropped']``
    counts. The start index rides BITCAST int32 in field 0 (decode with
    :meth:`decode_events`). Sums take another order than the JAX
    package's (float64 cumulative sums) and agree to f32 rounding.
    """

    n_out = 1
    MAX_EVENTS = 256

    def __init__(self, base_level: float = 0.0, threshold_db: float = 10.0,
                 pulse_plateau_db: float = 1.0, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.base0 = float(base_level)
        self.thr0 = 10.0 ** (float(threshold_db) / 10.0)
        self.plat0 = 10.0 ** (float(pulse_plateau_db) / 10.0)

    def init_state(self):
        def s(v, dtype):
            return scalar(v, dtype, self.device)
        i32, f32 = torch.int32, torch.float32
        return dict(in_burst=s(False, torch.bool), start=s(0, i32),
                    bsum=s(0.0, f32), bmax=s(0.0, f32),
                    global_idx=s(0, i32),
                    dropped=s(0, i32))   # events lost to list overflow

    def init_params(self):
        def f(v):
            return scalar(float(np.float32(v)), torch.float32, self.device)
        return dict(base_level=f(self.base0), threshold=f(self.thr0))

    def apply(self, state, params, x: Stream):
        thr = params["base_level"] * params["threshold"]
        xd = x.data.to(torch.float32)
        n = xd.shape[0]
        above = xd >= thr
        prev_above = shift_in(state["in_burst"], above)
        starts_e = above & ~prev_above
        ends_e = ~above & prev_above
        gidx = state["global_idx"] + torch.arange(n, dtype=torch.int32,
                                                  device=xd.device)
        seg_start = running_last_true(starts_e, gidx, torch.where(
            state["in_burst"], state["start"], NO_POS))
        in_carried = (torch.cumsum(starts_e.to(torch.int32), 0) == 0) \
            & state["in_burst"]
        # below-threshold samples add 0 / -inf, so the prefix AT an end
        # sample is the burst's whole accumulation
        ssum = seg_prefix_sum(starts_e, torch.where(above, xd, 0.0)) \
            + torch.where(in_carried, state["bsum"], 0.0)
        smax = torch.maximum(
            seg_prefix_max(starts_e, torch.where(above, xd, float("-inf"))),
            torch.where(in_carried, state["bmax"], float("-inf")))
        still_open = above[-1]
        n_emit = ends_e.to(torch.int32).sum().to(torch.int32)
        new_state = dict(
            in_burst=still_open,
            start=torch.where(still_open, seg_start[-1], 0),
            bsum=torch.where(still_open, ssum[-1], 0.0),
            bmax=torch.where(still_open, smax[-1], 0.0),
            global_idx=state["global_idx"] + n,
            dropped=state["dropped"]
            + torch.clamp(n_emit - self.MAX_EVENTS, min=0))
        rows = torch.stack([bits_to_f32(seg_start),
                            (gidx - seg_start).to(torch.float32), smax, ssum],
                           dim=1)
        ev, n_ev = _event_pack(ends_e, rows, self.MAX_EVENTS)
        return new_state, (Stream(ev, n_ev, x.meta),)

    @staticmethod
    def decode_events(rows, count=None) -> np.ndarray:
        """Host-side decode: [n, 4] float64 (start_idx, len, max, sum)."""
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        rows = np.asarray(rows, np.float32)
        n = int(count) if count is not None else len(rows)
        rows = rows[:n]
        out = rows.astype(np.float64)
        out[:, 0] = decode_i32(rows[:, 0]).astype(np.float64)
        return out
