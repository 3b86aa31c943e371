"""Peak detector (port of ``PeakDetector`` of ``grbaz_tpu/ops/detect.py``).

The rise/fall peak FSM with min_diff, min_len, drop, alpha smoothing
and an optional threshold, block-parallel for ``lockout == 0`` and
``look_ahead == 0``: a "rise" is a maximal run of ``cond = (x >= thr) &
(x > ave*(1-drop))`` samples, so the FSM decomposes into segment
structure, a segmented prefix max with the first position of the max
(the peak and its index) and qualification at run ends
(:mod:`.segments`). Carried state seeds a rise that spans blocks.

``lockout > 0`` or ``look_ahead > 0`` couple emissions back into the
segment structure, a sequential chain that the JAX package runs as a
per-sample ``lax.scan``; the port raises for those until the per-sample
FSMs get one strategy for the card (ROADMAP item 11). The state's
integers are int32, as in the JAX package, so checkpoints load both
ways.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.iir import onepole_scan
from grbaz_tpu_torch.ops.segments import (NO_POS, running_last_true,
                                          running_max, seg_prefix_max,
                                          seg_prefix_maxpos)


def _shift_in(first: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``concat([first], x[:-1])``."""
    return torch.cat([first.reshape(1).to(x.dtype), x[:-1]])


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

    def apply(self, state, params, x: Stream):
        if self.lockout > 0 or self.look_ahead > 0:
            raise NotImplementedError(
                "PeakDetector with lockout > 0 or look_ahead > 0 is the "
                "per-sample FSM, not ported yet (ROADMAP item 11)")
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
        xprev = _shift_in(state["prev"], xf)
        if self.alpha == 1.0:
            ave = xprev
        else:
            ave = onepole_scan(float(np.float32(self.alpha)) * xprev,
                               1.0 - self.alpha, state["ave"])
        cond = (xf >= thr) & (xf > ave * (1.0 - self.drop))
        # the carried lockout prefix (a new stream starts with one locked
        # sample, as the reference's d_lockout_count = 1)
        cond = cond & (idx >= state["lockout_count"])

        prev_in = _shift_in(state["rising"], cond)
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
            _shift_in(scalar(NO_POS, torch.int32, xf.device), incl),
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
