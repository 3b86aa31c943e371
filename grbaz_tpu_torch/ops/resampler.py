"""Arbitrary-ratio MMSE fractional resampler with exact 32.32 positions
(port of ``grbaz_tpu/ops/resampler.py``).

Each call processes a fixed-size input block and produces a statically
bounded output block with a validity count. At a fixed ratio all output
positions ``p_k = mu0 + k*inc`` come from the exact fixed-point ramp of
:mod:`.exact`, and each output interpolates with the 8-tap MMSE filter
of its phase bin. The ratio-stream mode (:class:`VariableRatioResampler`)
reads its increment at the position it produces, so it walks its
positions one by one (a CUDA kernel on the card, :func:`vrr_walk_plain`
on the CPU).

Two forms of the fixed ratio, as in the JAX package: the generic gather
form (:func:`resample_block`) and the polyphase form for rational ratios p/q
(:func:`resample_block_rational`), whose exactness guard falls back to
the generic form. The JAX package picks between the two with a
``lax.cond``; a Python branch on a device boolean would wait for the
card every block, so here the rational form computes both and
``torch.where`` selects on the guard.

:class:`FractionalResampler` runs the generic form on every device. The
rational form exists because element gathers are slow on a TPU; on an
H100 gathers are cheap, and the rational form with its guard measured
5x the generic form's time at the WBFM audio shape (PERF.md).
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar, take
from grbaz_tpu_torch.core.stream import Stream, stream_flags
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.mmse import NSTEPS_LOG2, NTAPS, TAPS_TABLE

HIST = NTAPS - 1

# rational form: window width with the +/-1 residual-shift margin folded
# in, and the mu_int range its clamped window starts tolerate
_RW = NTAPS + 2
_MU_SLACK = 64


def _positions(frame, mu_int, mu_frac, inc_int, inc_frac, cap, n_valid):
    """Exact output positions shared by both forms."""
    n_new = frame.shape[0] - HIST
    if n_valid is None:
        n_valid = scalar(n_new, torch.int32, frame.device)
    idx, frac = exact.fixed_positions(cap + 1, mu_frac, inc_int, inc_frac)
    idx = idx + mu_int.to(torch.int64)
    # output k is computable iff its window fits: idx_k + NTAPS <= HIST + n_valid
    valid = idx[:cap] <= n_valid - 1
    n_out = valid.sum(dtype=torch.int32)
    bins = exact.frac_to_phase_bin(frac[:cap], NSTEPS_LOG2)
    new_mu_int = (take(idx, n_out) - n_new).to(torch.int32)
    new_mu_frac = take(frac, n_out)
    return idx, valid, n_out, bins, new_mu_int, new_mu_frac, n_valid


def _planes(frame: torch.Tensor, fn):
    if frame.is_complex():
        return torch.complex(fn(frame.real), fn(frame.imag))
    return fn(frame).to(frame.dtype)


def resample_block(frame: torch.Tensor, mu_int: torch.Tensor,
                   mu_frac: torch.Tensor, inc_int: torch.Tensor,
                   inc_frac: torch.Tensor, out_capacity: int,
                   taps_table: torch.Tensor, n_valid=None):
    """Resample one frame of ``HIST + N`` samples (HIST carried history).

    Output k interpolates at frame position ``mu + k*inc`` (+ the MMSE
    group delay), from ``frame[idx_k : idx_k + NTAPS]``. Returns
    ``(y[out_capacity], n_out, new_mu_int, new_mu_frac)``; the new mu is
    in next-frame coordinates.
    """
    cap = out_capacity
    n_new = frame.shape[0] - HIST
    idx, valid, n_out, bins, mu_i, mu_f, _ = _positions(
        frame, mu_int, mu_frac, inc_int, inc_frac, cap, n_valid)
    taps = taps_table[bins]                       # [cap, NTAPS]
    base = torch.clamp(idx[:cap], 0, n_new - 1)
    win_idx = base[:, None] + torch.arange(NTAPS, device=frame.device)[None]
    y = _planes(frame, lambda pl: (pl[win_idx] * taps).sum(dim=1))
    return torch.where(valid, y, torch.zeros_like(y)), n_out, mu_i, mu_f


def _rational_of(ratio: float, max_den: int = 64):
    """(p, q) with ratio ~= p/q, q <= max_den, or None. The rational form
    also needs p >= _RW (the window fits one polyphase row)."""
    fr = Fraction(ratio).limit_denominator(max_den)
    if fr.denominator > max_den or fr.numerator < _RW:
        return None
    if abs(float(fr) - ratio) > 1e-9 * max(ratio, 1.0):
        return None
    return int(fr.numerator), int(fr.denominator)


def resample_block_rational(frame: torch.Tensor, mu_int: torch.Tensor,
                            mu_frac: torch.Tensor, inc_int: torch.Tensor,
                            inc_frac: torch.Tensor, out_capacity: int,
                            taps_table: torch.Tensor, p: int, q: int,
                            n_valid=None):
    """Polyphase form for (near-)rational ratios p/q.

    Output ``k = q*j + u`` starts at ``mu_int + p*j + s_u + d_k`` with
    ``s_u = floor(u*p/q)`` static and the residual ``d_k`` in {-1,0,1};
    its phase bin drifts at most +/-1 from its residue's first bin. The
    windows are strided rows ``frame[mu_int + p*j + s_u - 1 : +_RW]``,
    the taps one of three per-residue candidates, and each output's
    exact (bin, d) is still computed from the exact ramp. If any valid
    output falls outside the candidates (a large runtime retune, or a
    start position outside [0, _MU_SLACK]), the generic form's result is
    selected: the fast form is never approximate.

    Returns the same tuple as :func:`resample_block`, equal to it up to
    f32 product regrouping.
    """
    cap = out_capacity
    dev = frame.device
    idx, valid, n_out, bins, mu_i, mu_f, n_valid = _positions(
        frame, mu_int, mu_frac, inc_int, inc_frac, cap, n_valid)

    nj = -(-cap // q)
    k = torch.arange(cap, dtype=torch.int64, device=dev)
    d = idx[:cap] - (mu_int.to(torch.int64) + (k * p) // q)    # in {-1,0,1}
    b_u = bins[:q]
    db = bins - b_u.repeat(nj)[:cap]                         # in {-1,0,1}
    matched = (d.abs() <= 1) & (db.abs() <= 1)
    ok = torch.all(matched | ~valid) & (mu_int >= 0) & (mu_int <= _MU_SLACK)

    n_bins = taps_table.shape[0]
    t_cand = [taps_table[torch.clamp(b_u + s, 0, n_bins - 1)].T
              .repeat(1, nj)[:, :cap] for s in (-1, 0, 1)]   # [NTAPS, cap]
    t_sel = torch.where(db == -1, t_cand[0],
                        torch.where(db == 0, t_cand[1], t_cand[2]))

    # window rows W[r, j, u] = fp[mu_c + s_u + p*j + r] of the frame with
    # one zero in front (so the d = -1 row stays in range)
    s_u = (torch.arange(q, device=dev) * p) // q
    need = _MU_SLACK + ((q - 1) * p) // q + nj * p + _RW
    pad_back = max(0, need + 1 - (1 + frame.shape[0]))
    fp = torch.cat([frame.new_zeros(1), frame, frame.new_zeros(pad_back)])
    mu_c = torch.clamp(mu_int.to(torch.int64), 0, _MU_SLACK)
    r = torch.arange(_RW, device=dev)
    j = torch.arange(nj, device=dev)
    win = (r[:, None, None] + p * j[None, :, None] + s_u[None, None, :]
           + mu_c).reshape(_RW, nj * q)[:, :cap]             # [_RW, cap]

    def dot_w(plane):
        w = plane[win]
        cands = [(w[1 + dv:1 + dv + NTAPS] * t_sel).sum(dim=0)
                 for dv in (-1, 0, 1)]
        return torch.where(d == -1, cands[0],
                           torch.where(d == 0, cands[1], cands[2]))

    fast = _planes(fp, dot_w)
    fast = torch.where(valid, fast, torch.zeros_like(fast))
    slow, _, _, _ = resample_block(frame, mu_int, mu_frac, inc_int, inc_frac,
                                   cap, taps_table, n_valid=n_valid)
    return torch.where(ok, fast, slow), n_out, mu_i, mu_f


class FractionalResampler(Block):
    """Streaming resampler block (generic gather form); the ratio lives
    in ``params`` (retunable). ``min_ratio`` bounds the static output
    capacity, ``capacity = ceil(block_size / min_ratio) + 1``; by default
    the ratio may retune down to 90% of the construction ratio."""

    def __init__(self, block_size: int, ratio: float, *,
                 min_ratio: float = None, dtype=torch.complex64,
                 phase_shift: float = 0.0, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.ratio0 = float(ratio)
        self.min_ratio = float(min_ratio if min_ratio is not None
                               else ratio * 0.9)
        self.capacity = int(math.ceil(self.block_size / self.min_ratio)) + 1
        if not (0.0 <= phase_shift <= 1.0):
            raise ValueError("phase shift must be in [0, 1]")
        self.phase_shift = float(phase_shift)
        self.taps_table = torch.from_numpy(TAPS_TABLE).to(self.device)

    def init_state(self):
        # start at HIST + phase_shift: the first output interpolates at
        # the first new sample (+ mu)
        frac = int(round(self.phase_shift * exact.TWO32))
        ip = HIST + (1 if frac >= 2 ** 32 else 0)
        frac = 0 if frac >= 2 ** 32 else frac
        return dict(tail=torch.zeros(HIST, dtype=self.dtype,
                                     device=self.device),
                    mu_int=scalar(ip, torch.int32, self.device),
                    mu_frac=scalar(frac, torch.int64, self.device))

    def init_params(self):
        ip, fr = exact.ratio_to_fixed(self.ratio0)
        return dict(inc_int=scalar(int(ip), torch.int32, self.device),
                    inc_frac=scalar(int(fr), torch.int64, self.device))

    @staticmethod
    def ratio_params(ratio: float):
        """Host helper: params (numpy) for a new ratio (e.g. a ppb message)."""
        ip, fr = exact.ratio_to_fixed(ratio)
        return dict(inc_int=ip, inc_frac=fr)

    def apply(self, state, params, x: Stream):
        if x.data.shape[0] != self.block_size:
            raise ValueError(f"{self.name}: expected block of "
                             f"{self.block_size}, got {x.data.shape[0]}")
        frame = torch.cat([state["tail"], x.data])
        n_valid = torch.clamp(x.count, max=self.block_size)
        y, n_out, mu_int, mu_frac = resample_block(
            frame, state["mu_int"], state["mu_frac"], params["inc_int"],
            params["inc_frac"], self.capacity, self.taps_table,
            n_valid=n_valid)
        new_state = dict(tail=frame[-HIST:], mu_int=mu_int, mu_frac=mu_frac)
        out = x.like(y, count=n_out, rate_scale=1.0 / self.ratio0)
        return new_state, (out,)


# ---------------------------------------------------------------------------
# the ratio-stream mode
# ---------------------------------------------------------------------------

def vrr_walk_plain(x: torch.Tensor, tail: torch.Tensor, rr: torch.Tensor,
                   rr_tail: torch.Tensor, q0: torch.Tensor,
                   mu0: torch.Tensor, count: torch.Tensor, capacity: int,
                   taps_table: torch.Tensor):
    """The ratio-stream walk of :class:`VariableRatioResampler` over one
    block ``x`` [n] (float32 or complex64) with the ratio stream ``rr``
    [n], each after its carried tail of HIST samples, from the position
    ``q0`` (int32) + ``mu0`` (uint32 in int64) in frame coordinates.

    Output k interpolates ``frame[q_k : q_k + NTAPS]`` with the taps of
    the phase bin of ``mu_k``; then ``inc = rr_frame[q_k]`` (q clipped to
    the last window start), ``ip = floor(inc)``, ``fr = u32((inc - ip) *
    2^32)`` in float32, and ``(q, mu) += (ip, fr)`` with mu's carry. The
    walk stops at the first slot whose window does not fit the ``count``
    valid samples; the slots after it are zeros.

    The positions come from a host loop of Python integers over the 64-bit
    position ``(q << 32) + mu``, the steps' float32 arithmetic vectorized
    in numpy first; the interpolation is torch. Returns (y [capacity],
    count int32, the new q int32 = max(q_end - n, 0), the new mu int64,
    overran bool = q_end < n, the new tail, the new ratio tail) on ``x``'s
    device."""
    dev = x.device
    n = x.shape[0]
    frame = torch.cat([tail, x])
    rr_frame = torch.cat([rr_tail, rr.to(torch.float32)])
    hi = HIST + n - NTAPS
    inc = rr_frame.detach().cpu().numpy().astype(np.float32)
    ip = np.floor(inc)
    fr = ((inc - ip) * np.float32(2.0 ** 32)).astype(np.int64)
    steps = ((ip.astype(np.int64) << 32) + fr).tolist()
    limit = min(int(count), n) + HIST
    pos = (int(q0) << 32) + (int(mu0) & U32_MASK)
    qs, mus = [], []
    while len(qs) < capacity:
        q = pos >> 32
        if q + NTAPS > limit:
            break
        qc = min(max(q, 0), hi)
        qs.append(qc)
        mus.append(pos & U32_MASK)
        pos += steps[qc]
    k = len(qs)
    q_end = pos >> 32
    y = torch.zeros(capacity, dtype=frame.dtype, device=dev)
    if k:
        q_t = torch.tensor(qs, dtype=torch.int64, device=dev)
        bins = exact.frac_to_phase_bin(torch.tensor(mus, dtype=torch.int64,
                                                    device=dev), NSTEPS_LOG2)
        win = q_t[:, None] + torch.arange(NTAPS, device=dev)[None]
        taps = taps_table.to(dev)[bins]
        y[:k] = _planes(frame, lambda pl: (pl[win] * taps).sum(dim=1))
    return (y, torch.tensor(k, dtype=torch.int32, device=dev),
            torch.tensor(max(q_end - n, 0), dtype=torch.int32, device=dev),
            torch.tensor(pos & U32_MASK, dtype=torch.int64, device=dev),
            torch.tensor(q_end < n, device=dev),
            frame[frame.shape[0] - HIST:], rr_frame[rr_frame.shape[0] - HIST:])


class VariableRatioResampler(Block):
    """Ratio-stream mode of the fractional resampler: a second float
    input carries the resampling ratio (input samples an output) for each
    input sample. Each output interpolates at (q, mu), then ``inc =
    rr[q]``, ``mu += inc``, ``q += floor``, in exact 32.32 fixed point.

    The position is self-referential (the increment is read at the
    current position), so there is no closed-form ramp: the walk runs on
    the kernel ``csrc/vrr_walk.cu`` on the card and on
    :func:`vrr_walk_plain` on the CPU (``ops/cuda/vrr_walk.py``).

    Inputs: (signal float32 or complex64 [N], ratio float32 [N]); output:
    ``capacity = ceil(N * max_outputs_per_input) + 1`` samples with a
    data-dependent valid count. If the ratio stream wants more outputs
    than the capacity, the block skips ahead to keep the position valid
    and raises BUFFER_OVERRUN in the output stream's flags.
    """

    n_in = 2

    def __init__(self, block_size: int, max_outputs_per_input: float = 2.0,
                 dtype=torch.complex64, nominal_ratio: float | None = None,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.capacity = int(math.ceil(block_size * max_outputs_per_input)) + 1
        self.nominal_ratio = nominal_ratio  # for the output meta only
        self.taps_table = torch.from_numpy(TAPS_TABLE).to(self.device)

    def init_state(self):
        return dict(
            tail=torch.zeros(HIST, dtype=self.dtype, device=self.device),
            rr_tail=torch.zeros(HIST, dtype=torch.float32,
                                device=self.device),
            q_int=scalar(HIST, torch.int32, self.device),
            mu_frac=scalar(0, torch.int64, self.device))

    def apply(self, state, params, x: Stream, rr: Stream):
        from grbaz_tpu_torch.ops.cuda.vrr_walk import vrr_walk
        n = self.block_size
        if x.data.shape[0] != n or rr.data.shape[0] != n:
            raise ValueError(f"{self.name}: expected blocks of {n}")
        y, count, q, mu, overran, tail, rr_tail = vrr_walk(
            x.data, state["tail"], rr.data.to(torch.float32),
            state["rr_tail"], state["q_int"], state["mu_frac"], x.count,
            self.capacity, self.taps_table)
        rate_scale = (1.0 / self.nominal_ratio) if self.nominal_ratio \
            else 1.0
        out = x.like(y, count=count, rate_scale=rate_scale)
        out.meta = dataclasses.replace(out.meta, flags=out.meta.flags | (
            overran.to(torch.int64) * stream_flags.BUFFER_OVERRUN))
        return dict(tail=tail, rr_tail=rr_tail, q_int=q, mu_frac=mu), (out,)
