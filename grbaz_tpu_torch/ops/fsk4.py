"""4-level FSK (C4FM) symbol demodulator, the OP25 front half (port of
``grbaz_tpu/ops/fsk4.py``).

FM-discriminated floats in, 4-level symbols out at 4800 baud. Symbol
timing is recovered block-parallel with a polyphase eye metric:

1. resample the discriminator stream to S samples/symbol (the exact
   32.32 MMSE resampler, S = 8);
2. frame into [n_sym, S], after a carried partial symbol, so block
   boundaries are seamless;
3. score every sampling phase by its eye quality, the mean distance of
   its samples to the nearest of the 4 C4FM levels (levels from a
   running scale estimate), and pick the best, with hysteresis across
   blocks so a stable clock never jitters;
4. slice the chosen phase to dibits (P25 mapping +3,+1,-1,-3 ->
   01,00,10,11).

The carried partial symbol, the chosen phase and the column at that
phase are gathers with indices computed on the device (the JAX block's
``roll`` by a traced shift, clipped gather and ``take``), so ``apply``
never reads a value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar, take
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.mmse import TAPS_TABLE
from grbaz_tpu_torch.ops.resampler import HIST, resample_block

P25_SYMBOL_RATE = 4800.0
SPS = 8  # internal oversampling (samples per symbol)

_LEVELS = (-1.5, -0.5, 0.5, 1.5)


class FSK4Demod(Block):
    """float discriminator stream -> (dibits uint8, soft symbols f32)."""

    n_out = 2

    def __init__(self, channel_rate: float,
                 symbol_rate: float = P25_SYMBOL_RATE,
                 phase_hysteresis: float = 0.05, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.channel_rate = float(channel_rate)
        self.symbol_rate = float(symbol_rate)
        self.ratio = channel_rate / (SPS * symbol_rate)
        if self.ratio < 0.5:
            raise ValueError("channel rate too low for 8x oversampling")
        self.hyst = float(phase_hysteresis)
        self.taps_table = torch.from_numpy(TAPS_TABLE).to(self.device)
        self.levels = torch.tensor(_LEVELS, dtype=torch.float32,
                                   device=self.device)

    def init_state(self):
        dev = self.device
        return dict(
            tail=torch.zeros(HIST, dtype=torch.float32, device=dev),
            mu_int=scalar(HIST, torch.int32, dev),
            mu_frac=scalar(0, torch.int64, dev),
            buf=torch.zeros(SPS, dtype=torch.float32, device=dev),
            buf_count=scalar(0, torch.int32, dev),    # partial symbol carry
            phase=scalar(0, torch.int32, dev),        # chosen sampling phase
            scale=scalar(0.0, torch.float32, dev),    # eye scale EWMA
        )

    def init_params(self):
        ip, fr = exact.ratio_to_fixed(self.ratio)
        return dict(inc_int=scalar(int(ip), torch.int32, self.device),
                    inc_frac=scalar(int(fr), torch.int64, self.device),
                    scale_rate=scalar(0.1, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        dev = x.data.device
        cap = int(np.ceil(n / (self.ratio * 0.9))) + 2
        frame = torch.cat([state["tail"], x.data.to(torch.float32)])
        hi_rate, n2, mu_int, mu_frac = resample_block(
            frame, state["mu_int"], state["mu_frac"], params["inc_int"],
            params["inc_frac"], cap, self.taps_table,
            n_valid=torch.clamp(x.count, max=n))

        # frame into symbols after the carried partial symbol:
        # stream_buf[i] = buf[i] for i < buf_count, else hi_rate[i - bc]
        total_cap = SPS + cap
        bc = state["buf_count"].to(torch.int64)
        i = torch.arange(total_cap, dtype=torch.int64, device=dev)
        padded_hi = torch.cat([hi_rate.new_zeros(SPS), hi_rate])
        rolled_hi = padded_hi[(i + SPS - bc) % total_cap]
        padded_buf = torch.cat([state["buf"], hi_rate.new_zeros(cap)])
        stream_buf = torch.where(i < bc, padded_buf, rolled_hi)
        total = bc + n2
        max_sym = total_cap // SPS
        n_sym = total // SPS
        sym_mat = stream_buf[:max_sym * SPS].reshape(max_sym, SPS)
        sym_valid = torch.arange(max_sym, device=dev) < n_sym

        # leftover carry for the next block
        rem = total - n_sym * SPS
        j = torch.arange(SPS, dtype=torch.int64, device=dev)
        idx = torch.clamp(n_sym * SPS + j, 0, total_cap - 1)
        new_buf = torch.where(j < rem, stream_buf[idx],
                              stream_buf.new_zeros(()))

        # robust scale: mean |x| over valid symbols
        vmask = sym_valid[:, None]
        n_valid_sym = sym_valid.sum(dtype=torch.int32)
        mean_abs = (sym_mat.abs() * vmask).sum() / torch.clamp(
            n_valid_sym * SPS, min=1)
        sr = params["scale_rate"]
        scale = torch.where(state["scale"] > 0,
                            (1 - sr) * state["scale"] + sr * mean_abs,
                            mean_abs)
        unit = torch.clamp(scale, min=1e-9)   # ~ mean|level| = 1.0 nominal

        # eye metric per phase: distance to the nearest of 4 levels
        d = (sym_mat[:, :, None] - self.levels * unit).abs()
        resid = d.amin(dim=2)                               # [max_sym, S]
        score = (resid * vmask).sum(dim=0) / torch.clamp(n_valid_sym, min=1)
        best = torch.argmin(score).to(torch.int32)
        keep = take(score, state["phase"]) <= take(score, best) \
            * (1.0 + self.hyst)
        phase = torch.where(keep, state["phase"], best)

        soft = sym_mat.index_select(1, phase.reshape(1).long())[:, 0] / unit
        soft = torch.where(sym_valid, soft, soft.new_zeros(()))
        # P25 mapping +3,+1,-1,-3 -> 01,00,10,11
        dibits = torch.where(soft > 1.0, 1, torch.where(
            soft > 0.0, 0, torch.where(soft > -1.0, 2, 3)))
        dibits = torch.where(sym_valid, dibits, 0).to(torch.uint8)

        new_state = dict(
            tail=frame[-HIST:], mu_int=mu_int, mu_frac=mu_frac,
            buf=new_buf, buf_count=rem.to(torch.int32), phase=phase,
            scale=scale)
        rate_scale = self.symbol_rate / self.channel_rate
        count = n_sym.to(torch.int32)
        return new_state, (x.like(dibits, count=count, rate_scale=rate_scale),
                           x.like(soft, count=count, rate_scale=rate_scale))
