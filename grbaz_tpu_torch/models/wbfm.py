"""WBFM broadcast receiver — the flagship chain (port of
``grbaz_tpu/models/wbfm.py``, the RTL-FM equivalent):

    IQ (3.2 MHz) -> freq-xlating FIR (channel select, /8)
      -> [power squelch] -> FM quadrature demod
      -> audio-rate conversion -> deemphasis -> audio

The audio-rate conversion is either one MMSE fractional resampler at
the quad rate (``audio_chain='fractional'``) or an anti-alias FIR
decimation by floor(quad/audio) followed by the fractional resampler for
the small residual ratio (``'cascade'``, 25/24 for the flagship numbers).

``fused=True`` builds the first three stages as one block,
:class:`WBFMFrontend`, on the rotated-taps kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar, take
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.demod import (FMDeemphasis, PowerSquelch,
                                       QuadratureDemod)
from grbaz_tpu_torch.ops.fir import (BACKENDS, FIRDecimator,
                                     FreqXlatingFIRDecimator, _carry_tail,
                                     fir_decimate_frame_ctaps, low_pass_taps,
                                     prepare_taps)
from grbaz_tpu_torch.ops.iir import onepole_scan, state_at_count
from grbaz_tpu_torch.ops.resampler import FractionalResampler
from grbaz_tpu_torch.ops.wbfm_frontend import demod_unrotated, rotated_taps


class WBFMFrontend(Block):
    """Fused channelizer + optional power squelch + FM discriminator.

    The rotated-taps channelizer (LO folded into complex taps) gives an
    UNROTATED output ``yf``; its output-side rotation advances by a
    constant per sample and cancels into the discriminator's phase step
    (:func:`.demod_unrotated`), so no full-rate transcendental runs.
    The squelch gates on the power of ``yf``, which equals that of the
    rotated signal.

    ``backend``: 'auto' and 'kernel' go through the CUDA kernel's
    wrapper (``xlating_fir_ctaps_block``: the kernel on the card, for any
    block length, reading the block and the carried tail in place; its
    plain twin on the CPU); 'plain' always runs the plain product. The
    carried tail holds RAW samples in every arm, so states agree across
    arms.
    """

    def __init__(self, taps, decim: int, center_freq: float,
                 sample_rate: float, gain: float, *,
                 squelch_db: Optional[float] = None,
                 squelch_alpha: float = 1e-4, backend: str = "auto",
                 name=None, device="cuda"):
        super().__init__(name)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.device = resolve_device(device)
        self.decim = int(decim)
        self.backend = backend
        self.h_rev_pad = torch.from_numpy(
            prepare_taps(taps, self.decim)).to(self.device)
        self.tail_len = self.h_rev_pad.shape[0]
        self.sample_rate = float(sample_rate)
        self.center_freq0 = float(center_freq)
        self.gain0 = float(gain)
        self.squelch_db = squelch_db
        self.squelch_alpha = float(squelch_alpha)

    def init_state(self):
        st = dict(tail=torch.zeros(self.tail_len, dtype=torch.complex64,
                                   device=self.device),
                  phase=scalar(0, torch.int64, self.device),
                  prev_yf=scalar(1.0 + 0.0j, torch.complex64, self.device))
        if self.squelch_db is not None:
            st["sq_avg"] = scalar(0.0, torch.float32, self.device)
        return st

    def init_params(self):
        lo = exact.freq_to_turns_u32(-self.center_freq0, self.sample_rate)
        pr = dict(lo_inc=scalar(int(lo), torch.int64, self.device),
                  gain=scalar(self.gain0, torch.float32, self.device))
        if self.squelch_db is not None:
            pr["sq_threshold"] = scalar(
                float(np.float32(10.0 ** (float(self.squelch_db) / 10.0))),
                torch.float32, self.device)
            pr["sq_alpha"] = scalar(self.squelch_alpha, torch.float32,
                                    self.device)
        return pr

    @staticmethod
    def freq_params(center_freq: float, sample_rate: float):
        """Host helper: params (numpy uint32) for a new center frequency."""
        return dict(lo_inc=exact.freq_to_turns_u32(-center_freq, sample_rate))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        lo_inc = params["lo_inc"]
        if self.backend == "plain":
            yf = fir_decimate_frame_ctaps(
                torch.cat([state["tail"][1:], x.data]),
                rotated_taps(self.h_rev_pad, lo_inc), self.decim)
        else:
            from grbaz_tpu_torch.ops.cuda.xlating_fir_ctaps import \
                xlating_fir_ctaps_block
            yf = xlating_fir_ctaps_block(x.data, state["tail"],
                                         self.h_rev_pad, self.decim, lo_inc)
        count_q = x.count // self.decim
        new_state = dict(state)
        if self.squelch_db is not None:
            p = yf.real * yf.real + yf.imag * yf.imag
            alpha = params["sq_alpha"]
            # causal recurrence: the valid prefix is exact; the invalid
            # tail takes the last valid average, which is carried
            avg_raw = onepole_scan(p * alpha, 1.0 - alpha, state["sq_avg"])
            avg_last = state_at_count(avg_raw, count_q, state["sq_avg"])
            valid = torch.arange(yf.shape[0], dtype=torch.int32,
                                 device=yf.device) < count_q
            avg = torch.where(valid, avg_raw, avg_last)
            yf = torch.where(avg >= params["sq_threshold"], yf,
                             torch.zeros_like(yf))
            new_state["sq_avg"] = avg_last
        d, _ = demod_unrotated(yf, state["prev_yf"], params["gain"], lo_inc,
                               self.decim)
        idx = torch.clamp(count_q - 1, 0, yf.shape[0] - 1)
        new_state.update(
            tail=_carry_tail(state["tail"], x.data, self.tail_len),
            phase=(state["phase"] + n * lo_inc) & U32_MASK,
            prev_yf=torch.where(count_q > 0, take(yf, idx),
                                state["prev_yf"]))
        out = x.like(d, count=count_q, rate_scale=1.0 / self.decim)
        return new_state, (out,)


@dataclasses.dataclass
class WBFMConfig:
    sample_rate: float = 3.2e6      # RTL2832 full rate
    center_freq: float = 0.0        # station offset within the band
    decim: int = 8                  # -> quad rate
    audio_rate: float = 48e3
    max_deviation: float = 75e3     # broadcast FM
    channel_width: float = 150e3
    transition: float = 75e3
    squelch_db: Optional[float] = None  # None = no squelch block
    deemph_tau: float = 75e-6
    block_size: int = 1 << 17
    # rotated-taps channelizer (LO folded into complex taps)
    rotate_taps: bool = False
    # fused channelizer + squelch + discriminator block (WBFMFrontend)
    fused: bool = False
    # WBFMFrontend backend: 'auto' = the rotated-taps CUDA kernel on the
    # card, its plain PyTorch version on the CPU; 'plain' or 'kernel'.
    # The fused chain's resampler and deemphasis follow it
    fused_backend: str = "auto"
    # 'fractional' = one MMSE resampler at the quad rate; 'cascade' =
    # anti-alias FIR decimation, then the resampler for the residual
    audio_chain: str = "fractional"
    # cascade integer pre-decimation factor; None = floor(quad/audio)
    audio_aa_decim: Optional[int] = None
    # channelizer, anti-alias FIR, resampler and deemphasis backend:
    # 'auto' = the CUDA kernels on the card, the plain PyTorch versions
    # on the CPU; 'plain' or 'kernel' to force one
    chan_backend: str = "auto"


def _tail_backend(backend: str) -> str:
    # the audio tail's blocks refuse 'kernel' without a card; the chain's
    # 'kernel' runs the other blocks' wrappers, which take their plain
    # twins on the CPU, so the tail takes 'auto' there
    return "plain" if backend == "plain" else "auto"


def build_wbfm(cfg: WBFMConfig, device="cuda"):
    """Build the mono WBFM receive flowgraph on ``device``.

    Every block with state has a fixed name (the JAX package auto-names
    the demod and deemphasis blocks), so a checkpoint of one build loads
    into another.

    Returns ``(flowgraph, handles)`` where handles holds the retunable
    blocks: ``channel`` (freq), ``squelch``, ``resampler``, ``audio_aa``;
    the fused chain has ``channel``, ``frontend`` (the same block) and
    ``resampler``, and ignores ``audio_chain`` as the JAX package does.
    """
    fs, decim = cfg.sample_rate, cfg.decim
    quad = fs / decim
    if cfg.block_size % decim:
        raise ValueError("block_size must be a multiple of decim")
    fg = Flowgraph("wbfm")
    if cfg.fused:
        tail = _tail_backend(cfg.fused_backend)
        front = WBFMFrontend(
            low_pass_taps(1.0, fs, cfg.channel_width / 2 + cfg.transition / 2,
                          cfg.transition),
            decim, cfg.center_freq, fs,
            quad / (2 * np.pi * cfg.max_deviation),
            squelch_db=cfg.squelch_db, backend=cfg.fused_backend,
            name="frontend", device=device)
        resamp = FractionalResampler(cfg.block_size // decim,
                                     quad / cfg.audio_rate,
                                     dtype=torch.float32, name="resampler",
                                     backend=tail, device=device)
        deemph = FMDeemphasis(cfg.audio_rate, cfg.deemph_tau, name="deemph",
                              device=device, backend=tail)
        fg.input("iq", front)
        fg.chain(front, resamp, deemph)
        fg.output("audio", deemph)
        fg.output("quad", front)  # demodulated quad-rate tap (scanner use)
        return fg, dict(channel=front, resampler=resamp, frontend=front)
    chan = FreqXlatingFIRDecimator(
        low_pass_taps(1.0, fs, cfg.channel_width / 2 + cfg.transition / 2,
                      cfg.transition),
        decim, cfg.center_freq, fs, name="channel",
        rotate_taps=cfg.rotate_taps, backend=cfg.chan_backend, device=device)
    demod = QuadratureDemod(quad / (2 * np.pi * cfg.max_deviation),
                            name="demod", device=device)
    tail = _tail_backend(cfg.chan_backend)
    deemph = FMDeemphasis(cfg.audio_rate, cfg.deemph_tau, name="deemph",
                          device=device, backend=tail)
    fg.input("iq", chan)
    handles = dict(channel=chan)

    d2 = cfg.audio_aa_decim or int(quad // cfg.audio_rate)
    use_cascade = (cfg.audio_chain == "cascade" and d2 >= 2
                   and (cfg.block_size // decim) % d2 == 0)
    if cfg.audio_chain == "cascade" and not use_cascade:
        raise ValueError("cascade audio chain needs quad/audio >= 2 and "
                         "a block divisible by the integer factor")
    if use_cascade:
        aa = FIRDecimator(
            low_pass_taps(1.0, quad, 0.45 * cfg.audio_rate,
                          0.2 * cfg.audio_rate, window="blackmanharris"),
            d2, dtype=torch.float32, name="audio_aa",
            backend=cfg.chan_backend, device=device)
        resamp = FractionalResampler(cfg.block_size // decim // d2,
                                     quad / d2 / cfg.audio_rate,
                                     dtype=torch.float32, name="resampler",
                                     backend=tail, device=device)
        audio_stages = [aa, resamp]
        handles["audio_aa"] = aa
    else:
        resamp = FractionalResampler(cfg.block_size // decim,
                                     quad / cfg.audio_rate,
                                     dtype=torch.float32, name="resampler",
                                     backend=tail, device=device)
        audio_stages = [resamp]
    handles["resampler"] = resamp

    if cfg.squelch_db is not None:
        sq = PowerSquelch(cfg.squelch_db, name="squelch", device=device)
        fg.chain(chan, sq, demod, *audio_stages, deemph)
        handles["squelch"] = sq
    else:
        fg.chain(chan, demod, *audio_stages, deemph)
    fg.output("audio", deemph)
    fg.output("quad", demod)  # demodulated quad-rate tap (scanner use)
    return fg, handles
