"""WBFM broadcast receiver — the flagship chain (port of
``grbaz_tpu/models/wbfm.py``, the RTL-FM equivalent):

    IQ (3.2 MHz) -> freq-xlating FIR (channel select, /8)
      -> [power squelch] -> FM quadrature demod
      -> audio-rate conversion -> deemphasis -> audio

The audio-rate conversion is either one MMSE fractional resampler at
the quad rate (``audio_chain='fractional'``) or an anti-alias FIR
decimation by floor(quad/audio) followed by the fractional resampler for
the small residual ratio (``'cascade'``, 25/24 for the flagship numbers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.ops.demod import (FMDeemphasis, PowerSquelch,
                                       QuadratureDemod)
from grbaz_tpu_torch.ops.fir import (FIRDecimator, FreqXlatingFIRDecimator,
                                     low_pass_taps)
from grbaz_tpu_torch.ops.resampler import FractionalResampler


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
    # fused channelizer + squelch + discriminator block (WBFMFrontend);
    # not ported yet: it needs the rotated-taps kernel
    fused: bool = False
    # 'fractional' = one MMSE resampler at the quad rate; 'cascade' =
    # anti-alias FIR decimation, then the resampler for the residual
    audio_chain: str = "fractional"
    # cascade integer pre-decimation factor; None = floor(quad/audio)
    audio_aa_decim: Optional[int] = None
    # channelizer and anti-alias FIR backend: 'auto' = the CUDA kernels
    # on the card, the plain PyTorch versions on the CPU; 'plain' or
    # 'kernel' to force one
    chan_backend: str = "auto"


def build_wbfm(cfg: WBFMConfig, device="cuda"):
    """Build the mono WBFM receive flowgraph on ``device``.

    Returns ``(flowgraph, handles)`` where handles holds the retunable
    blocks: ``channel`` (freq), ``squelch``, ``resampler``, ``audio_aa``.
    """
    if cfg.fused:
        raise NotImplementedError(
            "WBFMConfig(fused=True) needs the WBFMFrontend block and its "
            "rotated-taps kernel (xlating_fir_frame_pallas), which are the "
            "next slice of the port: ROADMAP.md queue B item 2")
    fs, decim = cfg.sample_rate, cfg.decim
    quad = fs / decim
    if cfg.block_size % decim:
        raise ValueError("block_size must be a multiple of decim")
    fg = Flowgraph("wbfm")
    chan = FreqXlatingFIRDecimator(
        low_pass_taps(1.0, fs, cfg.channel_width / 2 + cfg.transition / 2,
                      cfg.transition),
        decim, cfg.center_freq, fs, name="channel",
        rotate_taps=cfg.rotate_taps, backend=cfg.chan_backend, device=device)
    demod = QuadratureDemod(quad / (2 * np.pi * cfg.max_deviation),
                            device=device)
    deemph = FMDeemphasis(cfg.audio_rate, cfg.deemph_tau, device=device)
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
                                     device=device)
        audio_stages = [aa, resamp]
        handles["audio_aa"] = aa
    else:
        resamp = FractionalResampler(cfg.block_size // decim,
                                     quad / cfg.audio_rate,
                                     dtype=torch.float32, name="resampler",
                                     device=device)
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
