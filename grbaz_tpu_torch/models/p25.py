"""P25 receive chain (port of ``grbaz_tpu/models/p25.py``).

``build_p25_rx`` mirrors ``op25_decoder_simple`` (python/baz_op25.py:76)
as one graph step: channelized IQ -> FM discriminator -> C4FM FSK4
symbol demod -> frame sync / NID events, on this package's own blocks
(:mod:`grbaz_tpu_torch.ops.fsk4`, :mod:`grbaz_tpu_torch.ops.p25`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.ops.demod import QuadratureDemod
from grbaz_tpu_torch.ops.fsk4 import P25_SYMBOL_RATE, FSK4Demod
from grbaz_tpu_torch.ops.p25 import P25FrameSync


@dataclasses.dataclass
class P25Config:
    channel_rate: float = 48e3       # post-channelizer complex rate
    symbol_rate: float = P25_SYMBOL_RATE
    max_deviation: float = 600.0 * 3  # C4FM outer deviation (+/-1800 Hz)
    block_size: int = 1 << 14
    sync_max_errors: int = 1


def build_p25_rx(cfg: P25Config, device="cuda"):
    """IQ (channelized voice channel) -> dibits + soft symbols + frames,
    on ``device``. Returns ``(flowgraph, handles)``."""
    fg = Flowgraph("p25_rx")
    # discriminator gain: outer symbol (+3) at max_deviation -> +3.0
    disc = QuadratureDemod(cfg.channel_rate * 3
                           / (2 * np.pi * cfg.max_deviation), name="disc",
                           device=device)
    fsk4 = FSK4Demod(cfg.channel_rate, cfg.symbol_rate, name="fsk4",
                     device=device)
    sync = P25FrameSync(cfg.sync_max_errors, name="framesync", device=device)
    fg.input("iq", disc)
    fg.chain(disc, fsk4)
    fg.connect((fsk4, 0), sync)
    fg.output("dibits", (fsk4, 0))
    fg.output("soft", (fsk4, 1))
    fg.output("frames", sync)
    return fg, dict(disc=disc, fsk4=fsk4, sync=sync)


def c4fm_modulate(dibits: np.ndarray, channel_rate: float,
                  symbol_rate: float = P25_SYMBOL_RATE,
                  deviation: float = 600.0) -> np.ndarray:
    """Test/TX helper: dibits -> C4FM complex baseband (numpy).

    Levels per TIA-102: dibit 01->+3, 00->+1, 10->-1, 11->-3, scaled to
    ``deviation`` Hz per unit level; rectangular pulse shaping (adequate
    for loopback tests; a deployed TX would raised-cosine filter).
    """
    level_map = np.array([+1.0, +3.0, -1.0, -3.0], np.float64)
    levels = level_map[np.asarray(dibits, np.int64)]
    sps = channel_rate / symbol_rate
    n = int(np.ceil(len(levels) * sps))
    t_idx = np.minimum((np.arange(n) / sps).astype(np.int64),
                       len(levels) - 1)
    inst_freq = levels[t_idx] * deviation
    phase = 2.0 * np.pi * np.cumsum(inst_freq) / channel_rate
    return np.exp(1j * phase).astype(np.complex64)
