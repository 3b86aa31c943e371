"""The RTL-FM broadcast receiver on the port: the flagship cascade WBFM
chain (B1 channel select /8, quadrature demod, B3 anti-alias /8, the
25/24 MMSE resampler, deemphasis) in a ``StreamExecutor``, one per
dongle stream. Sizes come from ``rtl_fm.json``; the block size from the
cell's traffic."""

from __future__ import annotations

import numpy as np

from radiobench import signals

# the outputs the sinks receive, in the order the pump hands them on
PORTS = ("quad", "audio")


def executor(cfg: dict, block: int, device):
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.models.wbfm import WBFMConfig, build_wbfm

    fg, _ = build_wbfm(WBFMConfig(
        sample_rate=cfg["sample_rate"], center_freq=cfg["station_hz"],
        decim=cfg["decim"], audio_rate=cfg["audio_rate"],
        max_deviation=cfg["max_deviation"],
        channel_width=cfg["channel_width"], transition=cfg["transition"],
        squelch_db=cfg["squelch_db"], deemph_tau=cfg["deemph_tau"],
        block_size=block, audio_chain=cfg["audio_chain"]), device=device)
    return StreamExecutor(fg, {"iq": InputSpec((block,), "complex64",
                                               cfg["sample_rate"])},
                          device=device)


def ring(cfg: dict, streams: int, ring_blocks: int, block: int, seed: int,
         device) -> np.ndarray:
    """Each stream: the station at ``station_hz`` with its own tone."""
    sig = cfg["signal"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    lo, hi = sig["tone_hz"]
    plans = [[(cfg["station_hz"], sig["deviation_hz"],
               float(rng.uniform(lo, hi)), float(rng.uniform(0, 2 * np.pi)),
               float(rng.uniform(0, 2 * np.pi)))] for _ in range(streams)]
    return signals.ring(plans, ring_blocks, block, cfg["sample_rate"],
                        sig["noise_rms"], seed, device)
