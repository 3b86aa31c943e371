"""The multi-channel decoder on the port: one ``DynamicChannelBank``
(all slots channelized by the bank kernel, each FM-demodulated) in a
one-block ``Flowgraph`` under a ``StreamExecutor``, one per wideband
stream, every slot of ``scanner.json``'s plan active. The block size
comes from the cell's traffic."""

from __future__ import annotations

import numpy as np

from radiobench import signals

PORTS = ("quad", "active")


def executor(cfg: dict, block: int, device):
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.core.graph import Flowgraph
    from grbaz_tpu_torch.parallel.channel_bank import DynamicChannelBank

    bank = DynamicChannelBank(
        cfg["capacity"], cfg["sample_rate"], cfg["decim"],
        cfg["channel_width"], cfg["transition"],
        max_deviation=cfg["max_deviation"], name="bank", device=device)
    fg = Flowgraph("scanner")
    fg.input("iq", bank)
    fg.output("quad", (bank, 0))
    fg.output("active", (bank, 1))
    ex = StreamExecutor(fg, {"iq": InputSpec((block,), "complex64",
                                             cfg["sample_rate"])},
                        device=device)
    for f in cfg["slots_hz"]:
        bank.add_channel(ex.params["bank"], float(f))
    return ex


def ring(cfg: dict, streams: int, ring_blocks: int, block: int, seed: int,
         device) -> np.ndarray:
    """Each stream: a station centred in every slot, slot k's tone at
    ``tone_hz + k tone_step_hz``."""
    sig = cfg["signal"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    plans = [[(f, sig["deviation_hz"],
               sig["tone_hz"] + k * sig["tone_step_hz"],
               float(rng.uniform(0, 2 * np.pi)),
               float(rng.uniform(0, 2 * np.pi)))
              for k, f in enumerate(cfg["slots_hz"])]
             for _ in range(streams)]
    return signals.ring(plans, ring_blocks, block, cfg["sample_rate"],
                        sig["noise_rms"], seed, device)
