"""Plain reference of the multi-channel decoder (``configs/scanner.json``).

For each slot of the plan: the wideband block rotated by the slot's LO
at the stream's absolute sample, lowpassed and decimated, then
FM-demodulated into ``quad``; ``active`` is one for every slot, since
all are added. The channel filter and the discriminator remember less
than a block, so starting from rest one block early gives block j
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from radiobench.reference import dsp
from radiobench.reference.rtl_fm import gap


def outputs(cfg: dict, ring: np.ndarray, j: int, mode: str,
            device) -> dict:
    fs, decim = cfg["sample_rate"], cfg["decim"]
    h = dsp.low_pass_taps(fs, cfg["channel_width"] / 2 + cfg["transition"] / 2,
                          cfg["transition"])
    gain = (fs / decim) / (2 * np.pi * cfg["max_deviation"])
    n_ring, block = ring.shape
    first = max(j - 1, 0)
    seg = np.concatenate([ring[i % n_ring] for i in range(first, j + 1)])
    x = torch.from_numpy(seg).to(device, dsp.complex_dtype(mode))
    n_q = block // decim
    quad = []
    with dsp.exact_matmul():
        for f in cfg["slots_hz"]:
            lo = dsp.lo(first * block, len(seg), dsp.freq_to_inc(-f, fs),
                        mode, device)
            y = dsp.fir_decimate(x * lo, h, decim, mode)
            quad.append(dsp.discriminator(y, 1.0 + 0.0j, gain)[
                (j - first) * n_q:].cpu().numpy())
    return dict(quad=np.stack(quad),
                active=np.ones(cfg["capacity"], np.uint8))


def numbers(got: dict, ref: dict) -> dict:
    q, n = got["quad"]
    act, n_act = got["active"]
    counts_ok = n == ref["quad"].shape[1] and n_act == len(ref["active"])
    return dict(quad_gap=gap(q[:, :n], ref["quad"]),
                active_miss=int(not np.array_equal(act[:n_act],
                                                   ref["active"])),
                count_miss=0 if counts_ok else 1)


LIMITS = dict(quad_gap=5e-4, active_miss=0, count_miss=0, undelivered=0)
