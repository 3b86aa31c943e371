"""Plain reference of the RTL-FM receiver (``configs/rtl_fm.json``).

From the raw input blocks alone it computes what the receiver owes for
block j of a stream: the channel (the LO at the stream's absolute
sample, a lowpass, decimation), the discriminator's ``quad``, the
anti-alias FIR, the resampler at its exact 32.32 positions and the
deemphasised ``audio``. Every state of the chain is finite but the
deemphasis, whose pole (0.75 at 48 kHz) forgets in a few hundred
outputs, so starting from rest one block early gives block j exactly;
block 0 starts from rest, as the stream does.
"""

from __future__ import annotations

import numpy as np
import torch

from radiobench.reference import dsp


def _design(cfg: dict):
    fs, decim = cfg["sample_rate"], cfg["decim"]
    quad_rate = fs / decim
    d2 = int(quad_rate // cfg["audio_rate"])
    return dict(
        h=dsp.low_pass_taps(fs, cfg["channel_width"] / 2
                            + cfg["transition"] / 2, cfg["transition"]),
        h_aa=dsp.low_pass_taps(quad_rate, 0.45 * cfg["audio_rate"],
                               0.2 * cfg["audio_rate"], "blackmanharris"),
        d2=d2, inc_lo=dsp.freq_to_inc(-cfg["station_hz"], fs),
        gain=quad_rate / (2 * np.pi * cfg["max_deviation"]),
        inc_rs=dsp.ratio_to_fixed(quad_rate / d2 / cfg["audio_rate"]),
        table=dsp.mmse_table())


def audio_end(b: int, n_aa: int, inc: int, ntaps: int = 8) -> int:
    """Outputs the resampler has given after block b: output k is due
    once samples floor(k inc) .. + ntaps - 1 have all arrived."""
    last = (b + 1) * n_aa - ntaps
    return -(-(last + 1) * dsp.TWO32 // inc)


def outputs(cfg: dict, ring: np.ndarray, j: int, mode: str,
            device) -> dict:
    """Block j of a stream whose block i is ``ring[i % len(ring)]``:
    {port: valid outputs}."""
    d = _design(cfg)
    n_ring, block = ring.shape
    decim, d2 = cfg["decim"], d["d2"]
    first = max(j - 1, 0)
    seg = np.concatenate([ring[i % n_ring] for i in range(first, j + 1)])
    x = torch.from_numpy(seg).to(device, dsp.complex_dtype(mode))
    with dsp.exact_matmul():
        y = dsp.fir_decimate(x * dsp.lo(first * block, len(seg), d["inc_lo"],
                                        mode, device), d["h"], decim, mode)
        quad = dsp.discriminator(y, 1.0 + 0.0j, d["gain"])
        a = dsp.fir_decimate(quad, d["h_aa"], d2, mode)
        n_aa = block // decim // d2
        k0 = audio_end(first - 1, n_aa, d["inc_rs"]) if first else 0
        k1 = audio_end(j, n_aa, d["inc_rs"])
        audio = dsp.resample(a, first * n_aa, k0, k1, d["inc_rs"], d["table"],
                             mode)
    audio = dsp.deemphasis(audio.cpu().numpy(), cfg["audio_rate"],
                           cfg["deemph_tau"], mode)
    k_j = audio_end(j - 1, n_aa, d["inc_rs"]) if j else 0
    n_q = block // decim
    return dict(quad=quad[(j - first) * n_q:].cpu().numpy(),
                audio=audio[k_j - k0:])


def gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The widest difference as a share of the reference's largest
    magnitude (inf where the lengths differ)."""
    if got.shape != ref.shape:
        return float("inf")
    scale = float(np.abs(ref).max()) if ref.size else 1.0
    return float(np.abs(got.astype(np.float64) - ref).max()
                 / scale) if ref.size else 0.0


def numbers(got: dict, ref: dict) -> dict:
    """The numbers compared for one block: ``got`` is {port: (data,
    count)} as the sinks received it."""
    counts_ok = all(got[p][1] == len(ref[p]) for p in ref)
    return dict(
        quad_gap=gap(got["quad"][0][:got["quad"][1]], ref["quad"]),
        audio_gap=gap(got["audio"][0][:got["audio"][1]], ref["audio"]),
        count_miss=0 if counts_ok else 1)


# Each number compared and its limit (PERF.md gives the readings they
# were set from): the widest gaps as shares of the reference's largest
# output, and counts that must be 0.
LIMITS = dict(quad_gap=2e-5, audio_gap=2e-5, count_miss=0, undelivered=0)
