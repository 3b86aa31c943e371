"""Baseband test signals, made on the device from the seed.

A stream is a sum of FM stations, each a carrier at its offset from the
tuned centre, frequency-modulated by one tone, plus complex Gaussian
noise. The stream is generated in float64 (the phase of a long stream
needs it) in a few large calls, then kept on the host as complex64
blocks, as a capture or a dongle delivers them.
"""

from __future__ import annotations

import numpy as np
import torch


def seed_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(seed) % (1 << 63))


def fm_stream(n: int, fs: float, stations, noise_rms: float,
              gen: torch.Generator, device) -> torch.Tensor:
    """complex128 [n]: sum over ``stations`` of (carrier_hz, deviation_hz,
    tone_hz, carrier_phase, tone_phase), plus noise of ``noise_rms`` a
    component."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    x = torch.zeros(n, dtype=torch.complex128, device=device)
    for fc, dev, tone, ph_c, ph_t in stations:
        ph = (2 * np.pi * torch.frac(t * (fc / fs)) + ph_c
              + (dev / tone) * torch.sin(2 * np.pi * torch.frac(
                  t * (tone / fs)) + ph_t))
        x += torch.polar(torch.ones_like(ph), ph)
    noise = torch.randn(n, 2, generator=gen, device=device,
                        dtype=torch.float32) * noise_rms
    return x + torch.view_as_complex(noise).to(torch.complex128)


def ring(streams, ring_blocks: int, block: int, fs: float, noise_rms: float,
         seed: int, device) -> np.ndarray:
    """complex64 [len(streams), ring_blocks, block] on the host: stream k
    carries the stations ``streams[k]``."""
    gen = seed_generator(seed, device)
    out = np.empty((len(streams), ring_blocks, block), np.complex64)
    for k, stations in enumerate(streams):
        x = fm_stream(ring_blocks * block, fs, stations, noise_rms, gen,
                      device)
        out[k] = x.to(torch.complex64).reshape(ring_blocks,
                                               block).cpu().numpy()
        del x
    return out
