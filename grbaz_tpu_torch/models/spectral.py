"""Spectral analyzer chains, the realtime_fft and facsink analogs (port of
``grbaz_tpu/models/spectral.py``): BASELINE config 3. The display is
replaced by data export (spectrum frames out)."""

from __future__ import annotations

import dataclasses

from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.ops.colour import Colouriser
from grbaz_tpu_torch.ops.spectral import (FACSpectrum, Overlap, PowerSpectrum,
                                          Vectorize)


@dataclasses.dataclass
class SpectralConfig:
    fft_size: int = 4096
    overlap: int = 0                 # samples of inter-frame overlap
    window: str = "blackmanharris"
    avg_alpha: float = 0.25
    block_size: int = 1 << 17
    waterfall: bool = False          # add the colouriser's raster output
    vmin: float = -120.0
    vmax: float = 0.0


def build_spectrum(cfg: SpectralConfig, device="cuda"):
    """IQ stream -> averaged dB spectra (+ optional RGB waterfall rows)."""
    fg = Flowgraph("spectrum")
    if cfg.overlap:
        framer = Overlap(cfg.fft_size, cfg.overlap, device=device)
    else:
        framer = Vectorize(cfg.fft_size)
    ps = PowerSpectrum(cfg.fft_size, cfg.window, cfg.avg_alpha, name="psd",
                       device=device)
    fg.input("iq", framer)
    fg.chain(framer, ps)
    fg.output("spectra", ps)
    handles = dict(psd=ps)
    if cfg.waterfall:
        col = Colouriser(cfg.vmin, cfg.vmax, name="colouriser", device=device)
        fg.connect(ps, col)
        fg.output("raster", col)
        handles["colouriser"] = col
    return fg, handles


@dataclasses.dataclass
class FACConfig:
    fac_size: int = 512
    sample_rate: float = 250e3
    fac_rate: float = 3.0            # spectra per second (facsink default)
    avg_alpha: float = 0.25
    block_size: int = 1 << 16


def build_fac(cfg: FACConfig, device="cuda"):
    """IQ stream -> FAC spectra (facsink)."""
    keep = max(1, int(cfg.sample_rate / cfg.fac_size / cfg.fac_rate))
    fg = Flowgraph("fac")
    framer = Vectorize(cfg.fac_size)
    fac = FACSpectrum(cfg.fac_size, keep_one_in_n=keep,
                      avg_alpha=cfg.avg_alpha, name="fac", device=device)
    fg.input("iq", framer)
    fg.chain(framer, fac)
    fg.output("fac", fac)
    return fg, dict(fac=fac)
