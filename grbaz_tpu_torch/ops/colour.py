"""Colouriser: float vectors -> RGB pixel bytes through a gradient LUT
(port of ``grbaz_tpu/ops/colour.py``).

The gradient is generated (a thermal ramp: black -> blue -> cyan ->
green -> yellow -> red -> white), and the mapping is a uint8 LUT gather.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream


def thermal_gradient(n: int = 256) -> np.ndarray:
    """[n, 3] uint8 thermal gradient."""
    stops = np.array([
        [0, 0, 0], [0, 0, 160], [0, 160, 255], [0, 255, 64],
        [255, 255, 0], [255, 64, 0], [255, 255, 255]], np.float64)
    pos = np.linspace(0.0, 1.0, len(stops))
    t = np.linspace(0.0, 1.0, n)
    rgb = np.stack([np.interp(t, pos, stops[:, c]) for c in range(3)], axis=1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


class Colouriser(Block):
    """Map float samples in [vmin, vmax] to RGB bytes (3x rate).

    The output is interleaved R,G,B uint8, the raster feed for waterfall
    sinks. ``vmin``/``vmax`` are runtime params (display range). A 1-D
    input yields ``count*3`` bytes; a 2-D input keeps ``count`` rows of
    3x the width.
    """

    def __init__(self, vmin: float = -100.0, vmax: float = 0.0,
                 lut: np.ndarray | None = None, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        lut = np.asarray(lut if lut is not None else thermal_gradient(),
                         np.uint8)
        self.lut = torch.from_numpy(lut).to(self.device)
        self.vmin0, self.vmax0 = float(vmin), float(vmax)

    def init_params(self):
        return dict(vmin=scalar(self.vmin0, torch.float32, self.device),
                    vmax=scalar(self.vmax0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        lo, hi = params["vmin"], params["vmax"]
        n_lut = self.lut.shape[0]
        t = (x.data.to(torch.float32) - lo) / torch.clamp(hi - lo, min=1e-9)
        # truncation toward zero, then the clip (JAX's astype(int32));
        # values are first held inside (-1, n_lut], where the conversion
        # is exact, so values past int32 clip as XLA's saturating one does
        v = torch.clamp(t * (n_lut - 1), -1.0, float(n_lut))
        idx = torch.clamp(v.to(torch.int32), 0, n_lut - 1)
        rgb = self.lut[idx.long()]                    # [..., 3]
        if x.data.dim() > 1:
            flat = rgb.reshape(x.data.shape[:-1] + (-1,))
            count = x.count
        else:
            flat = rgb.reshape(-1)
            count = x.count * 3
        return state, (x.like(flat, count=count, rate_scale=3.0),)
