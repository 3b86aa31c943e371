"""Closed-loop sample-rate discipline (host controller).

Reimplements python/rate_synchroniser.py (:26-121): consumes
period-measurement messages (here: DPLLBitSync event rows — diff,
period, current_period), smooths the measured ratio with an EWMA,
detects lock via windowed standard deviation, and emits parts-per-
billion ratio corrections for the fractional resampler — the
``(int, frac)`` ppb pair the reference publishes to the resampler's
"msg" port (SURVEY.md §3.4). Here the output is the resampler's exact
fixed-point param dict, applied by the executor between blocks.

The port's copy of ``grbaz_tpu/net/rate_synchroniser.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from grbaz_tpu_torch.ops.resampler import FractionalResampler


class RateSynchroniser:
    """Host-side controller: feed period measurements, read ratio params."""

    def __init__(self, target_period: float, base_ratio: float,
                 alpha: float = 0.1, lock_window: int = 16,
                 lock_sd: float = 1e-4, jump_limit: float = 0.01):
        self.target = float(target_period)
        self.base_ratio = float(base_ratio)
        self.alpha = float(alpha)
        self.window: deque = deque(maxlen=lock_window)
        self.lock_sd = float(lock_sd)
        self.jump_limit = float(jump_limit)
        self.ewma: Optional[float] = None
        self.locked = False
        self.updates = 0

    def feed(self, measured_period: float) -> Optional[dict]:
        """One period measurement -> new resampler params (or None).

        Mirrors the reference handler: ratio = measured/target, EWMA
        smoothing with jump rejection, lock when the window SD drops
        below threshold (then corrections stop).
        """
        if measured_period <= 0:
            return None
        ratio = measured_period / self.target
        if self.ewma is None:
            self.ewma = ratio
        else:
            if abs(ratio - self.ewma) / self.ewma > self.jump_limit:
                return None  # reject glitch measurements
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * ratio
        self.window.append(self.ewma)
        if self.locked:
            return None
        if len(self.window) == self.window.maxlen:
            sd = float(np.std(self.window))
            if sd < self.lock_sd:
                self.locked = True
        self.updates += 1
        return self.params()

    def params(self) -> dict:
        """Current corrected resampler params (ppb-exact fixed point)."""
        corrected = self.base_ratio * (self.ewma if self.ewma else 1.0)
        return FractionalResampler.ratio_params(corrected)

    def ppb(self) -> tuple:
        """The reference's wire form: (int_ppb, frac_ppb) of the ratio."""
        corrected = self.base_ratio * (self.ewma if self.ewma else 1.0)
        total = corrected * 1e9
        return int(total), float(total - int(total))
