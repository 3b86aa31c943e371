"""Ephemeris-driven doppler tuning (python/horizons_block.py:25-66).

The reference wraps an external ``horizons.py`` thread (JPL Horizons
queries) that periodically retunes a device for doppler. Network access
is environment-dependent, so the ephemeris is a pluggable callable
``ephemeris(unix_time) -> range_rate_m_per_s`` (positive = receding);
anything from a Horizons table interpolator to a TLE propagator plugs
in. The tracker owns the thread and the ``set_freq``/``get``/``start``/
``stop`` surface of the reference block.

The port's copy of ``grbaz_tpu/compat/horizons.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

C_M_S = 299792458.0


class DopplerTracker:
    def __init__(self, ephemeris: Callable[[float], float], device,
                 base_freq: float, interval: float = 1.0,
                 auto_start: bool = False, now: Callable[[], float] = time.time):
        """``device`` needs a ``freq(hz) -> bool`` setter (the Device
        interface); ``base_freq`` is the emitted (rest) frequency."""
        self.ephemeris = ephemeris
        self.device = device
        self.base_freq = float(base_freq)
        self.interval = float(interval)
        self._now = now
        self._run = False
        self._thr: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.last = dict(time=None, range_rate=None, doppler=0.0,
                         tuned_freq=None)
        if auto_start:
            self.start()

    # -- the reference block's surface ----------------------------------------
    def set_freq(self, base_freq: float):
        with self._lock:
            self.base_freq = float(base_freq)
        self.step()  # apply immediately

    def get(self) -> dict:
        with self._lock:
            return dict(self.last)

    def step(self) -> float:
        """One tracking update; returns the tuned frequency."""
        t = self._now()
        rr = float(self.ephemeris(t))
        with self._lock:
            f0 = self.base_freq
        doppler = -rr / C_M_S * f0     # receding -> shifted down
        tuned = f0 + doppler
        self.device.freq(tuned)
        with self._lock:
            self.last = dict(time=t, range_rate=rr, doppler=doppler,
                             tuned_freq=tuned)
        return tuned

    def start(self):
        if self._run:
            return
        self._run = True
        self._thr = threading.Thread(target=self._loop, daemon=True)
        self._thr.start()

    def stop(self):
        self._run = False
        if self._thr is not None:
            self._thr.join(timeout=2 * self.interval + 1)
            self._thr = None

    def _loop(self):
        while self._run:
            try:
                self.step()
            except Exception:
                pass
            time.sleep(self.interval)
