"""Hardware-control host services: hopping, sweeping, gain AGC,
aligned start, finite acquisition.

These mirror the reference's host-side hardware controllers, retargeted
at the framework's :class:`~grbaz_tpu_torch.net.devices.Device` interface (and
equally applicable to the channelizer's retunable params when the
"tuner" is digital):

* :class:`FreqHopper` — python/freq_hopper.py:29-102 (host-side hop
  sequencer thread issuing tune commands) and the scheduling core of
  lib/baz_hopper.cc:299-340 (tune ahead of time, drop retune
  transients).
* :class:`SoftwareAGC` — python/usrp_agc.py:26-118: hysteresis AGC on
  front-end gain with saturation backoff and hold time.
* :func:`delayed_start` — python/delayed_start.py:29-60: spin until a
  second boundary (+offset) so multiple receivers start aligned.
* :func:`finite_acquisition` — lib/baz_usrp_acquire.h:40-63: grab an
  exact number of samples outside streaming, with skip/timeout.

The port's copy of ``grbaz_tpu/net/hw_control.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class FreqHopper:
    """Hop a tunable target over a frequency list on a schedule.

    ``tune`` is any callable(freq_hz) — a Device.freq, a channelizer
    param update, or a BorIP client set_freq. ``drop_callback`` (if
    given) is invoked with the number of samples to discard after each
    retune (the reference hopper's ``drop_length`` transient removal).
    """

    def __init__(self, tune: Callable[[float], Any], freqs: Sequence[float],
                 dwell: float, drop_length: int = 0,
                 drop_callback: Optional[Callable[[int], None]] = None):
        self.tune = tune
        self.freqs = list(freqs)
        self.dwell = float(dwell)
        self.drop_length = int(drop_length)
        self.drop_callback = drop_callback
        self.index = -1
        self.hops = 0
        self._run = False
        self._thr: Optional[threading.Thread] = None

    def hop(self):
        """One manual hop (also used by the thread)."""
        self.index = (self.index + 1) % len(self.freqs)
        self.tune(self.freqs[self.index])
        if self.drop_callback and self.drop_length:
            self.drop_callback(self.drop_length)
        self.hops += 1

    def start(self):
        self._run = True
        self._thr = threading.Thread(target=self._loop, daemon=True)
        self._thr.start()

    def _loop(self):
        next_t = time.monotonic()
        while self._run:
            self.hop()
            next_t += self.dwell
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    def stop(self):
        self._run = False
        if self._thr:
            self._thr.join(timeout=2 * self.dwell + 1)


class SoftwareAGC:
    """Front-end gain controller with hysteresis + saturation backoff
    (usrp_agc.py behavior). Feed envelope measurements; it calls
    ``set_gain`` when adjustment is needed."""

    def __init__(self, set_gain: Callable[[float], Any], gain: float,
                 target: float = 0.5, hysteresis: float = 0.1,
                 step: float = 1.0, gain_min: float = 0.0,
                 gain_max: float = 30.0, saturation: float = 0.95,
                 sat_backoff: float = 3.0, hold_time: float = 0.5):
        self.set_gain = set_gain
        self.gain = float(gain)
        self.target = target
        self.hyst = hysteresis
        self.step = step
        self.gmin, self.gmax = gain_min, gain_max
        self.saturation = saturation
        self.sat_backoff = sat_backoff
        self.hold = hold_time
        self._last_change = 0.0
        self.adjustments = 0

    def feed(self, envelope: float) -> Optional[float]:
        now = time.monotonic()
        if envelope >= self.saturation:
            # saturation: back off immediately (no hold)
            g = max(self.gmin, self.gain - self.sat_backoff)
        elif now - self._last_change < self.hold:
            return None
        elif envelope > self.target * (1 + self.hyst):
            g = max(self.gmin, self.gain - self.step)
        elif envelope < self.target * (1 - self.hyst):
            g = min(self.gmax, self.gain + self.step)
        else:
            return None
        if g == self.gain:
            return None
        self.gain = g
        self._last_change = now
        self.set_gain(g)
        self.adjustments += 1
        return g


def delayed_start(offset: float = 0.0, clock=time.time,
                  sleeper=time.sleep) -> float:
    """Block until the next wall-clock second boundary + offset
    (delayed_start.py): returns the start timestamp. Injectable clock
    for tests."""
    now = clock()
    target = float(int(now) + 1) + float(offset)
    while True:
        now = clock()
        remaining = target - now
        if remaining <= 0:
            return target
        sleeper(min(remaining, 0.01))


def finite_acquisition(device, nsamps: int, skip: int = 0,
                       timeout: float = 10.0) -> np.ndarray:
    """Synchronous bounded acquisition (usrp_acquire
    finite_acquisition_v equivalent): start the device if needed, skip
    ``skip`` samples, collect exactly ``nsamps``, restore run state."""
    was_running = device.is_running()
    if not was_running:
        if not device.start():
            raise RuntimeError("device failed to start")
    try:
        deadline = time.monotonic() + timeout
        to_skip = skip
        out = np.zeros(nsamps, np.complex64)
        got = 0
        while got < nsamps:
            if time.monotonic() > deadline:
                raise TimeoutError(f"acquired {got}/{nsamps}")
            chunk = device.read_samples(min(4096, nsamps - got + to_skip))
            if to_skip:
                drop = min(to_skip, len(chunk))
                chunk = chunk[drop:]
                to_skip -= drop
            take = min(len(chunk), nsamps - got)
            out[got:got + take] = chunk[:take]
            got += take
        return out
    finally:
        if not was_running:
            device.stop()


def pps_diff(time_a, time_b=None, n: int = 10, interval: float = 1.0,
             sleep=time.sleep):
    """Measure PPS-latched time difference between two time sources
    (apps/pps_diff.py equivalent: compares two devices' last-PPS times
    to check GPSDO discipline).

    ``time_a``/``time_b`` are callables returning the device's
    seconds-at-last-PPS; ``time_b`` defaults to the host wall clock.
    Returns per-sample diffs plus mean/std/drift (slope per interval).
    """
    time_b = time_b or time.time
    diffs = []
    for i in range(n):
        diffs.append(float(time_a()) - float(time_b()))
        if i + 1 < n:
            sleep(interval)
    d = np.asarray(diffs)
    drift = float(np.polyfit(np.arange(n), d, 1)[0]) if n > 1 else 0.0
    return dict(diffs=d, mean=float(d.mean()), std=float(d.std()),
                drift_per_interval=drift)


class GPSDOMonitor:
    """GPSDO / sensor monitor (apps/gpsdo.py equivalent).

    The reference polls UHD motherboard sensors (gps_locked, gps_time,
    ref_locked, NMEA strings) on an interval and logs them (optionally
    to a time-series DB). Here the sensor source is any object with a
    ``sensors() -> dict`` method (or a callable returning one); the
    monitor keeps history, tracks lock transitions, and measures
    gps_time-vs-host drift.
    """

    def __init__(self, source, interval: float = 1.0, keep: int = 3600,
                 on_sample=None, now=time.time):
        self._get = source.sensors if hasattr(source, "sensors") else source
        self.interval = float(interval)
        self.keep = int(keep)
        self.on_sample = on_sample
        self._now = now
        self.history: list = []
        self.lock_transitions: list = []
        self._run = False
        self._thr = None

    def sample(self) -> dict:
        vals = dict(self._get())
        t = self._now()
        vals["_host_time"] = t
        if "gps_time" in vals:
            vals["_gps_host_diff"] = float(vals["gps_time"]) - t
        prev = self.history[-1] if self.history else {}
        for key in ("gps_locked", "ref_locked"):
            if key in vals and vals.get(key) != prev.get(key):
                self.lock_transitions.append((t, key, vals[key]))
        self.history.append(vals)
        if len(self.history) > self.keep:
            self.history.pop(0)
        if self.on_sample:
            self.on_sample(vals)
        return vals

    def drift(self) -> float:
        """gps-vs-host drift (seconds per sample interval) over history."""
        d = [h["_gps_host_diff"] for h in self.history
             if "_gps_host_diff" in h]
        if len(d) < 2:
            return 0.0
        return float(np.polyfit(np.arange(len(d)), np.asarray(d), 1)[0])

    def start(self):
        if self._run:
            return
        self._run = True

        def loop():
            while self._run:
                try:
                    self.sample()
                except Exception:
                    pass
                time.sleep(self.interval)

        self._thr = threading.Thread(target=loop, daemon=True)
        self._thr.start()

    def stop(self):
        self._run = False
        if self._thr is not None:
            self._thr.join(timeout=self.interval + 1)
            self._thr = None
