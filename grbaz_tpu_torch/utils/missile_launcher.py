"""USB toy-turret pointer (missile_launcher) — optional host plugin.

Parity with python/missile_launcher.py:37-201: a Dream Cheeky USB
turret (VID 0x2123 / PID 0x1010) pointed at DoA results. SURVEY.md §7
classifies this as novelty, "optional host plugin at most" — kept here
as exactly that: the control protocol (HID SET_REPORT command bytes),
the azimuth/elevation timing model, and DoA-angle pointing, over an
*injectable transport* so it is testable and degrades gracefully when
pyusb / the device is absent (neither exists in this environment).

The port's copy of ``grbaz_tpu/utils/missile_launcher.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

VENDOR_ID = 0x2123
PRODUCT_ID = 0x1010

# HID command bytes (reference turret* methods :179-201); each goes out
# as ctrl_transfer(0x21, 0x09, 0, 0, [0x02, CMD, 0, 0, 0, 0, 0, 0])
CMD_DOWN = 0x01
CMD_UP = 0x02
CMD_LEFT = 0x04
CMD_RIGHT = 0x08
CMD_FIRE = 0x10
CMD_STOP = 0x20

# motion model constants (reference :38-60): full sweep timings used to
# convert angles to motor run durations
AZIMUTH_TRAVEL_TIME = 5.5   # seconds end-to-end
AZIMUTH_RANGE_DEG = 270.0
ELEVATION_TRAVEL_TIME = 0.9
ELEVATION_RANGE_DEG = 30.0


class MissileLauncher:
    """Turret controller over an injectable ``send(cmd_byte)`` transport.

    ``transport(cmd, duration)`` issues one HID command then (for move
    commands) sleeps ``duration`` and stops. Default transport is a
    recording no-op; a pyusb transport can be plugged in where hardware
    exists.
    """

    def __init__(self, transport: Optional[Callable] = None,
                 azimuth: float = 0.0, elevation: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.sent: List[tuple] = []
        self._send = transport if transport is not None else self._record
        self._sleep = sleep
        self.azimuth = float(azimuth)
        self.elevation = float(elevation)
        self.fired = 0

    def _record(self, cmd: int, duration: float = 0.0):
        self.sent.append((cmd, duration))

    def _move(self, cmd: int, duration: float):
        self._send(cmd, duration)
        self._send(CMD_STOP, 0.0)

    # -- pointing ----------------------------------------------------------
    def set_azimuth(self, azimuth: float):
        azimuth = max(-AZIMUTH_RANGE_DEG / 2,
                      min(AZIMUTH_RANGE_DEG / 2, float(azimuth)))
        delta = azimuth - self.azimuth
        if delta == 0.0:
            return
        dur = abs(delta) / AZIMUTH_RANGE_DEG * AZIMUTH_TRAVEL_TIME
        self._move(CMD_RIGHT if delta > 0 else CMD_LEFT, dur)
        self.azimuth = azimuth

    def set_elevation(self, elevation: float):
        elevation = max(0.0, min(ELEVATION_RANGE_DEG, float(elevation)))
        delta = elevation - self.elevation
        if delta == 0.0:
            return
        dur = abs(delta) / ELEVATION_RANGE_DEG * ELEVATION_TRAVEL_TIME
        self._move(CMD_UP if delta > 0 else CMD_DOWN, dur)
        self.elevation = elevation

    def point_at_doa(self, doa_deg: float):
        """Point the turret at a MUSIC DoA estimate (0..180° broadside
        convention, ops/doa.py) mapped onto the ±135° turret range."""
        self.set_azimuth(float(doa_deg) - 90.0)

    # -- firing ------------------------------------------------------------
    def launch(self, confirm: bool = True):
        if not confirm:
            return False
        self._send(CMD_FIRE, 0.0)
        self.fired += 1
        return True

    def reset(self):
        """Drive to the left/down hard stops to recalibrate (ref :62-72)."""
        self._move(CMD_LEFT, AZIMUTH_TRAVEL_TIME)
        self._move(CMD_DOWN, ELEVATION_TRAVEL_TIME)
        self.azimuth = -AZIMUTH_RANGE_DEG / 2
        self.elevation = 0.0


def open_usb_launcher():
    """Return a MissileLauncher over real pyusb hardware, or None if
    pyusb / the device is unavailable (graceful degradation)."""
    try:
        import usb.core  # type: ignore
    except ImportError:
        return None
    dev = usb.core.find(idVendor=VENDOR_ID, idProduct=PRODUCT_ID)
    if dev is None:
        return None

    def transport(cmd: int, duration: float = 0.0):
        dev.ctrl_transfer(0x21, 0x09, 0, 0,
                          [0x02, cmd, 0, 0, 0, 0, 0, 0])
        if duration > 0:
            time.sleep(duration)

    return MissileLauncher(transport=transport)
