"""Timer-driven view flipper (wx_flipper analog).

Parity with python/wx_flipper.py:5-50: a small scheduler that invokes a
target callable on a fixed interval (the reference flips wx notebook
pages to keep hidden GUI sinks rendering). Headless here: drives any
callable — typically cycling which spectral/waterfall export view the
viz layer renders — from a daemon thread instead of a wx.Timer, with
the same start/stop/interval API. With ``interval=None`` the reference
binds to idle events; the analog is ``tick()`` which the host loop may
call whenever it is idle.

The port's copy of ``grbaz_tpu/viz/flipper.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class ViewFlipper:
    def __init__(self, target: Callable[[], None],
                 interval: Optional[float] = None, start_now: bool = True):
        assert target is not None
        self.target = target
        self.interval = interval
        self.flips = 0
        self._timer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if interval is not None and interval > 0 and start_now:
            self.start_timer()

    @property
    def timer_running(self) -> bool:
        return self._timer is not None and self._timer.is_alive()

    def start_timer(self, interval: Optional[float] = None):
        if self.timer_running:
            self.stop_timer()
        if interval is not None:
            self.interval = interval
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval):
                self.tick()

        self._timer = threading.Thread(target=_loop, daemon=True,
                                       name="view-flipper")
        self._timer.start()

    def stop_timer(self):
        self._stop.set()
        if self._timer is not None:
            self._timer.join(timeout=2.0)
            self._timer = None

    def tick(self):
        """One flip — also the idle-event path (reference OnIdle)."""
        self.flips += 1
        self.target()

    def close(self):
        self.stop_timer()
