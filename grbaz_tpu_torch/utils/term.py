"""Terminal utilities.

Equivalents of the reference's small host helpers:

* :data:`colours` / :func:`colourise` — python/colours.py (ANSI terminal
  colors for app output);
* :class:`StdFlusher` — python/std_flusher.py (daemon thread that
  periodically flushes stdout/stderr so piped app output stays live).

The port's copy of ``grbaz_tpu/utils/term.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import sys
import threading

_CODES = {
    "reset": 0, "bold": 1, "dim": 2, "underline": 4, "blink": 5,
    "reverse": 7,
    "black": 30, "red": 31, "green": 32, "yellow": 33, "blue": 34,
    "magenta": 35, "cyan": 36, "white": 37,
    "bg_black": 40, "bg_red": 41, "bg_green": 42, "bg_yellow": 43,
    "bg_blue": 44, "bg_magenta": 45, "bg_cyan": 46, "bg_white": 47,
}

colours = {name: f"\x1b[{code}m" for name, code in _CODES.items()}


def colourise(text: str, *styles: str, enable: bool = True) -> str:
    """Wrap text in ANSI codes; pass ``enable=False`` (e.g. when stdout
    is not a tty) for a no-op."""
    if not enable or not styles:
        return text
    prefix = "".join(colours[s] for s in styles)
    return f"{prefix}{text}{colours['reset']}"


class StdFlusher:
    """Flush stdout/stderr every ``interval`` seconds on a daemon thread."""

    def __init__(self, interval: float = 1.0, auto_start: bool = True):
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thr = None
        if auto_start:
            self.start()

    def start(self):
        if self._thr is None:
            self._thr = threading.Thread(target=self._loop, daemon=True)
            self._thr.start()

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                sys.stdout.flush()
                sys.stderr.flush()
            except (OSError, ValueError):
                pass

    def stop(self):
        self._stop.set()
        if self._thr is not None:
            self._thr.join(timeout=self.interval + 1)
            self._thr = None
