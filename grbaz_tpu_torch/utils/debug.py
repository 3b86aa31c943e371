"""Debug sinks.

:class:`PrintChar` — capability parity with ``baz_print_char``
(the reference's lib/baz_print_char.cc:56-57,86-120): a byte-stream
debug sink with an optional per-sample level input; symbols print as
zero-padded hex while the level is at/above threshold, each burst ends
with a ``[N symbols]`` summary, an optional file tee captures the raw
hex, and a per-burst symbol limit truncates long bursts.

The port's copy of ``grbaz_tpu/utils/debug.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np


class PrintChar:
    def __init__(self, threshold: float = 0.0, limit: int = -1,
                 file: Optional[str] = None, append: bool = False,
                 padding: int = 2, out=None):
        self.threshold = float(threshold)
        self.limit = int(limit)
        self.padding = min(9, max(1, int(padding)))
        self._fmt = "%%0%dX" % self.padding
        self._length = 0
        self._file = open(file, "a" if append else "w") if file else None
        self._out = out or sys.stdout

    def process(self, data: np.ndarray,
                level: Optional[np.ndarray] = None) -> str:
        """Consume one block; returns what was emitted (also printed)."""
        data = np.asarray(data).astype(np.int64) & 0xFF
        emitted = []
        for i, b in enumerate(data):
            if level is not None and float(np.asarray(level).reshape(-1)[i]) \
                    < self.threshold:
                if self._length:
                    emitted.append(" [%d symbols]\n" % self._length)
                    if self._file:
                        self._file.write("\n")
                    self._length = 0
                continue
            if self.limit == -1 or self._length < self.limit:
                s = self._fmt % int(b)
                emitted.append(s)
                if self._file:
                    self._file.write(s)
            self._length += 1
        text = "".join(emitted)
        if text:
            self._out.write(text)
            self._out.flush()
        if self._file:
            self._file.flush()
        return text

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
