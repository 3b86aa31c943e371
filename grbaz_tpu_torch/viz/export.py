"""Dependency-free image/CSV writers used by the export sinks (port of
``grbaz_tpu/viz/export.py``; host only)."""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np


def write_image(path: str, rgb: np.ndarray):
    """Write an [h, w, 3] uint8 raster as PNG (pure-python zlib encoder);
    falls back to binary PPM on any failure."""
    rgb = np.asarray(rgb, np.uint8)
    try:
        h, w, _ = rgb.shape
        raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

        def chunk(tag, data):
            c = struct.pack(">I", len(data)) + tag + data
            return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

        png = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw, 6))
               + chunk(b"IEND", b""))
        with open(path, "wb") as f:
            f.write(png)
    except Exception:
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
            f.write(rgb.tobytes())


def write_csv(path: str, rows: Iterable[Sequence],
              header: Optional[Sequence[str]] = None):
    """Write rows of scalars as CSV."""
    with open(path, "w") as f:
        if header:
            f.write(",".join(str(h) for h in header) + "\n")
        for row in rows:
            f.write(",".join(repr(float(v)) if isinstance(v, (int, float,
                                                              np.floating))
                             else str(v) for v in np.atleast_1d(row)) + "\n")
