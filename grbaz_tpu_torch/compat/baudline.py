"""Bridge to the baudline signal analyzer (python/baudline.py:35-190).

The reference streams samples to baudline through a FIFO or a pipe and
spawns the analyzer with a command line describing the wire format.
Same here: :class:`BaudlineSink` owns the FIFO/tempdir lifecycle,
builds the command line, optionally launches the executable (skipped
when not installed — the FIFO path is exposed so any reader can
attach), and converts sample blocks to the wire format.

The port's copy of ``grbaz_tpu/compat/baudline.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_FORMATS = {
    "le32f": ("<f4", 1.0),
    "le16": ("<i2", 32767.0),
    "u8": ("u1", 127.5),
}


class BaudlineSink:
    def __init__(self, sample_rate: float, channels: int = 1,
                 is_complex: bool = True, fmt: str = "le32f",
                 mode: str = "fifo", extra_args: str = "",
                 exec_path: str = "baudline", spawn: bool = True):
        if fmt not in _FORMATS:
            raise ValueError(f"format {fmt!r} not in {sorted(_FORMATS)}")
        self.sample_rate = float(sample_rate)
        self.channels = int(channels)
        self.is_complex = bool(is_complex)
        self.fmt = fmt
        self.mode = mode
        self._p: Optional[subprocess.Popen] = None
        self._fh = None
        self.tmpdir = None
        if mode == "fifo":
            self.tmpdir = tempfile.mkdtemp(prefix="baudline_")
            self.fifo_path = os.path.join(self.tmpdir, "baudline_fifo")
            os.mkfifo(self.fifo_path)
        else:
            self.fifo_path = None
        self.command = self._command(extra_args, exec_path)
        if spawn and shutil.which(exec_path):
            if mode == "fifo":
                self._p = subprocess.Popen(self.command, shell=True)
            else:
                self._p = subprocess.Popen(self.command.split(),
                                           stdin=subprocess.PIPE)

    def _command(self, extra_args: str, exec_path: str) -> str:
        total_ch = self.channels * (2 if self.is_complex else 1)
        parts = [exec_path, "-stdin" if self.mode == "pipe" else "-stdin",
                 "-samplerate", str(int(self.sample_rate)),
                 "-channels", str(total_ch),
                 "-format", self.fmt]
        if self.is_complex:
            parts.append("-quadrature")
        if extra_args:
            parts.append(extra_args)
        cmd = " ".join(parts)
        if self.mode == "fifo":
            cmd += f" < {self.fifo_path}"
        return cmd

    def _writer(self):
        if self._fh is None:
            if self.mode == "fifo":
                # blocks until a reader attaches — as the reference does
                self._fh = open(self.fifo_path, "wb")
            elif self._p is not None:
                self._fh = self._p.stdin
            else:
                raise RuntimeError("no pipe target (spawn failed?)")
        return self._fh

    def write(self, samples: np.ndarray) -> int:
        """Convert one block to the wire format and write it."""
        dtype, scale = _FORMATS[self.fmt]
        x = np.asarray(samples)
        if np.iscomplexobj(x):
            flat = np.empty(2 * x.size, np.float32)
            flat[0::2] = x.real.reshape(-1)
            flat[1::2] = x.imag.reshape(-1)
        else:
            flat = x.astype(np.float32).reshape(-1)
        if self.fmt == "le32f":
            wire = flat.astype(dtype)
        elif self.fmt == "u8":
            wire = np.clip(flat * scale + scale, 0, 255).astype(dtype)
        else:
            wire = np.clip(np.round(flat * scale),
                           -scale - 1, scale).astype(dtype)
        buf = wire.tobytes()
        self._writer().write(buf)
        self._writer().flush()
        return len(buf)

    def close(self):
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self._p is not None:
            self._p.terminate()
            self._p = None
        if self.tmpdir:
            shutil.rmtree(self.tmpdir, ignore_errors=True)
            self.tmpdir = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
