"""Extended capture-file source: WAV + SpectraVue auxi + timing files
(port of ``grbaz_tpu/io/file_source.py``; host only).

Capability parity with ``baz_file_source``
(the reference's lib/baz_file_source.cc):

* RIFF/WAVE parsing including the SpectraVue ``auxi`` chunk — capture
  center frequency + absolute start/end times as SYSTEMTIME structs
  (:78-110, struct layout :88-103);
* external *timing files* — text lines ``R<rate>`` and
  ``<ticks>,<sample_count>`` pairs (:223-304) that map file sample
  counts onto a continuous tick timeline; playback zero-pads the gaps so
  replay is time-faithful;
* multi-file playlists, ``seek/offset/time/sample_rate/duration/
  file_index`` API (lib/baz_file_source.h:57-88), optional throttle and
  looping;
* raw formats: complex64, interleaved i16, interleaved u8 (RTL capture).

This is the capture/replay half of the framework's checkpoint story
(SURVEY.md §5): deterministic, time-faithful re-ingestion.
"""

from __future__ import annotations

import datetime
import os
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from grbaz_tpu_torch.core.stream import stream_flags

_SYSTEMTIME = struct.Struct("<8H")  # year,month,dow,day,hour,min,sec,ms
_AUXI = struct.Struct("<8H8Hl24sl")  # start, end, freq1, pad, freq2
_WAVE_FMT = struct.Struct("<HHIIHH")


def _systemtime_to_datetime(fields) -> Optional[datetime.datetime]:
    year, month, _dow, day, hour, minute, second, ms = fields
    if year == 0:
        return None
    try:
        return datetime.datetime(year, month, day, hour, minute, second,
                                 ms * 1000, tzinfo=datetime.timezone.utc)
    except ValueError:
        return None


class CaptureFile:
    """One capture file: raw or WAV (with optional auxi + timing file)."""

    def __init__(self, path: str, fmt: str = "auto",
                 sample_rate_hint: float = 0.0, freq_hint: float = 0.0,
                 timing_path: Optional[str] = None):
        self.path = path
        self.sample_rate = float(sample_rate_hint)
        self.freq = float(freq_hint)
        self.time_start: Optional[datetime.datetime] = None
        self.time_end: Optional[datetime.datetime] = None
        self.data_offset = 0
        self.fmt = fmt
        self._f = open(path, "rb")
        header = self._f.read(12)
        if fmt in ("auto", "wav") and header[:4] == b"RIFF" \
                and header[8:12] == b"WAVE":
            self._parse_wave()
        else:
            self._parse_raw(fmt if fmt != "auto" else "c64")
        size = os.path.getsize(path)
        self.length = (size - self.data_offset) // self.itemsize
        # timing info: list of (ticks, sample_count), ticks in samples
        self.timing: List[Tuple[int, int]] = [(0, 0)]
        if timing_path:
            self._parse_timing(timing_path)

    # -- parsing --------------------------------------------------------------
    def _parse_wave(self):
        self._f.seek(12)
        fmt_found = False
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                blob = self._f.read(csize)
                (wformat, channels, rate, _abps, _align, bits) = \
                    _WAVE_FMT.unpack(blob[:16])
                self.sample_rate = float(rate)
                if channels == 2 and bits == 16:
                    self.wire_dtype, self.itemsize = "i16iq", 4
                    self.out_dtype = np.complex64
                elif channels == 2 and bits == 8:
                    self.wire_dtype, self.itemsize = "u8iq", 2
                    self.out_dtype = np.complex64
                elif channels == 1 and bits == 16:
                    self.wire_dtype, self.itemsize = "i16", 2
                    self.out_dtype = np.float32
                else:
                    raise ValueError(
                        f"unsupported WAV layout ch={channels} bits={bits}")
                fmt_found = True
            elif cid == b"auxi":
                blob = self._f.read(csize)
                if len(blob) >= _AUXI.size:
                    vals = _AUXI.unpack(blob[:_AUXI.size])
                    self.time_start = _systemtime_to_datetime(vals[0:8])
                    self.time_end = _systemtime_to_datetime(vals[8:16])
                    self.freq = float(vals[16])  # freq1 (auxi center freq)
            elif cid == b"data":
                self.data_offset = self._f.tell()
                self._f.seek(csize, 1)
            else:
                self._f.seek(csize + (csize & 1), 1)
        if not fmt_found:
            raise ValueError(f"{self.path}: WAV without fmt chunk")

    def _parse_raw(self, fmt: str):
        table = dict(c64=("c64", 8, np.complex64),
                     i16=("i16iq", 4, np.complex64),
                     u8=("u8iq", 2, np.complex64),
                     f32=("f32", 4, np.float32))
        if fmt not in table:
            raise ValueError(f"unknown raw format {fmt}")
        self.wire_dtype, self.itemsize, self.out_dtype = table[fmt]
        self.data_offset = 0

    def _parse_timing(self, path: str):
        self.timing = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line[0] in "Rr":
                    rate = float(line[1:])
                    if rate <= 0:
                        raise ValueError("invalid rate in timing file")
                    self.sample_rate = rate
                    continue
                if "," not in line:
                    continue
                ticks_s, count_s = line.split(",", 1)
                self.timing.append((int(ticks_s), int(count_s)))
        if not self.timing:
            self.timing = [(0, 0)]

    # -- access ---------------------------------------------------------------
    def _segments(self):
        """[(tick_start, samp_start, n_samples, tick_next), ...] with
        ticks normalized to the first timing entry."""
        if getattr(self, "_segs", None) is not None:
            return self._segs
        t0 = self.timing[0][0]
        segs = []
        for i, (t, c) in enumerate(self.timing):
            if i + 1 < len(self.timing):
                have = self.timing[i + 1][1] - c
                t_next = self.timing[i + 1][0] - t0
            else:
                have = self.length - c
                t_next = (t - t0) + have
            segs.append((t - t0, c, have, t_next))
        self._segs = segs
        return segs

    @property
    def padded_length(self) -> int:
        """Length on the tick timeline (with gaps), in samples."""
        last = self._segments()[-1]
        return last[0] + last[2]

    def span_at(self, pos: int):
        """Classify timeline position: ('data', run_len, file_sample_idx)
        | ('gap', run_len, next_data_pos) | ('eof', 0, None)."""
        for (t, c, have, t_next) in self._segments():
            if t <= pos < t + have:
                return ("data", (t + have) - pos, c + (pos - t))
            if t + have <= pos < t_next:
                return ("gap", t_next - pos, t_next)
        return ("eof", 0, None)

    def read_at(self, sample_index: int, n: int) -> np.ndarray:
        """Read n samples starting at a file sample index (no padding)."""
        self._f.seek(self.data_offset + sample_index * self.itemsize)
        raw = self._f.read(n * self.itemsize)
        return self._decode(raw)

    def _decode(self, raw: bytes) -> np.ndarray:
        if self.wire_dtype == "c64":
            return np.frombuffer(raw, np.complex64)
        if self.wire_dtype == "i16iq":
            s = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
            return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
        if self.wire_dtype == "u8iq":
            s = (np.frombuffer(raw, np.uint8).astype(np.float32)
                 - 127.5) / 127.5
            return (s[0::2] + 1j * s[1::2]).astype(np.complex64)
        if self.wire_dtype == "i16":
            return np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
        if self.wire_dtype == "f32":
            return np.frombuffer(raw, np.float32)
        raise AssertionError

    def close(self):
        self._f.close()


class FileSource:
    """Playlist file source with time-faithful gap padding and seek API."""

    def __init__(self, paths, fmt: str = "auto", sample_rate: float = 0.0,
                 timing_paths=None, pad: bool = True, loop: bool = False,
                 throttle: bool = False):
        if isinstance(paths, str):
            paths = [paths]
        timing_paths = timing_paths or [None] * len(paths)
        self.files = [CaptureFile(p, fmt, sample_rate, timing_path=t)
                      for p, t in zip(paths, timing_paths)]
        self.pad = pad
        self.loop = loop
        self.throttle = throttle
        self._file_idx = 0
        self._pos = 0  # position on the (padded) timeline of current file
        self._t_next = None

    # -- reference API surface (lib/baz_file_source.h:57-88) ------------------
    @property
    def file_index(self) -> int:
        return self._file_idx

    @property
    def sample_rate(self) -> float:
        return self.files[self._file_idx].sample_rate

    @property
    def freq(self) -> float:
        return self.files[self._file_idx].freq

    def start_time(self):
        return self.files[self._file_idx].time_start

    def duration(self) -> float:
        """Total padded duration of the playlist in seconds."""
        return sum(f.padded_length / f.sample_rate for f in self.files
                   if f.sample_rate)

    def offset(self) -> int:
        return self._pos

    def seek(self, sample: int, file_index: Optional[int] = None):
        if file_index is not None:
            self._file_idx = file_index
        f = self.files[self._file_idx]
        self._pos = max(0, min(sample, f.padded_length))

    def seek_time(self, seconds: float):
        f = self.files[self._file_idx]
        self.seek(int(round(seconds * f.sample_rate)))

    # -- streaming -------------------------------------------------------------
    def read_samples(self, n: int) -> Tuple[np.ndarray, int]:
        """Pull n samples (+flags); zero-padded gaps, playlist advance."""
        f = self.files[self._file_idx]
        if self.throttle and f.sample_rate:
            now = time.monotonic()
            if self._t_next is None:
                self._t_next = now
            dt = n / f.sample_rate
            lag = self._t_next + dt - now
            if lag > 0:
                time.sleep(lag)
            self._t_next += dt
        out = np.zeros(n, f.out_dtype)
        flags = 0
        got = 0
        while got < n:
            f = self.files[self._file_idx]
            kind, run, aux = f.span_at(self._pos)
            if kind == "eof":
                if self._file_idx + 1 < len(self.files):
                    self._file_idx += 1
                    self._pos = 0
                    continue
                if self.loop:
                    self._file_idx = 0
                    self._pos = 0
                    continue
                flags |= stream_flags.STREAM_END
                break
            take = min(n - got, run)
            if kind == "gap":
                if self.pad:
                    got += take  # zeros already there
                    flags |= stream_flags.EMPTY_PAYLOAD
                self._pos += take if self.pad else run  # skip whole gap
                continue
            data = f.read_at(aux, take)
            out[got:got + len(data)] = data
            got += take
            self._pos += take
        return out, flags

    def close(self):
        for f in self.files:
            f.close()
