"""BorIP / raw UDP sample plane — Python interface over the C++ engine
(port of ``grbaz_tpu/net/udp.py``).

Wire-compatible with the reference's UDP blocks:
``baz_udp_source``/``baz_udp_sink`` (the reference's lib/
baz_udp_source.cc:74-127, baz_udp_sink.cc:69-78): 4-byte BorIP header
{u8 flags, u8 notification, u16 seq}, default payload 1472 bytes,
interleaved-int16 sample format (borip_server.py:31-50), fault flags
mapped onto :class:`grbaz_tpu_torch.core.stream.stream_flags`.

The hot path (recv thread, ring buffer, sequence tracking, chunked
send) is the native ``boripnet`` C++ engine (``native/boripnet.cc``,
built into ``_build/``); a pure-Python fallback keeps everything working
where no toolchain exists. ``_lib`` is None on the fallback: a caller
that must run the native engine checks it. The native read drains the
ring into a reused numpy buffer (one ``memcpy`` per packet) and returns
its bytes (the JAX module's ``bytes(buf[:n])`` on a ctypes array builds
a list of Python ints first).

A UDP source must accumulate partial reads: a read returns whatever
whole packets have arrived, and a block may straddle any number of
reads. Dropping a short read loses those samples for good.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
from collections import deque
from typing import Optional, Tuple

import numpy as np

from grbaz_tpu_torch.core.stream import stream_flags

MODE_RAW = 0
MODE_BOR = 1
MODE_ATA = 2
DEFAULT_PAYLOAD = 1472  # swig/baz_swig.i:347-348
BOR_HEADER = struct.Struct("<BBH")
# ATA radio-astronomy header: 64 packed bytes with stream metadata and
# a 32-bit sequence id (reference lib/baz_udp_source.cc:85-100).
# group, version, bitsPerSample, binaryPoint, order, type, streams,
# polCode, hdrLen, src, chan, seq, freq, sampleRate, usableFraction,
# reserved, absTime, flags, len
ATA_HEADER = struct.Struct("<4BI4BIIIddffQII")
assert ATA_HEADER.size == 64


def complex_to_ishort_bytes(x: np.ndarray) -> bytes:
    """complex64 -> interleaved int16 wire format (scale 32767)."""
    s = np.empty(2 * len(x), np.int16)
    s[0::2] = np.clip(np.round(x.real * 32767.0), -32768, 32767)
    s[1::2] = np.clip(np.round(x.imag * 32767.0), -32768, 32767)
    return s.tobytes()


def ishort_bytes_to_complex(b: bytes) -> np.ndarray:
    s = np.frombuffer(b, np.int16).astype(np.float32) * (1.0 / 32767.0)
    return (s[0::2] + 1j * s[1::2]).astype(np.complex64)


def _native():
    try:
        from grbaz_tpu_torch import native
        return native.load_boripnet()
    except Exception:
        return None


class UDPSampleReceiver:
    """Receives a (BorIP or raw) UDP sample stream into a ring buffer."""

    def __init__(self, port: int = 0, payload_size: int = DEFAULT_PAYLOAD,
                 bor: bool = True, ring_packets: int = 8192,
                 sock_buf: int = 1 << 22, force_python: bool = False,
                 mode: Optional[int] = None):
        self.payload_size = payload_size
        self.mode = mode if mode is not None else (
            MODE_BOR if bor else MODE_RAW)
        self._ata_meta = dict(freq=0.0, sample_rate=0.0, abs_time=0,
                              bits_per_sample=0)
        self._lib = None if force_python else _native()
        self._buf = np.zeros(0, np.uint8)
        if self._lib is not None:
            self._h = self._lib.borip_rx_create(
                port, payload_size, ring_packets, self.mode, sock_buf)
            if not self._h:
                raise OSError(f"failed to bind UDP port {port}")
            self.port = self._lib.borip_rx_port(self._h)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  sock_buf)
            self._sock.bind(("0.0.0.0", port))
            self._sock.settimeout(0.1)
            self.port = self._sock.getsockname()[1]
            self._q: deque = deque(maxlen=ring_packets)
            self._flags = 0
            self._dropped = 0
            self._packets = 0
            self._seq = None
            self._run = True
            self._thr = threading.Thread(target=self._rx_loop, daemon=True)
            self._thr.start()

    # -- python fallback path -----------------------------------------------
    def _rx_loop(self):
        while self._run:
            try:
                pkt = self._sock.recv(self.payload_size + ATA_HEADER.size)
            except socket.timeout:
                continue
            except OSError:
                break
            flags = 0
            payload = pkt
            if self.mode == MODE_ATA:
                if len(pkt) < ATA_HEADER.size:
                    continue
                (_g, _v, bps, _bp, _order, _t, _streams, _pol, _hl,
                 _src, _chan, seq, freq, rate, _uf, _res, abs_time,
                 _hflags, dlen) = ATA_HEADER.unpack(pkt[:ATA_HEADER.size])
                payload = pkt[ATA_HEADER.size:]
                if dlen and dlen < len(payload):
                    payload = payload[:dlen]
                if self._seq is not None and seq != self._seq:
                    self._dropped += (seq - self._seq) & 0xFFFFFFFF
                    flags |= stream_flags.NETWORK_OVERRUN
                self._seq = (seq + 1) & 0xFFFFFFFF
                self._ata_meta = dict(freq=freq, sample_rate=rate,
                                      abs_time=abs_time,
                                      bits_per_sample=bps)
            elif self.mode == MODE_BOR:
                if len(pkt) < 4:
                    continue
                flags, _notif, idx = BOR_HEADER.unpack(pkt[:4])
                payload = pkt[4:]
                if flags & stream_flags.STREAM_START or self._seq is None:
                    self._seq = (idx + 1) & 0xFFFF
                else:
                    if idx != self._seq:
                        self._dropped += (idx - self._seq) & 0xFFFF
                        flags |= stream_flags.NETWORK_OVERRUN
                    self._seq = (idx + 1) & 0xFFFF
                if flags & stream_flags.EMPTY_PAYLOAD:
                    payload = b""
            self._packets += 1
            self._flags |= flags
            self._q.append(payload)

    # -- common API ----------------------------------------------------------
    def read_bytes(self, max_bytes: int) -> Tuple[bytes, int]:
        """Drain up to max_bytes; returns (payload, flags)."""
        if self._lib is not None:
            if len(self._buf) < max_bytes:
                self._buf = np.zeros(max_bytes, np.uint8)
            fl = ctypes.c_uint8(0)
            n = self._lib.borip_rx_read(self._h, self._buf.ctypes.data,
                                        max_bytes, ctypes.byref(fl))
            return self._buf[:n].tobytes(), fl.value
        out = []
        total = 0
        while self._q and total + len(self._q[0]) <= max_bytes:
            p = self._q.popleft()
            out.append(p)
            total += len(p)
        flags, self._flags = self._flags, 0
        return b"".join(out), flags

    def read_complex(self, max_samples: int) -> Tuple[np.ndarray, int]:
        """Drain as interleaved-ishort complex samples."""
        b, flags = self.read_bytes(max_samples * 4)
        return ishort_bytes_to_complex(b[: len(b) // 4 * 4]), flags

    def ata_info(self) -> dict:
        """Last-seen ATA stream metadata (freq/rate/time, ATA mode)."""
        if self._lib is not None:
            f = ctypes.c_double()
            r = ctypes.c_double()
            t = ctypes.c_uint64()
            b = ctypes.c_uint32()
            self._lib.borip_rx_ata_info(self._h, ctypes.byref(f),
                                        ctypes.byref(r), ctypes.byref(t),
                                        ctypes.byref(b))
            return dict(freq=f.value, sample_rate=r.value,
                        abs_time=t.value, bits_per_sample=b.value)
        return dict(self._ata_meta)

    def stats(self):
        if self._lib is not None:
            p = ctypes.c_uint64()
            d = ctypes.c_uint64()
            o = ctypes.c_uint64()
            self._lib.borip_rx_stats(self._h, ctypes.byref(p),
                                     ctypes.byref(d), ctypes.byref(o))
            return dict(packets=p.value, dropped=d.value, overruns=o.value)
        return dict(packets=self._packets, dropped=self._dropped, overruns=0)

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.borip_rx_destroy(self._h)
                self._h = None
        else:
            self._run = False
            self._sock.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UDPSampleSender:
    """Sends a (BorIP or raw) UDP sample stream, chunked to payload size."""

    def __init__(self, host: str = "", port: int = 0,
                 payload_size: int = DEFAULT_PAYLOAD, bor: bool = True,
                 force_python: bool = False, mode: Optional[int] = None):
        self.payload_size = payload_size
        self.mode = mode if mode is not None else (
            MODE_BOR if bor else MODE_RAW)
        self._ata = dict(freq=0.0, rate=0.0, chan=0, src=0,
                         bits_per_sample=16, item_bytes=4, abs_time=0)
        self._lib = None if force_python else _native()
        if self._lib is not None:
            self._h = self._lib.borip_tx_create(
                host.encode() if host else b"", port, payload_size, self.mode)
            if not self._h:
                raise OSError("failed to create UDP sender")
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._dest = (host, port) if host else None
            self._seq = 0
            self._started = False

    def connect(self, host: str, port: int):
        if self._lib is not None:
            if self._lib.borip_tx_connect(self._h, host.encode(), port) != 0:
                raise OSError(f"bad destination {host}:{port}")
        else:
            self._dest = (host, port)

    def set_ata_meta(self, freq: float = 0.0, rate: float = 0.0,
                     chan: int = 0, src: int = 0,
                     bits_per_sample: int = 16, item_bytes: int = 4):
        """Configure metadata stamped into outgoing ATA headers."""
        self._ata.update(freq=freq, rate=rate, chan=chan, src=src,
                         bits_per_sample=bits_per_sample,
                         item_bytes=item_bytes)
        if self._lib is not None:
            self._lib.borip_tx_ata_meta(self._h, freq, rate, chan, src,
                                        bits_per_sample, item_bytes)

    def send_bytes(self, data: bytes, flags: int = 0) -> int:
        if self._lib is not None:
            data = bytes(data)
            return self._lib.borip_tx_send(self._h, data, len(data), flags)
        if self._dest is None:
            return -1
        sent = 0
        while sent < len(data):
            chunk = data[sent:sent + self.payload_size]
            if self.mode == MODE_ATA:
                a = self._ata
                hdr = ATA_HEADER.pack(
                    0, 1, a["bits_per_sample"], 0, 0, 0, 1, 0,
                    ATA_HEADER.size, a["src"], a["chan"],
                    self._seq & 0xFFFFFFFF, a["freq"], a["rate"],
                    1.0, 0.0, a["abs_time"], 0, len(chunk))
                self._seq += 1
                a["abs_time"] += len(chunk) // max(1, a["item_bytes"])
                self._sock.sendto(hdr + chunk, self._dest)
            elif self.mode == MODE_BOR:
                f = flags
                if not self._started:
                    f |= stream_flags.STREAM_START
                    self._started = True
                hdr = BOR_HEADER.pack(f, 0, self._seq & 0xFFFF)
                self._seq += 1
                self._sock.sendto(hdr + chunk, self._dest)
            else:
                self._sock.sendto(chunk, self._dest)
            sent += len(chunk)
        return sent

    def send_complex(self, x: np.ndarray, flags: int = 0) -> int:
        return self.send_bytes(complex_to_ishort_bytes(x), flags)

    def end_stream(self):
        if self._lib is not None:
            self._lib.borip_tx_end(self._h)
        elif self._dest is not None and self.mode == MODE_BOR:
            hdr = BOR_HEADER.pack(
                stream_flags.STREAM_END | stream_flags.EMPTY_PAYLOAD, 0,
                self._seq & 0xFFFF)
            self._seq += 1
            self._started = False
            self._sock.sendto(hdr, self._dest)

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.borip_tx_destroy(self._h)
                self._h = None
        else:
            self._sock.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
