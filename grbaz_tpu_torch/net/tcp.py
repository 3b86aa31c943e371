"""TCP sample plane with typed frames and serialized stream tags.

Protocol parity with ``baz_tcp_sink`` / ``baz_tcp_source``
(the reference's lib/baz_tcp_sink.cc:78-93,269-288;
baz_tcp_source.cc:374-400): each frame is

    header {u8 type, u8 flags, u32 length LE} + payload

with types BT_DATA (raw samples) and BT_TAGS (serialized stream tags
that the receiver re-injects), and a zero-length BF_STREAM_END frame at
end-of-stream. The sink connects out (blocking or drop mode, optional
auto-reconnect, swig/baz_swig.i:831); the source listens and accepts
one client at a time.

Tag wire format: the reference serializes GNU Radio PMT dictionaries;
this framework has no PMT, so tags travel as a compact JSON object
``{"offset": int, "tags": {key: value, ...}}`` — same capability
(arbitrary keyed metadata pinned to a sample offset), implementation-
defined encoding, symmetric between this sink and source.

The port's copy of ``grbaz_tpu/net/tcp.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

FRAME_HEADER = struct.Struct("<BBI")

BT_NONE = 0x00
BT_DATA = 0x01
BT_TAGS = 0x02

BF_NONE = 0x00
BF_STREAM_END = 0x20


class TCPFrameSink:
    """Connects to a receiver; sends BT_DATA/BT_TAGS frames."""

    def __init__(self, host: str, port: int, auto_reconnect: bool = False,
                 blocking: bool = True, timeout: float = 5.0):
        self.addr = (host, port)
        self.auto_reconnect = auto_reconnect
        self.blocking = blocking
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._connect()

    def _connect(self):
        try:
            self._sock = socket.create_connection(self.addr, self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            self._sock = None
            if not self.auto_reconnect:
                raise

    def _send_frame(self, ftype: int, payload: bytes, flags: int = 0) -> bool:
        with self._lock:
            if self._sock is None:
                if not self.auto_reconnect:
                    return False
                self._connect()
                if self._sock is None:
                    return False
            try:
                self._sock.sendall(
                    FRAME_HEADER.pack(ftype, flags, len(payload)) + payload)
                return True
            except OSError:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                return False

    def send_samples(self, x: np.ndarray,
                     tags: Optional[List[dict]] = None) -> bool:
        """Send tags (if any) then the sample payload — the reference's
        order (tags frame precedes its data frame)."""
        if tags:
            blob = json.dumps(tags).encode()
            if not self._send_frame(BT_TAGS, blob):
                return False
        return self._send_frame(BT_DATA, np.ascontiguousarray(x).tobytes())

    def end_stream(self):
        self._send_frame(BT_DATA, b"", flags=BF_STREAM_END)

    def close(self):
        with self._lock:
            if self._sock:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class TCPFrameSource:
    """Listens; accepts one client; yields (samples, tags) in order."""

    def __init__(self, port: int = 0, dtype=np.complex64,
                 ring_bytes: int = 1 << 24):
        self.dtype = np.dtype(dtype)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", port))
        self._listener.listen(1)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        self._frames: deque = deque()
        self._pending_tags: List[dict] = []
        self._stream_ended = False
        self._lock = threading.Lock()
        self._run = True
        self._thr = threading.Thread(target=self._accept_loop, daemon=True)
        self._thr.start()

    def _accept_loop(self):
        while self._run:
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.2)
            self._client_loop(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _recv_exact(self, conn, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n and self._run:
            try:
                chunk = conn.recv(n - len(buf))
            except socket.timeout:
                continue
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf if len(buf) == n else None

    def _client_loop(self, conn):
        while self._run:
            hdr = self._recv_exact(conn, FRAME_HEADER.size)
            if hdr is None:
                return
            ftype, flags, length = FRAME_HEADER.unpack(hdr)
            payload = self._recv_exact(conn, length) if length else b""
            if payload is None:
                return
            with self._lock:
                if flags & BF_STREAM_END:
                    self._stream_ended = True
                if ftype == BT_TAGS:
                    try:
                        self._pending_tags = json.loads(payload.decode())
                    except (ValueError, UnicodeDecodeError):
                        self._pending_tags = []
                elif ftype == BT_DATA and length:
                    tags, self._pending_tags = self._pending_tags, []
                    self._frames.append((payload, tags))

    def read(self) -> Tuple[np.ndarray, List[dict]]:
        """Pop the next data frame as (samples, tags); empty if none."""
        with self._lock:
            if not self._frames:
                return np.zeros(0, self.dtype), []
            payload, tags = self._frames.popleft()
        n = len(payload) // self.dtype.itemsize
        return np.frombuffer(payload[:n * self.dtype.itemsize],
                             self.dtype), tags

    def stream_ended(self) -> bool:
        with self._lock:
            return self._stream_ended

    def close(self):
        self._run = False
        try:
            self._listener.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# native engine variants (C++ hot path, grbaz_tpu_torch/native/tcpframe.cc)
# ---------------------------------------------------------------------------

class NativeTCPFrameSink:
    """Same protocol as :class:`TCPFrameSink`, framed sends in C++.

    Use for bulk sample planes: the framing, socket writes and reconnect
    logic run native; Python only hands over buffers.
    """

    def __init__(self, host: str, port: int, auto_reconnect: bool = False):
        import ctypes
        from grbaz_tpu_torch import native
        self._c = ctypes
        self._lib = native.load_tcpframe()
        self._h = self._lib.tcpf_sink_create(
            host.encode(), port, 1 if auto_reconnect else 0)
        if not self._h:
            raise ConnectionError(f"cannot connect to {host}:{port}")

    def _send(self, ftype: int, payload, flags: int = 0) -> bool:
        """payload: bytes or a contiguous np array — sent zero-copy
        (the object stays referenced for the duration of the call)."""
        c = self._c
        if isinstance(payload, np.ndarray):
            ptr = payload.ctypes.data_as(c.POINTER(c.c_uint8))
            n = payload.nbytes
        elif payload:
            # c_char_p keeps a pointer into the bytes object (read-only)
            ptr = c.cast(c.c_char_p(payload), c.POINTER(c.c_uint8))
            n = len(payload)
        else:
            ptr, n = None, 0
        return bool(self._lib.tcpf_sink_send(self._h, ftype, flags, ptr, n))

    def send_samples(self, x: np.ndarray,
                     tags: Optional[List[dict]] = None) -> bool:
        if tags:
            if not self._send(BT_TAGS, json.dumps(tags).encode()):
                return False
        return self._send(BT_DATA, np.ascontiguousarray(x))

    def end_stream(self):
        self._send(BT_DATA, b"", flags=BF_STREAM_END)

    def stats(self):
        c = self._c
        f, b, fail = c.c_uint64(), c.c_uint64(), c.c_uint64()
        self._lib.tcpf_sink_stats(self._h, c.byref(f), c.byref(b),
                                  c.byref(fail))
        return dict(frames=f.value, bytes=b.value, send_failures=fail.value)

    def close(self):
        if self._h:
            self._lib.tcpf_sink_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTCPFrameSource:
    """Listening receiver with the frame parser + data ring in C++.

    ``read(max_items)`` drains up to ``max_items`` samples in bulk
    (unlike the per-frame Python variant) and returns ``(samples,
    tags)`` where tags is the list of tag dicts whose position precedes
    the drained data (each annotated with its byte ``_offset`` into the
    stream).
    """

    def __init__(self, port: int = 0, dtype=np.complex64,
                 ring_bytes: int = 1 << 24):
        import ctypes
        from grbaz_tpu_torch import native
        self._c = ctypes
        self._lib = native.load_tcpframe()
        self.dtype = np.dtype(dtype)
        self._h = self._lib.tcpf_src_create(port, ring_bytes)
        if not self._h:
            raise OSError(f"cannot listen on port {port}")
        self.port = int(self._lib.tcpf_src_port(self._h))
        self._pending = b""  # partial trailing item bytes

    def read(self, max_items: int = 1 << 16):
        c = self._c
        want = max_items * self.dtype.itemsize - len(self._pending)
        buf = (c.c_uint8 * max(want, 0))()
        off = c.c_uint64()
        n = self._lib.tcpf_src_read(
            self._h, c.cast(buf, c.POINTER(c.c_uint8)), len(buf),
            c.byref(off)) if want > 0 else 0
        # one memcpy (slicing a ctypes array builds a list of ints first)
        raw = self._pending + c.string_at(buf, n)
        n_items = len(raw) // self.dtype.itemsize
        used = n_items * self.dtype.itemsize
        self._pending = raw[used:]
        samples = np.frombuffer(raw[:used], self.dtype)
        # collect tags positioned before the end of what we just drained
        tags = []
        up_to = off.value + n
        tbuf = (c.c_uint8 * 65536)()
        while True:
            toff = c.c_uint64()
            tn = self._lib.tcpf_src_next_tag(
                self._h, c.cast(tbuf, c.POINTER(c.c_uint8)), len(tbuf),
                up_to, c.byref(toff))
            if tn == 0:
                break
            if tn < 0:  # blob larger than 64k: grow
                tbuf = (c.c_uint8 * (len(tbuf) * 4))()
                continue
            try:
                blob = json.loads(bytes(tbuf[:tn]).decode())
            except (ValueError, UnicodeDecodeError):
                continue
            for t in (blob if isinstance(blob, list) else [blob]):
                if isinstance(t, dict):
                    t["_offset"] = toff.value
                    tags.append(t)
        return samples, tags

    def stream_ended(self) -> bool:
        c = self._c
        end, conn = c.c_int(), c.c_int()
        self._lib.tcpf_src_stats(self._h, None, None, None, c.byref(end),
                                 c.byref(conn))
        return bool(end.value)

    def stats(self):
        c = self._c
        f, b, o = c.c_uint64(), c.c_uint64(), c.c_uint64()
        end, conn = c.c_int(), c.c_int()
        self._lib.tcpf_src_stats(self._h, c.byref(f), c.byref(b),
                                 c.byref(o), c.byref(end), c.byref(conn))
        return dict(frames=f.value, bytes=b.value, ring_overruns=o.value,
                    stream_end=bool(end.value), connected=bool(conn.value))

    def close(self):
        if self._h:
            self._lib.tcpf_src_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
