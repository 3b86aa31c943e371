"""Radar pulse-report distribution server.

Equivalent of the reference's ``python/radar_server.py`` (:31-54 custom
queue, :113-297 TCP control thread with the sweep loop, :306-404 report
accumulation with 15-bit TSF rollover unwrapping, :405-420 composite):
a line-oriented TCP command server that drives a frequency sweep over a
radar detector and broadcasts base64-encoded pulse reports to every
connected client.

Protocol (same verb set as the reference control loop :200-236):

* ``FREQ <MHz>``           — tune to a fixed frequency; replies ``FREQ <f>``
* ``FIRPWR|RSSI|PHEIGHT|PRSSI|INBAND <int>`` — detector parameter set
* ``START [f0 [f1 [step [interval]]]]``      — begin sweep (MHz units)
* ``STOP``                 — halt the sweep
* ``QUIT`` / ``EXIT``      — end command processing for this batch

While sweeping, after each ``interval``-second dwell the server
broadcasts ``DATA <freq> <base64(reports)>``; at sweep end it sends
``END``. Reports on the wire are the reference's 8-byte record
``<u32 tsf><u8 rssi><u8 width><u8 type><u8 subtype>`` (:345, struct
"Icccc").

The radar side is any object with ``set_freq(mhz) -> bool``,
``set_param(name, value)``, ``clear_queue()`` and
``read_queue() -> bytes``; :class:`RadarReportQueue` provides the
report accumulation half, and :func:`pack_detector_events` converts
RadarDetector event arrays into wire records.

The port's copy of ``grbaz_tpu/net/radar_server.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import base64
import socketserver
import struct
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

REPORT = struct.Struct("<IBBBB")
TSF_ROLLOVER = 0x7FFF + 1  # 15-bit TSF counter


@dataclass
class RadarReport:
    """One decoded pulse report (radar_error equivalent, :296-304)."""
    tsf: int
    rssi: int
    width: int
    type: int = 0
    subtype: int = 0
    overflow: int = 0


def _host(x) -> np.ndarray:
    """``x`` as numpy: a tensor of the port, on any device, in one copy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def pack_detector_events(starts, lengths, maxima, sample_rate: float,
                         tsf_hz: float = 1e6) -> bytes:
    """Pack RadarDetector events (start_idx, length, max) into wire
    records: tsf = start time in µs (15-bit domain), rssi = clipped
    power dB, width = clipped length."""
    out = bytearray()
    for s, ln, mx in zip(_host(starts), _host(lengths), _host(maxima)):
        tsf = int(s / sample_rate * tsf_hz)
        rssi = int(np.clip(10.0 * np.log10(max(float(mx), 1e-12)) + 100.0,
                           0, 255))
        out += REPORT.pack(tsf & 0xFFFFFFFF, rssi,
                           int(np.clip(int(ln), 0, 255)), 0, 0)
    return bytes(out)


def unpack_reports(data: bytes) -> List[RadarReport]:
    """Decode raw records and unwrap 15-bit TSF rollovers so every
    report carries a monotonically comparable tsf (reference :334-369)."""
    reports = []
    overflows = 0
    last = None
    for off in range(0, len(data) - REPORT.size + 1, REPORT.size):
        tsf, rssi, width, typ, sub = REPORT.unpack_from(data, off)
        r = RadarReport(tsf, rssi, width, typ, sub)
        if last is not None and r.tsf < last.tsf:
            overflows += 1
        r.overflow = overflows
        reports.append(r)
        last = r
    for r in reports:
        r.tsf -= TSF_ROLLOVER * (overflows - r.overflow)
    return reports


class RadarReportQueue:
    """Bounded, thread-safe accumulation of raw report records
    (radar_server_message_thread equivalent, :306-404)."""

    def __init__(self, queue_size: int = 2048):
        self.queue_size = queue_size
        self._lock = threading.Lock()
        self._reports: List[bytes] = []

    def insert(self, raw: bytes):
        with self._lock:
            if len(self._reports) < self.queue_size:
                self._reports.append(raw)

    def clear_queue(self):
        with self._lock:
            self._reports = []

    def read_queue(self, clear: bool = True) -> bytes:
        with self._lock:
            data = b"".join(self._reports)
            if clear:
                self._reports = []
        return data


class _Handler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        with self.server.clients_lock:
            self.server.clients.append(self)

    def handle(self):
        try:
            for line in self.rfile:
                cmd = line.decode(errors="replace").strip()
                if cmd:
                    self.server.radar_server._command(cmd)
        except OSError:
            pass

    def finish(self):
        with self.server.clients_lock:
            if self in self.server.clients:
                self.server.clients.remove(self)
        try:
            super().finish()
        except OSError:
            pass


class _TCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RadarServer:
    """TCP command server + sweep loop (radar_server_control_thread)."""

    def __init__(self, radar, port: int = 5256, report_queue=None,
                 detector=None):
        self.radar = radar
        self.detector = detector
        self.queue = report_queue or RadarReportQueue()
        self._srv = _TCP(("0.0.0.0", port), _Handler)
        self._srv.clients = []
        self._srv.clients_lock = threading.Lock()
        self._srv.radar_server = self
        self.port = self._srv.server_address[1]
        self._lock = threading.Lock()
        self._wake = threading.Event()
        # sweep state (defaults match the reference, :172-177)
        self.running = False
        self.freq: Optional[float] = None
        self.freq_start, self.freq_stop, self.freq_step = 4920, 6100, 5
        self.interval = 1.0
        self._keep = True
        self._srv_thr = threading.Thread(target=self._srv.serve_forever,
                                         daemon=True)
        self._srv_thr.start()
        self._loop_thr = threading.Thread(target=self._run, daemon=True)
        self._loop_thr.start()

    # -- command processing ---------------------------------------------------
    def _command(self, line: str):
        parts = line.split()
        cmd = parts[0].upper()
        try:
            if cmd == "FREQ" and len(parts) > 1:
                f = int(parts[1])
                with self._lock:
                    if self.freq_start == self.freq_stop:
                        self.freq_start = self.freq_stop = f
                    self.freq = f
                if self.radar.set_freq(f):
                    self.queue.clear_queue()
                    self.send_to_clients("FREQ %d" % f)
            elif cmd in ("FIRPWR", "RSSI", "PHEIGHT", "PRSSI",
                         "INBAND") and len(parts) > 1:
                target = self.detector or self.radar
                if hasattr(target, "set_param"):
                    target.set_param(cmd, int(parts[1]))
            elif cmd == "STOP":
                with self._lock:
                    self.running = False
            elif cmd == "START":
                with self._lock:
                    if len(parts) > 1:
                        self.freq_start = int(parts[1])
                    if len(parts) > 2:
                        self.freq_stop = int(parts[2])
                    if len(parts) > 3:
                        self.freq_step = abs(int(parts[3]))
                    if len(parts) > 4:
                        self.interval = float(parts[4])
                    self.running = True
                    self.freq = None
                self._wake.set()
        except (ValueError, IndexError):
            pass

    # -- sweep loop (reference :238-288) --------------------------------------
    def _run(self):
        while self._keep:
            with self._lock:
                running = self.running
            if not running:
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            with self._lock:
                freq_change = False
                if self.freq is not None:
                    if self.freq_start != self.freq_stop:
                        step = (self.freq_step if self.freq_start
                                < self.freq_stop else -self.freq_step)
                        self.freq += step
                        past_end = (self.freq > self.freq_stop
                                    if step > 0 else self.freq < self.freq_stop)
                        if past_end:
                            self.running = False
                        else:
                            freq_change = True
                else:
                    self.freq = self.freq_start
                    freq_change = True
                running, freq, interval = (self.running, self.freq,
                                           self.interval)
            if not running:
                self.send_to_clients("END")
                continue
            if freq_change and not self.radar.set_freq(freq):
                continue
            if freq_change:
                self.queue.clear_queue()
            time.sleep(interval)
            data = self.queue.read_queue()
            self.send_to_clients(
                "DATA %d %s" % (freq, base64.b64encode(data).decode()))
            with self._srv.clients_lock:
                if not self._srv.clients:
                    with self._lock:
                        self.running = False

    def send_to_clients(self, msg: str) -> int:
        line = (msg.rstrip("\r\n") + "\n").encode()
        sent = 0
        with self._srv.clients_lock:
            for c in list(self._srv.clients):
                try:
                    c.wfile.write(line)
                    c.wfile.flush()
                    sent += 1
                except OSError:
                    pass
        return sent

    def stop(self):
        self._keep = False
        self._wake.set()
        self._srv.shutdown()
        self._srv.server_close()
