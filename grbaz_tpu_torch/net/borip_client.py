"""BorIP client — remote SDR as a local sample source (port of
``grbaz_tpu/net/borip_client.py``; host only).

Reimplements the reference client (the reference's python/borip.py):
TCP control handshake (DEVICE / RATE / FREQ / GAIN / GO, :428-470),
BorIP-mode UDP sample reception, keepalive PING thread (every 5 s,
:40-42,69-92), and reconnect policy (attempts/interval). The received
stream feeds a StreamExecutor input port (the modern analog of the
``remote_usrp`` hier block at :94).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np

from grbaz_tpu_torch.net.udp import UDPSampleReceiver

KEEPALIVE_INTERVAL = 5.0   # reference default (borip.py:40-42)
RECONNECT_INTERVAL = 5.0
RECONNECT_ATTEMPTS = 0     # 0 = forever (reference config default)


class RemoteDevice:
    """Connects to a BorIP server; exposes read_samples for executors."""

    def __init__(self, host: str, port: int = 28888,
                 udp_port: int = 28888, device_hint: str = "",
                 keepalive: bool = True, timeout: float = 10.0):
        self.host, self.port = host, port
        self.timeout = timeout
        self.device_info: dict = {}
        self.rx = UDPSampleReceiver(port=udp_port, bor=True)
        self._sock: Optional[socket.socket] = None
        self._pending = np.zeros(0, np.complex64)  # sub-packet leftovers
        self._flags_acc = 0  # flags seen while filling the pending buffer
        self._lock = threading.Lock()
        self._keepalive = keepalive
        self._ka_thread: Optional[threading.Thread] = None
        self._closed = False
        self._connect()
        if device_hint:
            self.select_device(device_hint)

    @classmethod
    def from_config(cls, **overrides) -> "RemoteDevice":
        """Build from the [borip] config section (files/env/overrides) —
        the reference's prefs-driven client construction (borip.py:46-67)."""
        from grbaz_tpu_torch.core.config import BorIPConfig, load_config
        cfg = load_config(BorIPConfig, "borip", **overrides)
        if not cfg.server:
            raise ValueError("[borip] server not configured")
        host, _, port = cfg.server.partition(":")
        return cls(host, port=int(port) if port else cfg.default_port)

    # -- control plane --------------------------------------------------------
    def _connect(self):
        s = socket.create_connection((self.host, self.port), self.timeout)
        s.settimeout(self.timeout)
        self._sock = s
        self._rfile = s.makefile("rb")
        banner = self._readline()  # "DEVICE <desc>" greeting
        if banner.startswith("DEVICE "):
            self._parse_device(banner[len("DEVICE "):])
        if self._keepalive and self._ka_thread is None:
            self._ka_thread = threading.Thread(target=self._ka_loop,
                                               daemon=True)
            self._ka_thread.start()

    def _readline(self) -> str:
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("BorIP control connection closed")
        return line.decode("utf-8", "replace").strip()

    def command(self, cmd: str) -> str:
        """Send a verb; returns the response payload (after the echo)."""
        with self._lock:
            self._sock.sendall((cmd + "\n").encode())
            while True:
                resp = self._readline()
                verb = cmd.split(" ", 1)[0].upper()
                if resp.upper().startswith(verb):
                    return resp[len(verb):].strip()
                # unsolicited line (e.g. async DEVICE change): stash
                if resp.startswith("DEVICE "):
                    self._parse_device(resp[len("DEVICE "):])

    def _parse_device(self, desc: str):
        if desc.strip() == "-":
            self.device_info = {}
            return
        f = desc.split("|")
        if len(f) >= 10:
            self.device_info = dict(
                name=f[0], gain_min=float(f[1]), gain_max=float(f[2]),
                gain_step=float(f[3]), master_clock=float(f[4]),
                samples_per_packet=int(f[5]), antennas=f[6].split(","),
                serial=f[7], clock_sources=f[8].split(","),
                time_sources=f[9].split(","))

    def _ka_loop(self):
        while not self._closed:
            time.sleep(KEEPALIVE_INTERVAL)
            try:
                self.command("PING")
            except Exception:
                if self._closed:
                    return
                self._reconnect()

    def _reconnect(self):
        attempts = 0
        while not self._closed:
            attempts += 1
            try:
                self._connect()
                return
            except OSError:
                if RECONNECT_ATTEMPTS and attempts >= RECONNECT_ATTEMPTS:
                    raise
                time.sleep(RECONNECT_INTERVAL)

    # -- the reference client's API surface (borip.py remote_usrp) -----------
    def select_device(self, hint: str) -> dict:
        resp = self.command("DEVICE " + hint)
        self._parse_device(resp)
        if not self.device_info:
            raise RuntimeError(f"server failed to open device {hint!r}")
        return self.device_info

    def set_sample_rate(self, rate: float) -> float:
        resp = self.command(f"RATE {rate}")
        parts = resp.split()
        return float(parts[1]) if len(parts) > 1 and parts[0] == "OK" \
            else float("nan")

    def set_freq(self, freq: float) -> bool:
        return not self.command(f"FREQ {freq}").startswith("FAIL")

    def set_gain(self, gain: float) -> bool:
        return not self.command(f"GAIN {gain}").startswith("FAIL")

    def set_antenna(self, ant: str) -> bool:
        return not self.command(f"ANTENNA {ant}").startswith("FAIL")

    def start(self) -> bool:
        self.command(f"DEST -:{self.rx.port}")
        return not self.command("GO").startswith("FAIL")

    def stop(self):
        self.command("STOP")

    # -- sample plane ---------------------------------------------------------
    def read_samples(self, max_samples: int) -> Tuple[np.ndarray, int]:
        """Non-blocking drain of received samples: (complex64, flags).

        The UDP ring pops whole packets only, so requests smaller than
        one packet (payload_size/4 samples) would starve; a pending
        buffer absorbs the packet granularity.
        """
        if len(self._pending) < max_samples:
            want = max(max_samples - len(self._pending), 4096)
            x, flags = self.rx.read_complex(want)
            self._flags_acc |= flags
            if len(x):
                self._pending = np.concatenate([self._pending, x]) \
                    if len(self._pending) else x
        out = self._pending[:max_samples]
        self._pending = self._pending[max_samples:]
        flags_out, self._flags_acc = self._flags_acc, 0
        return out, flags_out

    def wait_samples(self, n: int, timeout: float = 5.0) -> np.ndarray:
        """Blocking accumulate of exactly n samples."""
        out = []
        got = 0
        deadline = time.monotonic() + timeout
        while got < n:
            x, _ = self.read_samples(n - got)
            if len(x):
                out.append(x)
                got += len(x)
            elif time.monotonic() > deadline:
                raise TimeoutError(f"only {got}/{n} samples")
            else:
                time.sleep(0.002)
        return np.concatenate(out)

    def stats(self):
        return self.rx.stats()

    def close(self):
        self._closed = True
        try:
            if self._sock:
                # the reader made by makefile() holds the socket open:
                # close both, so the server sees the disconnect and tears
                # its device down
                self._rfile.close()
                self._sock.close()
        except OSError:
            pass
        self.rx.close()
