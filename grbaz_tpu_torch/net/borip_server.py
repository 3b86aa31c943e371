"""BorIP server — remote-SDR control plane + UDP sample plane (port of
``grbaz_tpu/net/borip_server.py``; host only).

Protocol-compatible reimplementation of the reference's server
(the reference's python/borip_server.py):

* text command protocol over TCP, one command per line, verbs
  GO / STOP / DEVICE / FREQ / ANTENNA / GAIN / RATE / CLOCK_SRC /
  TIME_SRC / DEST / HEADER / PING (:981-1131);
* ``DEVICE`` response format
  ``name|gain_min|gain_max|gain_step|master_clock|samples_per_packet|
  antennas|serial|clock_srcs|time_srcs`` (:647-662);
* sample plane: complex -> interleaved short -> BorIP UDP
  (server hier block :24-68), via the native ``boripnet`` sender;
* per-client device lifecycle with teardown on disconnect (:309-329).

The device behind the server is any
:class:`grbaz_tpu_torch.net.devices.Device` — including flowgraph-backed
devices whose ``read_samples`` pulls from a chain stepped on the card.

    python -m grbaz_tpu_torch.net.borip_server -p 28888 -d synth
"""

from __future__ import annotations

import socket
import socketserver
import threading
import traceback
from typing import Optional

from grbaz_tpu_torch.net.devices import Device, create_device
from grbaz_tpu_torch.net.udp import DEFAULT_PAYLOAD, UDPSampleSender

DEFAULT_PORT = 28888  # reference default (borip_server.py:274)


def _format_error(e: str, pad: bool = True) -> str:
    if not e:
        return ""
    e = e.replace("\\", "\\\\").replace("\r", "\\r").replace("\n", "\\n")
    return (" " + e) if pad else e


def _format_device(device: Optional[Device], payload_size: int) -> str:
    if device is None:
        return "-"
    gr = device.gain_range()
    return "%s|%f|%f|%f|%f|%d|%s|%s|%s|%s" % (
        device.name(), gr.start, gr.stop, gr.step, device.master_clock(),
        payload_size // 2 // 2,
        ",".join(device.antennas()), device.serial(),
        ",".join(device.clock_sources()), ",".join(device.time_sources()))


class _Streamer(threading.Thread):
    """Pulls samples from the device and pushes BorIP UDP packets."""

    def __init__(self, device: Device, sender: UDPSampleSender,
                 chunk: int = 4096):
        super().__init__(daemon=True)
        self.device = device
        self.sender = sender
        self.chunk = chunk
        # NB: name must not shadow threading.Thread._stop (join() calls it)
        self._stop_ev = threading.Event()

    def run(self):
        while not self._stop_ev.is_set():
            x = self.device.read_samples(self.chunk)
            if x is None or len(x) == 0:
                continue
            try:
                self.sender.send_complex(x)
            except OSError:
                break

    def stop(self):
        self._stop_ev.set()


class BorIPHandler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        self.device: Optional[Device] = None
        self.streamer: Optional[_Streamer] = None
        self.sender = UDPSampleSender(bor=True,
                                      payload_size=self.server.payload_size)
        self.header_on = True
        srv = self.server
        if srv.default_device_hint is not None:
            try:
                self.device = create_device(srv.default_device_hint)
                self.sender.connect(self.client_address[0], DEFAULT_PORT)
            except Exception:
                traceback.print_exc()
        # banner (reference sends DEVICE line on connect, :913)
        self._send("DEVICE " + _format_device(self.device,
                                              srv.payload_size))

    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                break
            try:
                cmd = line.decode("utf-8", "replace").strip()
            except Exception:
                continue
            if not cmd:
                continue
            if not self.process(cmd):
                break

    def finish(self):
        self._teardown()
        super().finish()

    def _teardown(self):
        if self.streamer:
            self.streamer.stop()
            # join before closing the sender: the streamer may be inside a
            # native send on the sender's engine (use-after-free otherwise)
            self.streamer.join(timeout=3.0)
            self.streamer = None
        if self.device:
            try:
                self.sender.end_stream()
            except Exception:
                pass
            self.device.close()
            self.device = None
        self.sender.close()

    def _send(self, text: str) -> bool:
        try:
            self.wfile.write((text + "\n").encode())
            return True
        except OSError:
            return False

    # -- verb dispatch -------------------------------------------------------
    def process(self, command: str) -> bool:
        data = None
        if " " in command:
            command, data = command.split(" ", 1)
            data = data.strip()
        command = command.upper()
        result = "OK"
        dev = self.device
        try:
            if command == "PING":
                result = "PONG" if dev is None or not dev.is_running() \
                    else "PONG RUNNING"
            elif command == "GO":
                if dev:
                    if dev.is_running():
                        result += " RUNNING"
                    else:
                        if dev.start():
                            self.streamer = _Streamer(dev, self.sender)
                            self.streamer.start()
                        else:
                            result = "FAIL" + _format_error(dev.last_error())
                else:
                    result = "DEVICE"
            elif command == "STOP":
                if dev:
                    if dev.is_running():
                        result += " STOPPED"
                    if self.streamer:
                        self.streamer.stop()
                        self.streamer.join(timeout=3.0)
                        self.streamer = None
                    dev.stop()
                else:
                    result = "DEVICE"
            elif command == "DEVICE":
                error = ""
                if not self.server.lock and data:
                    if self.streamer:
                        self.streamer.stop()
                        self.streamer.join(timeout=3.0)
                        self.streamer = None
                    if self.device:
                        self.device.close()
                        self.device = None
                    if data != "!":
                        try:
                            self.device = create_device(data)
                            self.sender.connect(self.client_address[0],
                                                DEFAULT_PORT)
                        except Exception as e:
                            traceback.print_exc()
                            error = str(e)
                result = _format_device(self.device,
                                        self.server.payload_size) \
                    + _format_error(error)
            elif command == "FREQ":
                if dev:
                    if data is None:
                        result = str(dev.freq())
                    else:
                        try:
                            f = float(data)
                        except ValueError:
                            f = 0.0
                        if dev.freq(f):
                            s = dev.was_tune_successful()
                            result = "LOW" if s < 0 else \
                                ("HIGH" if s > 0 else "OK")
                            tr = dev.last_tune_result()
                            result += " %f %f %f %f" % (
                                tr.target_rf_freq, tr.actual_rf_freq,
                                tr.target_dsp_freq, tr.actual_dsp_freq)
                        else:
                            result = "FAIL" + _format_error(dev.last_error())
                else:
                    result = "DEVICE"
            elif command == "ANTENNA":
                if dev:
                    if data is None:
                        result = str(dev.antenna()) or "UNKNOWN"
                    elif not dev.antenna(data):
                        result = "FAIL" + _format_error(dev.last_error())
                else:
                    result = "DEVICE"
            elif command == "GAIN":
                if dev:
                    if data is None:
                        result = str(dev.gain())
                    else:
                        try:
                            g = float(data)
                        except ValueError:
                            g = 0.0
                        if not dev.gain(g):
                            result = "FAIL" + _format_error(dev.last_error())
                else:
                    result = "DEVICE"
            elif command == "RATE":
                if dev:
                    if data is None:
                        result = str(dev.sample_rate())
                    else:
                        try:
                            r = float(data)
                        except ValueError:
                            r = 0.0
                        if dev.sample_rate(r):
                            result += " " + str(dev.sample_rate())
                        else:
                            result = "FAIL" + _format_error(dev.last_error())
                else:
                    result = "DEVICE"
            elif command == "CLOCK_SRC":
                if dev:
                    result = dev.clock_source() if data is None else \
                        (dev.clock_source(data) and "OK" or "OK")
                else:
                    result = "DEVICE"
            elif command == "TIME_SRC":
                if dev:
                    result = dev.time_source() if data is None else "OK"
                    if data is not None:
                        dev.time_source(data)
                else:
                    result = "DEVICE"
            elif command == "DEST":
                if data is None:
                    result = "%s:%d" % (self.client_address[0], DEFAULT_PORT)
                else:
                    host, port = data, DEFAULT_PORT
                    if data == "-":
                        host = self.client_address[0]
                    elif ":" in data:
                        host, p = data.rsplit(":", 1)
                        port = int(p)
                        if host == "-":
                            host = self.client_address[0]
                    try:
                        self.sender.connect(host, port)
                        result += " %s:%d" % (host, port)
                    except OSError:
                        result = "FAIL Failed to set destination"
            elif command == "HEADER":
                if data is None:
                    result = "ON" if self.header_on else "OFF"
                else:
                    self.header_on = data.upper() != "OFF"
            else:
                result = "UNKNOWN"
        except Exception as e:
            result = ("-" if command == "DEVICE" else "FAIL") + " " + str(e)
            traceback.print_exc()
        if not result:
            return True
        return self._send(command + " " + result)


class BorIPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def handle_error(self, request, client_address):
        # abrupt client disconnects are normal (reference tears the
        # flowgraph down per client); don't spam tracebacks for them
        import sys
        exc = sys.exception()
        if isinstance(exc, (ConnectionError, BrokenPipeError, OSError)):
            return
        super().handle_error(request, client_address)

    def __init__(self, address=("0.0.0.0", DEFAULT_PORT),
                 default_device: Optional[str] = None, lock: bool = False,
                 payload_size: int = DEFAULT_PAYLOAD):
        self.default_device_hint = default_device
        self.lock = lock
        self.payload_size = payload_size
        super().__init__(address, BorIPHandler)

    @property
    def port(self):
        return self.server_address[1]


def serve(port: int = DEFAULT_PORT, default_device: Optional[str] = None,
          background: bool = True) -> BorIPServer:
    srv = BorIPServer(("0.0.0.0", port), default_device=default_device)
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    else:
        srv.serve_forever()
    return srv


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="BorIP remote-SDR server")
    ap.add_argument("-p", "--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("-d", "--device", default=None,
                    help="default device hint (e.g. 'synth')")
    args = ap.parse_args()
    print(f"BorIP server on :{args.port}")
    serve(args.port, args.device, background=False)
