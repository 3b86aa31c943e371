"""RTL2832-class SDR source — Python face of the native driver stack.

The equivalent of ``baz_rtl_source_c``
(the reference's lib/baz_rtl_source_c.h:68-243): wraps the native demod
driver (grbaz_tpu_torch/native/rtlsdr_core.cc — capture thread + ring buffer
+ tuner probe/factory) and exposes the reference's control surface:
sample_rate / frequency / gain / gain_mode / relative gain / gain range
/ ppm correction, buffer-level and overflow counters, and u8->complex64
sample conversion. Implements the :class:`grbaz_tpu_torch.net.devices.Device`
interface so it plugs straight into the BorIP server and executors.

Transports: ``sim`` (register-accurate behavioral model), ``file``
(u8-IQ capture replay), and ``usb`` (real dongles over a runtime-loaded
libusb-1.0 — the reference's deployment transport,
the reference's lib/rtl2832.cc:563-700; compiles and unit-tests without
the library or hardware present). ``sim`` remains the test default in
this environment (no USB hardware attached).

The port's copy of ``grbaz_tpu/io/rtl_source.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from grbaz_tpu_torch.net.devices import Device, GainRange, DEVICE_REGISTRY


def _load():
    """The driver library (built from ``native/rtlsdr_core.cc`` with its
    tuner tables and programs into ``_build/``), its signatures set."""
    from grbaz_tpu_torch import native
    return native.load_rtlsdr_core()


def wire_log(lib, handle):
    """Read the control-transfer wire log as a list of
    (out, wValue, wIndex, len, d0, d1) tuples."""
    c = ctypes
    out = []
    o, v, i = c.c_uint8(), c.c_uint16(), c.c_uint16()
    ln, d0, d1 = c.c_uint8(), c.c_uint8(), c.c_uint8()
    for k in range(lib.rtl_wire_log_count(handle)):
        lib.rtl_wire_log_get(handle, k, c.byref(o), c.byref(v), c.byref(i),
                             c.byref(ln), c.byref(d0), c.byref(d1))
        out.append((o.value, v.value, i.value, ln.value, d0.value, d1.value))
    return out


TUNER_IDS = {"e4000": 0, "r820t": 1, "e4k": 2, "fc0012": 3,
             "fc0013": 4, "fc2580": 5}


class RTLSource(Device):
    """RTL2832-class device (sim or file transport)."""

    def __init__(self, transport: str = "sim", path: str = "",
                 tuner: str = "r820t", tone_offset: float = 25e3,
                 amplitude: float = 0.6, noise: float = 0.02,
                 rate: float = 2.048e6, seed: int = 1,
                 vid: int = 0, pid: int = 0):
        super().__init__()
        self._lib = _load()
        tid = TUNER_IDS[tuner] if tuner else -1
        if transport == "sim":
            if vid or pid:
                # USB-identity open: the device table supplies the
                # product name + tuner hint (reference find_device,
                # lib/rtl2832.cc:353-416)
                self._h = self._lib.rtl_open_sim_dev(
                    vid, pid, tone_offset, amplitude, noise, seed, tid)
            else:
                self._h = self._lib.rtl_open_sim(tone_offset, amplitude,
                                                 noise, seed, tid)
        elif transport == "file":
            self._h = self._lib.rtl_open_file(path.encode(), tid)
        elif transport == "usb":
            # real hardware: default to the ezcap EzTV identity when no
            # VID/PID given (the reference's most common dongle)
            self._h = self._lib.rtl_open_usb(vid or 0x0bda, pid or 0x2838,
                                             tid)
            if not self._h:
                raise OSError("USB open failed: %s" %
                              self._lib.rtl_usb_last_error().decode())
        else:
            raise ValueError(f"unknown transport {transport}")
        if not self._h:
            raise OSError("failed to open RTL device")
        self._lib.rtl_set_sample_rate(self._hh, rate)
        self._rate = self._lib.rtl_get_sample_rate(self._hh)

    def product_name(self) -> str:
        """USB product identity from the VID/PID device table."""
        return self._lib.rtl_product_name(self._hh).decode()

    @property
    def _hh(self):
        if not self._h:
            raise RuntimeError("RTLSource is closed")
        return self._h

    # -- Device interface -----------------------------------------------------
    def name(self) -> str:
        # "Found RTL2832 device: %s (tuner: %s)" identity shape
        # (lib/rtl2832.cc:548); product resolves from the VID/PID table
        prod = self.product_name()
        if prod and not prod.startswith("("):
            return "%s (%s)" % (prod, self.tuner_name())
        return "RTL2832 (%s)" % self.tuner_name()

    def serial(self) -> str:
        return "RTL0001"

    def master_clock(self) -> float:
        return 28.8e6

    def tuner_name(self) -> str:
        return self._lib.rtl_tuner_name(self._hh).decode()

    def gain_range(self) -> GainRange:
        a = ctypes.c_double()
        b = ctypes.c_double()
        s = ctypes.c_double()
        self._lib.rtl_gain_range(self._hh, ctypes.byref(a), ctypes.byref(b),
                                 ctypes.byref(s))
        return GainRange(a.value, b.value, s.value)

    def antennas(self) -> List[str]:
        return ["RX"]

    def sample_rate(self, r: Optional[float] = None):
        if r is None:
            return self._lib.rtl_get_sample_rate(self._hh)
        if self._lib.rtl_set_sample_rate(self._hh, float(r)) != 0:
            self._last_error = f"rate {r} outside 900001..3200000"
            return False
        self._rate = self._lib.rtl_get_sample_rate(self._hh)
        return True

    def freq(self, f: Optional[float] = None):
        if f is None:
            return self._lib.rtl_get_frequency(self._hh)
        ok = self._lib.rtl_set_frequency(self._hh, float(f)) == 0
        if not ok:
            self._last_error = "tune failed"
        return ok

    def gain(self, g: Optional[float] = None):
        if g is None:
            return self._lib.rtl_get_gain(self._hh)
        ok = self._lib.rtl_set_gain(self._hh, float(g)) == 0
        if not ok:
            self._last_error = "gain set rejected (auto mode?)"
        return ok

    def set_gain_mode(self, manual: bool) -> bool:
        return self._lib.rtl_set_gain_mode(self._hh, 1 if manual else 0) == 0

    def set_relative_gain(self, fraction: float) -> bool:
        """Reference's relative-gain helper: 0..1 across the range."""
        r = self.gain_range()
        return self.gain(r.start + (r.stop - r.start)
                         * min(max(fraction, 0.0), 1.0))

    def set_ppm(self, ppm: float):
        self._lib.rtl_set_ppm(self._hh, float(ppm))

    def start(self) -> bool:
        self._running = True
        return self._lib.rtl_start(self._hh, 1 << 22) == 0

    def stop(self):
        self._running = False
        if getattr(self, "_h", None):
            self._lib.rtl_stop(self._hh)

    def read_samples(self, n: int) -> np.ndarray:
        buf = (ctypes.c_uint8 * (2 * n))()
        got = self._lib.rtl_read(self._hh, buf, 2 * n, 500)
        raw = np.frombuffer(buf, np.uint8, count=max(got, 0))
        raw = raw[: (len(raw) // 2) * 2]
        f = (raw.astype(np.float32) - 127.5) / 127.5
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def stats(self) -> dict:
        s = ctypes.c_uint64()
        o = ctypes.c_uint64()
        p = ctypes.c_uint64()
        lvl = ctypes.c_double()
        self._lib.rtl_stats(self._hh, ctypes.byref(s), ctypes.byref(o),
                            ctypes.byref(p), ctypes.byref(lvl))
        return dict(samples_received=s.value, overflows=o.value,
                    read_packet_count=p.value, buffer_level=lvl.value)

    def i2c_log(self, clear: bool = False):
        """Tuner I2C register-write log: list of (reg, value) pairs.

        The register-fidelity assertion surface: the r820t/e4000 drivers
        are data-driven register programs (native/tuner_programs.inc),
        and this log is every write they emitted since the last clear.
        """
        n = self._lib.rtl_i2c_log_count(self._hh)
        reg = ctypes.c_uint8()
        val = ctypes.c_uint8()
        out = []
        for i in range(n):
            if self._lib.rtl_i2c_log_get(self._hh, i, ctypes.byref(reg),
                                         ctypes.byref(val)) == 0:
                out.append((reg.value, val.value))
        if clear:
            self._lib.rtl_i2c_log_clear(self._hh)
        return out

    def actual_lo(self) -> float:
        """Exact synthesized LO frequency (Hz) from the PLL registers."""
        return float(self._lib.rtl_actual_lo(self._hh))

    def close(self):
        self.stop()
        if getattr(self, "_h", None):
            self._lib.rtl_close(self._hh)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# register with the BorIP DEVICE hint resolver ("DEVICE rtl ...")
DEVICE_REGISTRY["rtl"] = RTLSource
DEVICE_REGISTRY["rtl_sdr"] = RTLSource
