"""BorIP device model: the server-side SDR abstraction (port of
``grbaz_tpu/net/devices.py``; host only).

Mirrors the reference's ``Device`` base interface
(the reference's python/borip_server.py:170-271): name, serial,
gain/gain_range, freq + tune result, sample_rate, antennas, clock/time
sources, start/stop, and a ``read_samples`` pull used by the streamer.

The reference's base class is itself a functioning *stub* device (canned
values, accepts all setters) — kept here as :class:`Device`, the test
backend. :class:`SyntheticDevice` generates a tone+noise IQ stream
(the no-hardware capture source); real front-ends (file replay, RTL
capture shim) subclass the same interface.

The RTL driver (``io/rtl_source.py``) is not ported yet: the hints
``rtl`` and ``rtl_sdr`` raise ``ValueError`` rather than open another
device in its place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class GainRange:
    start: float = 0.0
    stop: float = 1.0
    step: float = 1.0


@dataclasses.dataclass
class TuneResult:
    target_rf_freq: float = 0.0
    actual_rf_freq: float = 0.0
    target_dsp_freq: float = 0.0
    actual_dsp_freq: float = 0.0


class Device:
    """Base + stub device (accepts everything, canned metadata)."""

    def __init__(self):
        self._gain = 0.0
        self._freq = 0.0
        self._rate = 250e3
        self._antenna = "(Default)"
        self._clock_src = ""
        self._time_src = ""
        self._running = False
        self._last_error = ""
        self._tune_result = TuneResult()

    # -- metadata -----------------------------------------------------------
    def name(self) -> str:
        return "(no name)"

    def serial(self) -> str:
        return "(no serial)"

    def master_clock(self) -> float:
        return 0.0

    def gain_range(self) -> GainRange:
        return GainRange()

    def antennas(self) -> List[str]:
        return [self._antenna]

    def clock_sources(self) -> List[str]:
        return []

    def time_sources(self) -> List[str]:
        return []

    def last_error(self) -> str:
        return self._last_error

    # -- control ------------------------------------------------------------
    def gain(self, g: Optional[float] = None):
        if g is None:
            return self._gain
        self._gain = float(g)
        return True

    def freq(self, f: Optional[float] = None):
        if f is None:
            return self._freq
        self._freq = float(f)
        self._tune_result = TuneResult(f, f, 0.0, 0.0)
        return True

    def was_tune_successful(self) -> int:
        return 0  # 0 ok, -1 LOW, +1 HIGH

    def last_tune_result(self) -> TuneResult:
        return self._tune_result

    def sample_rate(self, r: Optional[float] = None):
        if r is None:
            return self._rate
        self._rate = float(r)
        return True

    def antenna(self, a: Optional[str] = None):
        if a is None:
            return self._antenna
        self._antenna = a
        return True

    def clock_source(self, s: Optional[str] = None):
        if s is None:
            return self._clock_src
        self._clock_src = s
        return True

    def time_source(self, s: Optional[str] = None):
        if s is None:
            return self._time_src
        self._time_src = s
        return True

    # -- streaming ----------------------------------------------------------
    def start(self) -> bool:
        self._running = True
        return True

    def stop(self):
        self._running = False

    def is_running(self) -> bool:
        return self._running

    def read_samples(self, n: int) -> np.ndarray:
        """Pull n complex64 samples (blocking at the device rate)."""
        time.sleep(n / max(self._rate, 1.0))
        return np.zeros(n, np.complex64)

    def close(self):
        self.stop()


class SyntheticDevice(Device):
    """Tone + noise generator — the hardware-free test/server backend."""

    def __init__(self, tone_offset: float = 10e3, amplitude: float = 0.5,
                 noise: float = 0.01, rate: float = 250e3,
                 realtime: bool = True, seed: int = 0):
        super().__init__()
        self._rate = rate
        self.tone_offset = tone_offset
        self.amplitude = amplitude
        self.noise = noise
        self.realtime = realtime
        self._phase = 0.0
        self._rng = np.random.default_rng(seed)
        self._t_next = None

    def name(self) -> str:
        return "Synthetic"

    def serial(self) -> str:
        return "SYN0001"

    def gain_range(self) -> GainRange:
        return GainRange(0.0, 30.0, 0.5)

    def antennas(self) -> List[str]:
        return ["SYNTH"]

    def read_samples(self, n: int) -> np.ndarray:
        if self.realtime:
            now = time.monotonic()
            if self._t_next is None:
                self._t_next = now
            dt = n / self._rate
            sleep = self._t_next + dt - now
            if sleep > 0:
                time.sleep(sleep)
            self._t_next += dt
        w = 2.0 * np.pi * self.tone_offset / self._rate
        ph = self._phase + w * np.arange(n)
        self._phase = float((self._phase + w * n) % (2 * np.pi))
        x = self.amplitude * np.exp(1j * ph)
        if self.noise:
            x = x + self.noise * (self._rng.standard_normal(n)
                                  + 1j * self._rng.standard_normal(n))
        return x.astype(np.complex64)


class FileDevice(Device):
    """Replays complex64 (or interleaved-i16) raw capture files."""

    def __init__(self, path: str, rate: float = 250e3, fmt: str = "c64",
                 loop: bool = True, realtime: bool = False):
        super().__init__()
        self._rate = rate
        self.fmt = fmt
        self.loop = loop
        self.realtime = realtime
        if fmt == "c64":
            self.data = np.fromfile(path, np.complex64)
        elif fmt == "i16":
            s = np.fromfile(path, np.int16).astype(np.float32) / 32767.0
            self.data = (s[0::2] + 1j * s[1::2]).astype(np.complex64)
        else:
            raise ValueError(f"unknown format {fmt}")
        self.pos = 0
        self._path = path
        self._t_next = None

    def name(self) -> str:
        return "File"

    def serial(self) -> str:
        return self._path

    def read_samples(self, n: int) -> np.ndarray:
        if self.realtime:
            now = time.monotonic()
            if self._t_next is None:
                self._t_next = now
            dt = n / self._rate
            sleep = self._t_next + dt - now
            if sleep > 0:
                time.sleep(sleep)
            self._t_next += dt
        out = np.zeros(n, np.complex64)
        got = 0
        while got < n:
            take = min(n - got, len(self.data) - self.pos)
            if take <= 0:
                if not self.loop:
                    break
                self.pos = 0
                continue
            out[got:got + take] = self.data[self.pos:self.pos + take]
            self.pos += take
            got += take
        return out


# registry for DEVICE <hint> resolution (reference: dynamic import of
# borip_<id>, borip_server.py:664-800; here: a registry + entry-point
# style dotted-path fallback)
class BorIPRemoteDevice(Device):
    """A remote BorIP server presented through the Device interface —
    the reference's transparent remote-SDR substitution
    (python/borip.py:561-573 monkey-patches ``usrp.source_c`` to fall
    back to a BorIP server; here the remote is just another Device).

    ``server``: "host[:port]"; empty reads the ``[borip]`` config
    section. ``hint`` is the server-side device to open (DEVICE verb).
    """

    def __init__(self, server: str = "", hint: str = ""):
        super().__init__()
        from grbaz_tpu_torch.net.borip_client import RemoteDevice
        if server:
            host, _, port = str(server).partition(":")
            if port:
                self._rd = RemoteDevice(host, port=int(port))
            else:
                from grbaz_tpu_torch.core.config import BorIPConfig, load_config
                cfg = load_config(BorIPConfig, "borip")
                self._rd = RemoteDevice(host, port=cfg.default_port)
        else:
            self._rd = RemoteDevice.from_config()
        self._info = self._rd.select_device(hint) if hint \
            else (self._rd.device_info or self._rd.select_device(""))

    def name(self) -> str:
        return (self._info or {}).get("name", "(remote)")

    def serial(self) -> str:
        return (self._info or {}).get("serial", "(no serial)")

    def master_clock(self) -> float:
        return float((self._info or {}).get("master_clock", 0.0))

    def gain_range(self) -> GainRange:
        info = self._info or {}
        return GainRange(float(info.get("gain_min", 0.0)),
                         float(info.get("gain_max", 0.0)),
                         float(info.get("gain_step", 1.0)))

    def antennas(self) -> List[str]:
        return (self._info or {}).get("antennas", ["(Default)"])

    def gain(self, g: Optional[float] = None):
        if g is None:
            return self._gain
        if self._rd.set_gain(float(g)):
            self._gain = float(g)
            return True
        return False

    def freq(self, f: Optional[float] = None):
        if f is None:
            return self._freq
        if self._rd.set_freq(float(f)):
            self._freq = float(f)
            self._tune_result = TuneResult(f, f, 0.0, 0.0)
            return True
        return False

    def sample_rate(self, r: Optional[float] = None):
        if r is None:
            return self._rate
        actual = self._rd.set_sample_rate(float(r))
        if actual == actual:  # not NaN
            self._rate = float(actual)
            return True
        return False

    def antenna(self, a: Optional[str] = None):
        if a is None:
            return self._antenna
        if self._rd.set_antenna(str(a)):
            self._antenna = str(a)
            return True
        return False

    def start(self) -> bool:
        self._running = bool(self._rd.start())
        return self._running

    def stop(self):
        self._rd.stop()
        self._running = False

    def read_samples(self, n: int) -> np.ndarray:
        return self._rd.wait_samples(n)

    def close(self):
        try:
            self._rd.close()
        finally:
            self._running = False


DEVICE_REGISTRY = {
    "": SyntheticDevice,
    "synth": SyntheticDevice,
    "synthetic": SyntheticDevice,
    "file": FileDevice,
    "borip": BorIPRemoteDevice,
    "remote": BorIPRemoteDevice,
}

# hints resolved by importing a module that self-registers (the analog of
# the reference's dynamic `import borip_<id>`, borip_server.py:760-790);
# the RTL driver's module is not ported yet, so these hints raise
_LAZY_PROVIDERS = {
    "rtl": "grbaz_tpu_torch.io.rtl_source",
    "rtl_sdr": "grbaz_tpu_torch.io.rtl_source",
}


def create_device(hint: str) -> Device:
    """hint: 'name' or 'name arg1 arg2=...' (reference's quoting-lite)."""
    parts = (hint or "").split()
    name = parts[0].lower() if parts else ""
    args, kwargs = [], {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            kwargs[k] = _coerce(v)
        else:
            args.append(_coerce(p))
    cls = DEVICE_REGISTRY.get(name)
    if cls is None and name in _LAZY_PROVIDERS:
        import importlib
        try:
            importlib.import_module(_LAZY_PROVIDERS[name])  # self-registers
        except ModuleNotFoundError as e:
            if e.name != _LAZY_PROVIDERS[name]:
                raise
            raise ValueError(
                f"device hint {name!r}: the RTL driver "
                f"({_LAZY_PROVIDERS[name]}) is not yet ported") from None
        cls = DEVICE_REGISTRY.get(name)
    if cls is None:
        # reference-convention plugin: a module named borip_<hint> that
        # self-registers its device class on import
        # (python/borip_server.py:760-790 dynamic import by hint)
        import importlib
        try:
            importlib.import_module(f"borip_{name}")
            cls = DEVICE_REGISTRY.get(name)
        except ImportError:
            pass
    if cls is None:
        # dotted path escape hatch: "pkg.module:ClassName"
        if ":" in name:
            mod, clsname = hint.split()[0].split(":")
            import importlib
            cls = getattr(importlib.import_module(mod), clsname)
        else:
            raise ValueError(f"unknown device hint {name!r}")
    return cls(*args, **kwargs)


def _coerce(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    return v
