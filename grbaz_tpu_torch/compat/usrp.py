"""Legacy ``usrp.*`` API shim (python/usrp.py:21-362 + python/usrp/).

The reference re-implements the pre-UHD USRP Python API on top of UHD
so ancient apps run unmodified; this module re-implements the same API
surface on top of *this framework's* Device layer (net/devices.py — a
synthetic, file, RTL or BorIP-remote device), so apps written against
the legacy idiom (``source_c``, ``set_decim_rate``, ``u.tune(0, subdev,
f)``, ``subdev.set_gain``) keep working.

Legacy conventions preserved: a 64 MHz ADC clock (python/borip.py:117)
with sample rate = adc_freq / decim_rate, tune results split into
baseband / DDC / residual components, and subdevice objects owning
gain/antenna state.

The port's copy of ``grbaz_tpu/compat/usrp.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from grbaz_tpu_torch.net.devices import Device, SyntheticDevice

ADC_FREQ = 64e6  # legacy USRP1 ADC clock assumed by old apps


def _default_device() -> Device:
    """Device used when a legacy app constructs ``source_c()`` bare.

    Mirrors the reference's transparent remote fallback: borip.py
    monkey-patches ``usrp.source_c`` so that when a ``[borip] server``
    is configured, the 'local USRP' is silently a remote BorIP device
    (python/borip.py:561-573). Without a configured server the
    synthetic device stands in (this environment has no USRP hardware).
    """
    from grbaz_tpu_torch.core.config import BorIPConfig, load_config
    try:
        cfg = load_config(BorIPConfig, "borip")
    except Exception:
        cfg = None
    if cfg is not None and cfg.server:
        # a configured server must NOT silently degrade to synthetic
        # data — propagate connection errors to the caller
        from grbaz_tpu_torch.net.devices import BorIPRemoteDevice
        return BorIPRemoteDevice(cfg.server)
    return SyntheticDevice()


class tune_result:
    def __init__(self, baseband_freq=0.0, dxc_freq=0.0, residual_freq=0.0,
                 inverted=False):
        self.baseband_freq = baseband_freq
        self.dxc_freq = dxc_freq
        self.residual_freq = residual_freq
        self.inverted = inverted

    def __str__(self):
        return ("baseband=%f dxc=%f residual=%f inverted=%s"
                % (self.baseband_freq, self.dxc_freq, self.residual_freq,
                   self.inverted))


class subdevice:
    """A legacy daughterboard subdevice view over the Device gains."""

    def __init__(self, dev: Device, side: str = "A"):
        self._dev = dev
        self.side = side

    def name(self) -> str:
        return self._dev.name()

    def dbid(self) -> int:
        return 0x000F  # generic

    def gain_range(self):
        r = self._dev.gain_range()
        return (r.start, r.stop, r.step)

    def set_gain(self, g: float) -> bool:
        return bool(self._dev.gain(g))

    def gain(self) -> float:
        return float(self._dev.gain())

    def set_auto_tr(self, enable: bool) -> bool:
        return True

    def select_rx_antenna(self, antenna: str) -> bool:
        return bool(self._dev.antenna(antenna))

    def freq_range(self):
        return (0.0, 2.2e9, 1.0)


def pick_subdev(u, candidates=()):
    return (0, 0)


def pick_rx_subdevice(u):
    return (0, 0)


def determine_rx_mux_value(u, subdev_spec, subdev_spec_b=None):
    return 0x10


def selected_subdev(u, subdev_spec):
    return u.selected_subdev(subdev_spec)


def tune(u, unit, subdev, freq):
    return u.tune(unit, subdev, freq)


class source_c:
    """Legacy complex source: wraps any framework Device.

    ``decim_rate`` maps onto the device sample rate as adc_freq/decim
    (the legacy rate model); ``tune`` produces the legacy split tune
    result where the DDC offset is the part the front-end could not
    reach (here: the PLL residual).
    """

    def __init__(self, which: int = 0, decim_rate: int = 256,
                 nchan: int = 1, adc_freq: float = ADC_FREQ,
                 device: Optional[Device] = None):
        self._dev = device if device is not None else _default_device()
        self._adc_freq = float(adc_freq)
        self._decim = max(int(decim_rate), 1)
        self._apply_rate()
        self._subdevs = [subdevice(self._dev, "A"),
                         subdevice(self._dev, "B")]
        self._last_tune: Optional[tune_result] = None

    # -- rate model -----------------------------------------------------------
    def _apply_rate(self):
        self._dev.sample_rate(self._adc_freq / self._decim)

    def adc_freq(self) -> float:
        return self._adc_freq

    def adc_rate(self) -> float:
        return self._adc_freq

    def decim_rate(self) -> int:
        return self._decim

    def set_decim_rate(self, decim: int) -> bool:
        self._decim = max(int(decim), 1)
        self._apply_rate()
        return True

    def converter_rate(self) -> float:
        return self._adc_freq

    # -- tuning ---------------------------------------------------------------
    def tune(self, unit, subdev, freq: float) -> Optional[tune_result]:
        if not self._dev.freq(freq):
            return None
        actual = self._dev.freq()
        tr = tune_result(baseband_freq=actual,
                         dxc_freq=freq - actual,
                         residual_freq=actual - freq)
        self._last_tune = tr
        return tr

    def set_rx_freq(self, channel: int, freq: float) -> bool:
        return self.tune(channel, None, freq) is not None

    def rx_freq(self, channel: int = 0) -> float:
        return float(self._dev.freq())

    # -- mux / subdev glue ------------------------------------------------------
    def set_mux(self, mux: int) -> bool:
        return True

    def pick_rx_subdevice(self):
        return (0, 0)

    def determine_rx_mux_value(self, subdev_spec, subdev_spec_b=None):
        return 0x10

    def selected_subdev(self, subdev_spec) -> subdevice:
        side = 0 if not subdev_spec else int(subdev_spec[0])
        return self._subdevs[side % len(self._subdevs)]

    # -- gain / misc legacy accessors -------------------------------------------
    def set_pga(self, which: int, gain: float) -> bool:
        return bool(self._dev.gain(gain))

    def pga(self, which: int = 0) -> float:
        return float(self._dev.gain())

    def pga_min(self) -> float:
        return self._dev.gain_range().start

    def pga_max(self) -> float:
        return self._dev.gain_range().stop

    def serial_number(self) -> str:
        return self._dev.serial()

    def name(self) -> str:
        return self._dev.name()

    def db(self, side: int, which: int = 0) -> List[subdevice]:
        return [self._subdevs[side % len(self._subdevs)]]

    # -- streaming ---------------------------------------------------------------
    def start(self) -> bool:
        return self._dev.start()

    def stop(self):
        self._dev.stop()

    def read_samples(self, n: int) -> np.ndarray:
        return self._dev.read_samples(n)

    def close(self):
        self._dev.close()


# ---------------------------------------------------------------------------
# simple_usrp / dual_usrp convenience layer
# (python/usrp/simple_usrp.py:27-70, python/usrp/dual_usrp.py:27-76,
#  python/usrp/common.py:27-55): one- and two-daughterboard views with
# set_decim_rate / set_frequency[_a/_b] / set_gain[_a/_b] idioms.
# ---------------------------------------------------------------------------

class simple_source_c:
    """Single-subdevice view (python/usrp/simple_usrp.py:27-70)."""

    def __init__(self, which: int = 0, side: str = "A", rx_ant: str = "RXA",
                 no_hb: bool = False, device: Optional[Device] = None):
        self._u = source_c(which, device=device)
        self._side = 0 if side.upper() == "A" else 1
        self._subdev = self._u.db(self._side)[0]
        self._subdev.select_rx_antenna(rx_ant)
        self._no_hb = no_hb

    def _get_u(self):
        return self._u

    def get_decim_rates(self):
        # halfband-less mode restricts to multiples of 4 (reference :40-43)
        step = 4 if self._no_hb else 2
        return list(range(step, 257, step))

    def set_decim_rate(self, decim: int):
        return self._u.set_decim_rate(int(decim))

    def set_frequency(self, frequency: float, verbose: bool = False,
                      lo_offset=None):
        tr = self._u.tune(0, self._subdev, float(frequency))
        return tr is not None

    def set_gain(self, gain: float):
        return self._subdev.set_gain(gain)

    def set_enable(self, enable: bool):
        return True

    def set_auto_tr(self, auto_tr: bool):
        return self._subdev.set_auto_tr(auto_tr)

    def start(self):
        return self._u.start()

    def stop(self):
        self._u.stop()

    def read_samples(self, n: int) -> np.ndarray:
        return self._u.read_samples(n)


class dual_source_c:
    """Two-subdevice (A+B) view (python/usrp/dual_usrp.py:27-76).

    Each side owns its own frequency/gain; samples interleave as two
    channels — here exposed as a [n, 2] complex array (channel-major
    idiom of the multi-channel ingest path).
    """

    def __init__(self, which: int = 0, rx_ant_a: str = "RXA",
                 rx_ant_b: str = "RXA", rx_source_a: str = "A",
                 rx_source_b: str = "B",
                 device_a: Optional[Device] = None,
                 device_b: Optional[Device] = None):
        self._ua = source_c(which, device=device_a)
        self._ub = source_c(which, device=device_b)
        self._subdev_a = self._ua.db(0)[0]
        self._subdev_b = self._ub.db(1)[0]
        self._subdev_a.select_rx_antenna(rx_ant_a)
        self._subdev_b.select_rx_antenna(rx_ant_b)

    def _get_u(self):
        return self._ua

    def set_decim_rate(self, decim: int):
        ok = self._ua.set_decim_rate(int(decim))
        return self._ub.set_decim_rate(int(decim)) and ok

    def set_frequency_a(self, frequency: float, verbose: bool = False,
                        lo_offset=None):
        return self._ua.tune(0, self._subdev_a, float(frequency)) is not None

    def set_frequency_b(self, frequency: float, verbose: bool = False,
                        lo_offset=None):
        return self._ub.tune(0, self._subdev_b, float(frequency)) is not None

    def set_gain_a(self, gain: float):
        return self._subdev_a.set_gain(gain)

    def set_gain_b(self, gain: float):
        return self._subdev_b.set_gain(gain)

    def start(self):
        return self._ua.start() and self._ub.start()

    def stop(self):
        self._ua.stop()
        self._ub.stop()

    def read_samples(self, n: int) -> np.ndarray:
        a = self._ua.read_samples(n)
        b = self._ub.read_samples(n)
        m = min(len(a), len(b))
        return np.stack([a[:m], b[:m]], axis=1)


# Daughterboard IDs used by legacy apps (python/usrpm/usrp_dbid.py —
# generated constants; the handful old flowgraphs actually test for):
class usrp_dbid:
    BASIC_TX = 0x0000
    BASIC_RX = 0x0001
    DBS_RX = 0x0002
    TV_RX = 0x0003
    FLEX_400_RX = 0x0004
    FLEX_900_RX = 0x0005
    FLEX_1200_RX = 0x0006
    FLEX_2400_RX = 0x0007
    TV_RX_REV_2 = 0x000a
    DTT754 = 0x000b
    DTT768 = 0x000d
    TV_RX_REV_3 = 0x000e
    FLEX_1800_RX = 0x0030
    LF_RX = 0x000f
