"""The port's compat shims and small utilities (``grbaz_tpu_torch/
compat/{baudline,horizons,usrp}.py``, ``utils/{debug,lut,
missile_launcher,run_remote,term}.py``, ``viz/flipper.py``) pass the JAX
package's tests, and agree with the JAX modules.

Each test of the first sections repeats one of ``tests/
test_viz_compat.py`` (the print-char sink, the baudline bridge, the
doppler tracker, the legacy USRP shim), ``tests/test_mux_misc_compat.py``
(the simple and dual USRP shims, the LUTs, the missile launcher, the
view flipper) and ``tests/test_utils_misc.py`` (colours, the flusher,
run_remote) on the port's copies. The last holds the copies to the JAX
modules: LUTs, their C source and the u8 conversion equal, and the
launcher's command stream equal.
"""

import io
import os
import threading

import numpy as np
import pytest

from grbaz_tpu_torch.utils.lut import (char_to_float_lut, char_to_short_lut,
                                       convert_u8_iq, lut_c_source)
from grbaz_tpu_torch.utils.missile_launcher import (CMD_FIRE, CMD_LEFT,
                                                    CMD_RIGHT, CMD_STOP,
                                                    MissileLauncher)
from grbaz_tpu_torch.viz.flipper import ViewFlipper


# -------------------------------------------------------------------------
# tests/test_viz_compat.py on the port's copies
# -------------------------------------------------------------------------

def test_print_char_bursts():
    from grbaz_tpu_torch.utils.debug import PrintChar
    out = io.StringIO()
    pc = PrintChar(threshold=0.5, out=out)
    data = np.array([0xAB, 0xCD, 0x12, 0x34], np.uint8)
    level = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    pc.process(data, level)
    txt = out.getvalue()
    assert "ABCD" in txt and "[2 symbols]" in txt and "12" not in txt
    assert "34" in txt


def test_print_char_file_tee(tmp_path):
    from grbaz_tpu_torch.utils.debug import PrintChar
    f = tmp_path / "tee.txt"
    pc = PrintChar(threshold=0.0, file=str(f), out=io.StringIO())
    pc.process(np.array([1, 2, 255], np.uint8))
    pc.close()
    assert f.read_text() == "0102FF"


def test_baudline_fifo_bridge(tmp_path):
    from grbaz_tpu_torch.compat.baudline import BaudlineSink
    bl = BaudlineSink(sample_rate=48000, is_complex=True, fmt="le16",
                      mode="fifo", spawn=False)
    try:
        assert os.path.exists(bl.fifo_path)
        assert "-samplerate 48000" in bl.command
        assert "-quadrature" in bl.command
        got = {}

        def reader():
            with open(bl.fifo_path, "rb") as f:
                got["data"] = f.read(16)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        x = np.array([1.0 + 0j, 0 - 1.0j, 0.5 + 0.25j, 0], np.complex64)
        bl.write(x)
        bl.close()
        t.join(timeout=5)
        wire = np.frombuffer(got["data"], "<i2")
        assert wire[0] == 32767 and wire[3] == -32767
        assert wire[4] == pytest.approx(16384, abs=1)
    finally:
        bl.close()


def test_doppler_tracker():
    from grbaz_tpu_torch.compat.horizons import C_M_S, DopplerTracker

    class Dev:
        def __init__(self):
            self.tuned = []

        def freq(self, f=None):
            if f is None:
                return self.tuned[-1]
            self.tuned.append(f)
            return True

    dev = Dev()
    # receding at 7 km/s -> downshift
    trk = DopplerTracker(lambda t: 7000.0, dev, base_freq=437e6,
                         now=lambda: 0.0)
    tuned = trk.step()
    expect = 437e6 * (1 - 7000.0 / C_M_S)
    assert tuned == pytest.approx(expect)
    assert trk.get()["range_rate"] == 7000.0
    trk.set_freq(145.8e6)
    assert dev.tuned[-1] == pytest.approx(145.8e6 * (1 - 7000.0 / C_M_S))


def test_usrp_legacy_shim():
    from grbaz_tpu_torch.compat.usrp import ADC_FREQ, source_c
    from grbaz_tpu_torch.net.devices import SyntheticDevice

    u = source_c(decim_rate=256, device=SyntheticDevice())
    assert u.adc_freq() == ADC_FREQ
    # decim model: rate = adc/decim
    assert u._dev.sample_rate() == pytest.approx(ADC_FREQ / 256)
    u.set_decim_rate(64)
    assert u._dev.sample_rate() == pytest.approx(ADC_FREQ / 64)
    sub = u.selected_subdev((0, 0))
    lo, hi, step = sub.gain_range()
    assert sub.set_gain(0.5 * (lo + hi))
    tr = u.tune(0, sub, 10.7e6)
    assert tr is not None and tr.baseband_freq == pytest.approx(10.7e6, rel=1e-3)
    u.start()
    x = u.read_samples(1024)
    assert len(x) == 1024 and x.dtype == np.complex64
    u.stop()
    u.close()



# -------------------------------------------------------------------------
# tests/test_mux_misc_compat.py:173-238 on the port's copies
# -------------------------------------------------------------------------

def test_simple_and_dual_usrp_shims():
    from grbaz_tpu_torch.compat.usrp import (dual_source_c, simple_source_c,
                                       usrp_dbid)
    s = simple_source_c(decim_rate=64) if False else simple_source_c()
    assert s.set_decim_rate(64)
    assert s.set_frequency(1e6)
    assert s.set_gain(10.0)
    assert 4 in s.get_decim_rates()
    d = dual_source_c()
    assert d.set_decim_rate(128)
    assert d.set_frequency_a(1e6) and d.set_frequency_b(2e6)
    d.start()
    x = d.read_samples(64)
    assert x.shape == (64, 2) and x.dtype == np.complex64
    d.stop()
    assert usrp_dbid.TV_RX == 0x0003


def test_char_luts_match_reference_formula():
    f = char_to_float_lut()
    assert f[128] == 0.0 and f[0] == -1.0
    np.testing.assert_allclose(f[255], (255 - 128) / 128.0)
    s = char_to_short_lut()
    assert s[128] == 0 and s[0] == -32768
    src = lut_c_source(f)
    assert src.startswith("{ -1.0") and src.endswith("};")
    assert src.count(",") == 255


def test_convert_u8_iq_roundtrip():
    raw = np.array([128, 128, 255, 0], np.uint8)  # (0+0j), (~1 - 1j)
    z = convert_u8_iq(raw)
    np.testing.assert_allclose(z, [0.0 + 0.0j, (127 / 128) - 1.0j])


def test_missile_launcher_pointing_and_protocol():
    ml = MissileLauncher()
    ml.set_azimuth(27.0)
    assert ml.sent[0][0] == CMD_RIGHT and ml.sent[1][0] == CMD_STOP
    np.testing.assert_allclose(ml.sent[0][1], 27.0 / 270.0 * 5.5)
    ml.set_azimuth(-27.0)
    assert ml.sent[2][0] == CMD_LEFT
    ml.point_at_doa(90.0)  # broadside -> azimuth 0
    assert ml.azimuth == 0.0
    assert ml.launch() and ml.sent[-1][0] == CMD_FIRE
    ml.set_azimuth(500.0)  # clamps to +135
    assert ml.azimuth == 135.0


def test_view_flipper_ticks():
    hits = []
    fl = ViewFlipper(lambda: hits.append(1), interval=None)
    assert not fl.timer_running
    fl.tick()
    fl.tick()
    assert len(hits) == 2 and fl.flips == 2
    fl.start_timer(0.02)
    assert fl.timer_running
    import time
    time.sleep(0.1)
    fl.stop_timer()
    assert len(hits) >= 3



# -------------------------------------------------------------------------
# tests/test_utils_misc.py:10-52 on the port's copies
# -------------------------------------------------------------------------

def test_colourise():
    from grbaz_tpu_torch.utils.term import colourise, colours
    s = colourise("hi", "red", "bold")
    assert s.startswith(colours["red"] + colours["bold"])
    assert s.endswith(colours["reset"])
    assert colourise("hi", "red", enable=False) == "hi"


def test_std_flusher():
    from grbaz_tpu_torch.utils.term import StdFlusher
    f = StdFlusher(interval=0.01)
    import time
    time.sleep(0.05)
    f.stop()  # no exceptions = pass; thread must terminate
    assert f._thr is None


def test_run_remote_argv_and_lifecycle():
    from grbaz_tpu_torch.utils.run_remote import RunRemote

    spawned = {}

    class FakeProc:
        def __init__(self, argv):
            spawned["argv"] = argv
            self.terminated = False

        def poll(self):
            return None

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            return 0

    r = RunRemote("radio1", "rtl_fm --synth", user="op", forward_x=True,
                  ssh_args="-o BatchMode=yes", spawn=FakeProc)
    assert spawned["argv"][:4] == ["ssh", "-p", "22", "-X"]
    assert "op@radio1" in spawned["argv"]
    assert spawned["argv"][-1] == "rtl_fm --synth"
    r.stop()


# -------------------------------------------------------------------------
# the port's copies against the JAX modules
# -------------------------------------------------------------------------

def test_luts_and_u8_conversion_equal_jax():
    """The tables, their C source and the u8 conversion, bit for bit.
    (``read_samples`` maps a byte as (b - 127.5) / 127.5, the LUT as
    (b - 128) / 128: each module keeps its own, as in JAX.)"""
    from grbaz_tpu.utils import lut as jlut
    np.testing.assert_array_equal(char_to_float_lut(),
                                  jlut.char_to_float_lut())
    np.testing.assert_array_equal(char_to_short_lut(),
                                  jlut.char_to_short_lut())
    assert lut_c_source(char_to_float_lut()) == \
        jlut.lut_c_source(jlut.char_to_float_lut())
    raw = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8)
    got, want = convert_u8_iq(raw), jlut.convert_u8_iq(raw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_missile_launcher_command_stream_equals_jax():
    from grbaz_tpu.utils.missile_launcher import MissileLauncher as JML
    ml, jml = MissileLauncher(), JML()
    for m in (ml, jml):
        m.set_azimuth(27.0)
        m.set_azimuth(-100.0)
        m.point_at_doa(30.0)
        m.launch()
        m.set_azimuth(500.0)
    assert ml.sent == jml.sent and ml.azimuth == jml.azimuth


def test_missile_launcher_usb_import_is_lazy():
    """pyusb stays an optional import, inside the USB opener."""
    import grbaz_tpu_torch.utils.missile_launcher as m
    src = open(m.__file__).read()
    assert "import usb" not in src.split("def open_usb_launcher")[0]
