"""The port's RTL2832 driver (``grbaz_tpu_torch/io/rtl_source.py`` over
``native/rtlsdr_core.cc`` with its tuner tables and programs) passes the
JAX package's own tests, and agrees with the JAX driver.

The first three sections repeat ``tests/test_rtl_source.py``,
``tests/test_tuner_programs.py`` and ``tests/test_demod_program.py`` on
the port's copy, with the same parametrisations (the sim transport, the
mock I2C and USB logs; no dongle). The last holds the two packages'
drivers to each other on the same sim and file arguments: I2C and wire
logs, the synthesized LO, gain ranges and samples equal; the library
builds into ``_build/`` under a name hashed from every source it reads;
and the u8 capture of ``chip_smoke.rtl_path`` read through the file
transport equals the file's bytes, its audio the Flowgraph's.
"""

import ctypes
import functools
import os
import shutil
import threading
import time

import numpy as np
import pytest

from grbaz_tpu_torch.io.rtl_source import RTLSource, TUNER_IDS, _load, wire_log



# -------------------------------------------------------------------------
# tests/test_rtl_source.py on the port's driver
# -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    d = RTLSource(transport="sim", tuner="r820t", tone_offset=50e3,
                  rate=1.024e6, noise=0.0)
    yield d
    d.close()


def test_tuner_probe_and_metadata(dev):
    assert dev.tuner_name() == "r820t"
    assert "RTL2832" in dev.name()
    assert dev.master_clock() == 28.8e6
    r = dev.gain_range()
    assert r.stop > r.start and r.step > 0


def test_e4000_probe():
    d = RTLSource(transport="sim", tuner="e4000", rate=1.2e6)
    assert d.tuner_name() == "e4000"
    d.close()


def test_all_six_tuner_models_probe_and_tune():
    """Every tuner family from the reference stack must probe + tune.

    Mirrors the 6 drivers at reference lib/rtl2832-tuner_*.cc; the
    same-I2C-address pair (fc0012 id 0xa1 vs fc0013 id 0xa3) must
    disambiguate by identification value.
    """
    from grbaz_tpu_torch.io.rtl_source import TUNER_IDS
    for name in TUNER_IDS:
        d = RTLSource(transport="sim", tuner=name, rate=2.048e6)
        assert d.tuner_name() == name, name
        assert d.freq(300e6)
        # PLL error small; fc2580 rounds to exact kHz by design
        tol = 1000.0 if name != "fc2580" else 0.5
        assert abs(d.freq() - 300e6) < tol, (name, d.freq())
        r = d.gain_range()
        if name == "fc2580":
            # reference fc2580 wrapper has manual gain commented out
            # (rtl2832-tuner_fc2580.cc set_gain body) — AGC-only, empty range
            assert r.stop == r.start == 0.0
        else:
            assert r.stop > r.start
            assert d.set_gain_mode(True)
            assert d.gain(0.5 * (r.start + r.stop))
            assert r.start <= d.gain() <= r.stop
        d.close()


def test_discrete_gain_table_snapping():
    """Fitipower tuners expose discrete gain points; sets snap to them."""
    d = RTLSource(transport="sim", tuner="fc0013", rate=2.048e6)
    d.set_gain_mode(True)
    d.gain(18.0)
    assert d.gain() == pytest.approx(19.1)  # nearest of {-6.3,7.1,19.1,19.7}
    d.gain(-20.0)
    assert d.gain() == pytest.approx(-6.3)
    d.close()
    d = RTLSource(transport="sim", tuner="fc0012", rate=2.048e6)
    d.set_gain_mode(True)
    d.gain(0.6)
    # nearest of the reference's _mapGainsFC0012 {0.0, 0.5, 1.0} dB
    # (rtl2832-tuner_fc0012.cc:205)
    assert d.gain() == pytest.approx(0.5)
    d.close()


def test_sample_rate_programming(dev):
    # exact rational ratio vs the 28.8 MHz crystal: actual differs from
    # requested but stays within the register resolution
    assert dev.sample_rate(2.048e6)
    actual = dev.sample_rate()
    assert abs(actual - 2.048e6) / 2.048e6 < 1e-5
    # range enforcement (lib/rtl2832.cc:59-60)
    assert not dev.sample_rate(100e3)
    assert not dev.sample_rate(5e6)
    assert dev.sample_rate(1.024e6)


def test_tune_and_pll_resolution(dev):
    assert dev.freq(100.0e6)
    got = dev.freq()
    # sigma-delta PLL resolution: well under 1 kHz at 100 MHz
    assert abs(got - 100.0e6) < 1000.0


def test_gain_modes(dev):
    assert dev.set_gain_mode(True)
    assert dev.gain(20.0)
    g = dev.gain()
    r = dev.gain_range()
    assert abs(g - 20.0) <= r.step
    assert dev.set_relative_gain(1.0)
    assert abs(dev.gain() - r.stop) <= r.step
    # auto mode rejects manual sets (reference behavior)
    assert dev.set_gain_mode(False)
    assert not dev.gain(10.0)
    dev.set_gain_mode(True)


def test_capture_tone(dev):
    dev.sample_rate(1.024e6)
    dev.start()
    try:
        out = []
        got = 0
        import time
        t0 = time.monotonic()
        while got < 65536 and time.monotonic() - t0 < 10:
            x = dev.read_samples(16384)
            out.append(x)
            got += len(x)
        x = np.concatenate(out)[:65536]
        assert len(x) == 65536
        spec = np.abs(np.fft.fft(x * np.hanning(len(x))))
        f = np.argmax(spec) / len(x)
        # sim transport synthesizes the tone at +50 kHz
        assert abs(f - 50e3 / 1.024e6) < 1e-3
        st = dev.stats()
        assert st["samples_received"] >= 65536
        assert st["read_packet_count"] > 0
    finally:
        dev.stop()


def test_borip_hint_integration():
    from grbaz_tpu_torch.net.devices import create_device
    d = create_device("rtl transport=sim tuner=e4000 rate=1024000")
    assert d.tuner_name() == "e4000"
    d.close()


def test_usb_transport_compiles_and_fails_gracefully():
    """LibusbTransport builds into the driver stack and the `usb` open
    path reports a readable reason when libusb or the dongle is absent
    (no hardware in this environment — the wire program it would carry
    is the one test_demod_program asserts)."""
    import ctypes
    import pytest
    from grbaz_tpu_torch.io.rtl_source import RTLSource, _load
    lib = _load()
    assert hasattr(lib, "rtl_open_usb")
    avail = lib.rtl_usb_available()
    assert avail in (0, 1)
    with pytest.raises(OSError) as ei:
        RTLSource(transport="usb", vid=0x0bda, pid=0x2838)
    msg = str(ei.value)
    assert "USB open failed" in msg
    if avail:
        # libusb loaded: failure must come from device enumeration
        assert "device" in msg or "claim" in msg
    else:
        assert "libusb" in msg


# -------------------------------------------------------------------------
# tests/test_tuner_programs.py on the port's driver
# -------------------------------------------------------------------------

# -- reference constants transcribed by hand (spot checks) ------------------
# R828_iniArry first/last bytes (rtl2832-tuner_r820t.cc:404, CLK_OUT=TRUE)
R820T_INIT_FIRST = 0x83   # reg 0x05
R820T_INIT_LAST = 0xC0    # reg 0x1F
R820T_IF_HZ = 3570e3      # Sys_Sel(DVB_T_6M).IF_KHz
# measured gain tables (:3012)
LNA_STEPS = [0, 9, 13, 40, 38, 13, 31, 22, 26, 31, 26, 14, 19, 5, 35, 13]
MIX_STEPS = [0, 5, 10, 10, 19, 9, 10, 25, 17, 10, 8, 16, 13, 6, 3, -8]


@pytest.fixture()
def r820t():
    d = RTLSource(transport="sim", tuner="r820t", rate=2.048e6)
    yield d
    d.close()


@pytest.fixture()
def e4000():
    d = RTLSource(transport="sim", tuner="e4000", rate=2.048e6)
    yield d
    d.close()


def test_r820t_init_image_written_in_order(r820t):
    log = r820t.i2c_log()
    # first 27 writes are the init image to regs 0x05..0x1F sequentially
    regs = [r for r, _ in log[:27]]
    assert regs == list(range(0x05, 0x20))
    assert log[0] == (0x05, R820T_INIT_FIRST)
    assert log[26] == (0x1F, R820T_INIT_LAST)
    # SetStandard writes follow; VER_NUM lands in reg 0x13 low 6 bits
    ver = [v for r, v in log[27:45] if r == 0x13]
    assert ver and (ver[0] & 0x3F) == 49


def _r820t_pll_model(lo_hz):
    """Independent model of R828_PLL (:1394): returns the PLL register
    values (reg10_divnum_bits, reg14, sdm) and the synthesized LO."""
    ref = 28800  # kHz
    lo_khz = lo_hz // 1000
    mix_div, div_num = 2, 0
    while mix_div <= 64:
        if 1770000 <= lo_khz * mix_div < 3540000:
            d = mix_div
            while d > 2:
                d >>= 1
                div_num += 1
            break
        mix_div <<= 1
    div_num += 1  # VCO fine-tune reads 0 on the mock (< pwr_ref 2)
    vco = lo_hz * mix_div
    nint = vco // 2 // (ref * 1000)
    fra = (vco - 2 * ref * 1000 * nint) // 1000
    if fra < ref // 64:
        fra = 0
    elif fra > ref * 127 // 64:
        fra, nint = 0, nint + 1
    elif ref * 127 // 128 < fra < ref:
        fra = ref * 127 // 128
    elif ref < fra < ref * 129 // 128:
        fra = ref * 129 // 128
    ni, si = (nint - 13) // 4, nint - 4 * ((nint - 13) // 4) - 13
    sdm, nsdm = 0, 2
    while fra > 1:
        if fra > 2 * ref // nsdm:
            sdm += 32768 // (nsdm // 2)
            fra -= 2 * ref // nsdm
            if nsdm >= 0x8000:
                break
        nsdm <<= 1
    lo_actual = 2 * ref * 1000 * (nint + sdm / 65536.0) / mix_div
    return div_num, ni + (si << 6), sdm, lo_actual


@pytest.mark.parametrize("rf_mhz", [50.0, 100.0, 446.0, 600.0, 900.0])
def test_r820t_pll_registers_across_bands(r820t, rf_mhz):
    rf = rf_mhz * 1e6
    r820t.i2c_log(clear=True)
    assert r820t.freq(rf)
    log = r820t.i2c_log()
    writes = {}
    for reg, val in log:  # last write to each reg wins
        writes[reg] = val
    div_num, reg14, sdm, lo_actual = _r820t_pll_model(
        int(rf + R820T_IF_HZ))
    assert (writes[0x10] >> 5) == div_num, "mixer divider bits"
    assert writes[0x14] == reg14, "Nint Ni/Si split"
    assert writes[0x16] == (sdm >> 8) and writes[0x15] == (sdm & 0xFF), \
        "sigma-delta registers"
    assert abs(r820t.actual_lo() - lo_actual) < 1.0
    # synthesized LO within PLL resolution of requested (2*ref/65536/div)
    mix_div = 2 ** (div_num - 1 + 1)  # fine-tune added one
    assert abs(lo_actual - (rf + R820T_IF_HZ)) < 2 * 28.8e6 / 65536 + 450e3 / mix_div


def test_r820t_band_mux_registers(r820t):
    # LO = 100 MHz + 3.57 = 103.57 MHz -> band row [100,110): TF_C 0x34
    r820t.i2c_log(clear=True)
    r820t.freq(100e6)
    tfc = [v for r, v in r820t.i2c_log() if r == 0x1B]
    assert tfc and tfc[0] == 0x34
    # LO = 653.57 MHz -> [650, inf): TF_C 0x00, rf_mux bypass 0x40
    r820t.i2c_log(clear=True)
    r820t.freq(650e6)
    log = r820t.i2c_log()
    tfc = [v for r, v in log if r == 0x1B]
    mux = [v for r, v in log if r == 0x1A]
    assert tfc and tfc[0] == 0x00
    assert mux and (mux[0] & 0xC3) == 0x40


def test_r820t_gain_walk_matches_measured_tables(r820t):
    r820t.set_gain_mode(True)
    for want_db in (5.0, 20.0, 33.5, 48.0):
        # independent walk of the measured tables
        want = int(want_db * 10)
        total, lna, mix = 0, 0, 0
        for _ in range(15):
            if total >= want:
                break
            lna += 1
            total += LNA_STEPS[lna]
            if total >= want:
                break
            mix += 1
            total += MIX_STEPS[mix]
        r820t.i2c_log(clear=True)
        assert r820t.gain(want_db)
        log = r820t.i2c_log()
        g5 = [v for r, v in log if r == 0x05]
        g7 = [v for r, v in log if r == 0x07]
        assert g5 and (g5[-1] & 0x0F) == lna, want_db
        assert g7 and (g7[-1] & 0x0F) == mix, want_db


def test_e4000_init_script(e4000):
    log = e4000.i2c_log()
    # tunerreset: reg 0x02=64 twice, 0x09=0, 0x05=0, 0x00=7
    assert log[0] == (0x02, 64) and log[1] == (0x02, 64)
    assert log[2] == (0x09, 0) and log[3] == (0x05, 0) and log[4] == (0x00, 7)
    # Tunerclock: 0x06=0, 0x7A=150
    assert log[5] == (0x06, 0) and log[6] == (0x7A, 150)
    # Qpeak: 0x7E=1, 0x7F=254, 0x82=0, 0x24=5, 0x87=32, 0x88=1
    assert log[7:13] == [(0x7E, 1), (0x7F, 254), (0x82, 0), (0x24, 5),
                         (0x87, 32), (0x88, 1)]
    # GainControlinit starts with AGC reg 0x1A=23
    assert (0x1A, 23) in log[13:16]


@pytest.mark.parametrize("rf_mhz,reg0d,mult", [
    (70.0, 15, 48),    # <=72.4 MHz band
    (100.0, 13, 32),   # <=108.3
    (300.0, 10, 12),   # <=325
    (600.0, 2, 6),     # <=667
    (1400.0, 0, 2),    # top band
])
def test_e4000_pll_band_table(e4000, rf_mhz, reg0d, mult):
    khz = int(rf_mhz * 1000)
    e4000.i2c_log(clear=True)
    assert e4000.freq(rf_mhz * 1e6)
    writes = dict(e4000.i2c_log())
    assert writes[0x0D] == reg0d
    # sigma-delta divider model (reference PLL())
    ref = 28800
    vco = khz * mult
    divider = vco // ref
    sigdel = 65536 * (vco - divider * ref) // ref
    sigdel = max(sigdel, 1024)
    sigdel = min(sigdel, 64512)
    assert writes[0x09] == divider & 0xFF
    assert writes[0x0A] == sigdel & 0xFF
    assert writes[0x0B] == sigdel >> 8
    if khz <= 1000000:
        assert writes[0x78] == 3      # freqband low/mid
    else:
        assert writes[0x78] == 0 and writes[0x07] == 7


def test_e4000_gain_map(e4000):
    e4000.set_gain_mode(True)
    e4000.i2c_log(clear=True)
    assert e4000.gain(12.5)
    writes = [v for r, v in e4000.i2c_log() if r == 0x14]
    # _mapGainsE4000: 12.5 dB (125 tenth) -> register value 9
    assert writes and (writes[-1] & 0x0F) == 9
    assert e4000.gain() == pytest.approx(12.5)


def test_e4000_if_filter_registers(e4000):
    # IFfilter: 8 MHz bandwidth -> IF_BW 4000 kHz row (reference chain)
    import ctypes
    # bandwidth isn't on the public Device surface yet: drive via freq;
    # instead assert the DC-offset LUT ran at set_frequency (regs
    # 0x60/0x50 + 0x61/0x51 + 0x63/0x53 + 0x62/0x52 written)
    e4000.i2c_log(clear=True)
    e4000.freq(300e6)
    regs = {r for r, _ in e4000.i2c_log()}
    for expect in (0x60, 0x50, 0x61, 0x51, 0x63, 0x53, 0x62, 0x52):
        assert expect in regs, hex(expect)


def _fc_pll_model(khz, bands, xtal_khz=28800):
    """Independent FC0012/13 coarse+fine divider model."""
    multi = r5 = r6 = None
    for m, b5, b6 in bands:
        if khz * m < 3560000:
            multi, r5, r6 = m, b5, b6
            break
    dvco = khz * multi
    r6 |= 0x08
    half = xtal_khz // 2
    xdiv = dvco // half
    if dvco - xdiv * half >= half // 2:
        xdiv += 1
    pm, am = xdiv // 8, xdiv % 8
    r1, r2 = (am + 8, pm - 1) if am < 2 else (am, pm)
    xin = ((dvco - (dvco // half) * half) << 15) // half
    if xin >= 16384:
        xin += 32768
    return multi, r1, r2, (xin >> 8) & 0xFF, xin & 0xFF, r5, ~0xC0 & r6


FC0012_BANDS = [(96, 0x82, 0x00), (64, 0x82, 0x02), (48, 0x42, 0x00),
                (32, 0x42, 0x02), (24, 0x22, 0x00), (16, 0x22, 0x02),
                (12, 0x12, 0x00), (8, 0x12, 0x02), (6, 0x0A, 0x00),
                (4, 0x0A, 0x02)]


@pytest.mark.parametrize("rf_mhz", [64.0, 180.0, 300.0, 600.0, 880.0])
def test_fc0012_pll_registers(rf_mhz):
    d = RTLSource(transport="sim", tuner="fc0012", rate=2.048e6)
    try:
        d.i2c_log(clear=True)
        assert d.freq(rf_mhz * 1e6)
        writes = dict(d.i2c_log())
        multi, r1, r2, r3, r4, r5, r6 = _fc_pll_model(int(rf_mhz * 1000),
                                                      FC0012_BANDS)
        assert writes[0x01] == r1 and writes[0x02] == r2
        assert writes[0x03] == r3 and writes[0x04] == r4
        assert writes[0x05] == r5 and writes[0x06] == r6
        # VCO cal strobe sequence present
        log = d.i2c_log()
        evals = [v for r, v in log if r == 0x0E]
        assert evals[:3] == [0x80, 0x00, 0x00]
        assert abs(d.actual_lo() - rf_mhz * 1e6) < 28.8e6 / 2 / 32768 + 1
    finally:
        d.close()


def test_fc0012_init_write_list():
    d = RTLSource(transport="sim", tuner="fc0012", rate=2.048e6)
    try:
        log = d.i2c_log()
        # FC0012_Open list starts 0x01=0x05 ... and ends with the
        # nim_rtl2832 re-writes (0x0D, 0x11, 0x15)
        assert log[0] == (0x01, 0x05) and log[1] == (0x02, 0x10)
        assert (0x12, 0x1F) in log[:20]         # max gain
        assert log[20:23] == [(0x0D, 0x02), (0x11, 0x00), (0x15, 0x04)]
    finally:
        d.close()


def test_fc0013_band_switch_and_gain():
    d = RTLSource(transport="sim", tuner="fc0013", rate=2.048e6)
    try:
        # VHF: tracking filter bits on reg 0x1D, reg 0x07 bit4 set
        d.i2c_log(clear=True)
        d.freq(180e6)
        log = d.i2c_log()
        r1d = [v for r, v in log if r == 0x1D]
        assert r1d and (r1d[0] & 0x1C) == 0x1C     # entry write
        assert any((v & 0x1C) == 0x18 for v in r1d)  # 177.5-184.5 band
        assert any(r == 0x07 and (v & 0x10) for r, v in log)
        # UHF: reg 0x14 gains band bits 0x40
        d.i2c_log(clear=True)
        d.freq(600e6)
        log = d.i2c_log()
        assert any(r == 0x14 and (v & 0x60) == 0x40 for r, v in log)
        # gain map: 19.1 dB -> code 0x11 in reg 0x14 bits [4:0]
        d.set_gain_mode(True)
        d.i2c_log(clear=True)
        d.gain(19.1)
        g = [v for r, v in d.i2c_log() if r == 0x14]
        assert g and (g[-1] & 0x1F) == 0x11
    finally:
        d.close()


# -- E4K (osmocom-lineage) program ------------------------------------------

def _e4k_pll_model(flo_hz, fosc=28800000):
    """Independent model of e4k_compute_pll_params (reference
    rtl2832-tuner_e4k.cc:1175): R-divider table walk, Fvco window,
    Z/X split."""
    three_ph = 1 if flo_hz < 300e6 else 0
    for i, r0 in enumerate([4, 8, 12, 16, 24, 32, 40, 48]):
        r = r0 if three_ph else r0 // 2
        fvco = int(flo_hz) * r
        if not (2.6e9 <= fvco <= 3.9e9):
            continue
        z = fvco // fosc
        if z > 255:
            continue
        x = ((fvco - fosc * z) * 65536) // fosc
        flo_act = (fosc * z + (fosc * x) // 65536) // r
        return i, three_ph, z, x, flo_act
    raise AssertionError("no PLL solution")


@pytest.fixture()
def e4k():
    d = RTLSource(transport="sim", tuner="e4k", rate=2.048e6)
    yield d
    d.close()


def test_e4k_init_register_trace(e4k):
    log = e4k.i2c_log()
    # reset + clock config (e4k_init:1557-1567)
    assert log[0] == (0x00, 0x07)          # MASTER1 RESET|NORM_STBY|POR_DET
    assert log[1] == (0x05, 0x00) and log[2] == (0x06, 0x00)
    assert log[3] == (0x7A, 0x96)          # CLKOUT_PWDN
    # magic_init values (:1526-1536)
    assert log[4:12] == [(0x7E, 1), (0x7F, 0xFE), (0x82, 0), (0x86, 0x50),
                         (0x87, 0x20), (0x88, 1), (0x9F, 0x7F), (0xA0, 7)]
    assert (0x2F, 4) in log                # common mode 850 mV
    # DC offset LUT generation wrote all 8 table registers
    regs = {r for r, _ in log}
    for lut in (0x50, 0x51, 0x52, 0x53, 0x60, 0x61, 0x62, 0x63):
        assert lut in regs, hex(lut)
    # AGC thresholds + narrowest IF filters (MIX idx15<<4 | RC idx15,
    # CHAN idx31 then bandwidth 8 MHz -> idx 0)
    assert (0x1D, 0x10) in log and (0x1E, 0x04) in log and (0x1F, 0x1A) in log
    f2 = [v for r, v in log if r == 0x11]
    assert f2[-1] == 0xFF
    f3 = [v for r, v in log if r == 0x12]
    assert f3[0] == 0x1F and f3[-1] == 0x00
    # moderate IF gain programming left GAIN3 = stages (1,1,1,1) fields
    g3 = [v for r, v in log if r == 0x16]
    assert g3[-1] == 0x2B and g3[-2] == 0x4B
    g4 = [v for r, v in log if r == 0x17]
    assert g4[-1] == 0x12


@pytest.mark.parametrize("rf_mhz", [70.0, 100.0, 300.0, 600.0, 1400.0])
def test_e4k_pll_registers_across_bands(e4k, rf_mhz):
    flo = rf_mhz * 1e6
    e4k.i2c_log(clear=True)
    assert e4k.freq(flo)
    writes = dict(e4k.i2c_log())
    r_idx, three_ph, z, x, flo_act = _e4k_pll_model(flo)
    assert writes[0x0D] == (r_idx & 7) | (three_ph << 3), "SYNTH7 R/phase"
    assert writes[0x09] == z, "SYNTH3 Z"
    assert writes[0x0A] == x & 0xFF and writes[0x0B] == x >> 8, "SYNTH4/5 X"
    # band select: BIAS 3 except L band 0 (e4k_band_set:1116)
    assert writes[0x78] == (0 if flo_act >= 1135e6 else 3)
    assert e4k.freq() == pytest.approx(flo_act, abs=1.0)
    # PLL resolution bound
    assert abs(e4k.actual_lo() - flo) < 28.8e6 / 65536 + 1


def test_e4k_band_field_and_rf_filter(e4k):
    # 600 MHz: UHF band -> SYNTH1 field 2<<1, RF filter idx 9 (615 MHz
    # nearest center in rf_filt_center_uhf, :807)
    e4k.i2c_log(clear=True)
    e4k.freq(600e6)
    writes = dict(e4k.i2c_log())
    assert writes[0x07] & 0x06 == 0x04
    assert writes[0x10] & 0x0F == 9
    # 1400 MHz: L band -> field 3<<1, filter idx 3 (1410 MHz nearest)
    e4k.i2c_log(clear=True)
    e4k.freq(1400e6)
    writes = dict(e4k.i2c_log())
    assert writes[0x07] & 0x06 == 0x06
    assert writes[0x10] & 0x0F == 3
    assert writes[0x78] == 0  # L-band BIAS


def test_e4k_gain_map_floor_snap(e4k):
    e4k.set_gain_mode(True)
    # exact entry: 12.5 dB -> LNA field 9 (map e4k.cc:201)
    e4k.i2c_log(clear=True)
    assert e4k.gain(12.5)
    g = [v for r, v in e4k.i2c_log() if r == 0x14]
    assert g and (g[-1] & 0x0F) == 9
    assert e4k.gain() == pytest.approx(12.5)
    # floor snap: 0.3 dB -> 0.0 dB entry (field 4), get_map_index
    # semantics (rtl2832.cc:66)
    e4k.i2c_log(clear=True)
    assert e4k.gain(0.3)
    g = [v for r, v in e4k.i2c_log() if r == 0x14]
    assert g and (g[-1] & 0x0F) == 4
    assert e4k.gain() == pytest.approx(0.0)
    # below the table -> FAILURE, no write (wrapper returns FAILURE)
    e4k.i2c_log(clear=True)
    assert not e4k.gain(-6.0)
    assert not [v for r, v in e4k.i2c_log() if r == 0x14]


# -------------------------------------------------------------------------
# tests/test_demod_program.py on the port's driver
# -------------------------------------------------------------------------

USBB, SYSB, IICB = 1, 2, 6
USB_SYSCTL, USB_EPA_CTL, USB_EPA_MAXPKT = 0x2000, 0x2148, 0x2158
DEMOD_CTL, GPO, GPOE, GPD, DEMOD_CTL_1 = 0x3000, 0x3001, 0x3003, 0x3004, 0x300b

FIR = [0xca, 0xdc, 0xd7, 0xd8, 0xe0, 0xf2, 0x0e, 0x35, 0x06, 0x50,
       0x9c, 0x0d, 0x71, 0x11, 0x14, 0x71, 0x74, 0x19, 0x41, 0x00]


def W(block, addr, val, ln=1):
    """Expected wire tuple of a system-block register write."""
    if ln == 1:
        return (1, addr, (block << 8) | 0x10, 1, val & 0xFF, 0)
    return (1, addr, (block << 8) | 0x10, 2, (val >> 8) & 0xFF, val & 0xFF)


def DW(page, addr, val, ln=1):
    """Expected wire tuples of a demod-page register write (the write
    plus its completion-handshake read)."""
    if ln == 1:
        wr = (1, (addr << 8) | 0x20, 0x10 | page, 1, val & 0xFF, 0)
    else:
        wr = (1, (addr << 8) | 0x20, 0x10 | page, 2,
              (val >> 8) & 0xFF, val & 0xFF)
    handshake = (0, (0x01 << 8) | 0x20, 0x0a, 1, 0, 0)
    return [wr, handshake]


def expected_set_if(freq_hz):
    """set_if register program (reference :977-1015)."""
    adj = int((freq_hz * (1 << 22)) / 28.8e6 * -1.0) & 0xFFFFFFFF
    ops = []
    ops += DW(1, 0x19, (adj >> 16) & 0x3F)
    ops += DW(1, 0x1A, (adj >> 8) & 0xFF)
    ops += DW(1, 0x1B, adj & 0xFF)
    if freq_hz == 0.0:
        ops += DW(1, 0xB1, 0x1B)   # zero-IF on
        ops += DW(0, 0x08, 0xCD)   # I+Q ADC
        ops += DW(1, 0x15, 0x00)   # no spectrum inversion
    else:
        ops += DW(1, 0xB1, 0x1A)
        ops += DW(0, 0x08, 0x4D)
        ops += DW(1, 0x15, 0x01)
    ops += DW(0, 0x06, 0x80)
    return ops


def expected_init_demod():
    """The complete init_demod wire program (reference :903-975)."""
    ops = []
    ops.append(W(USBB, USB_SYSCTL, 0x09))
    ops.append(W(USBB, USB_EPA_MAXPKT, 0x0002, 2))
    ops.append(W(USBB, USB_EPA_CTL, 0x1002, 2))
    ops.append(W(SYSB, DEMOD_CTL_1, 0x22))
    ops.append(W(SYSB, DEMOD_CTL, 0xE8))
    ops += DW(1, 0x01, 0x14)           # soft reset strobe
    ops += DW(1, 0x01, 0x10)
    ops += DW(1, 0x16, 0x0000, 2)      # spectrum inv / ACR off
    for i in range(6):                 # IF registers cleared
        ops += DW(1, 0x16 + i, 0x00)
    for i, b in enumerate(FIR):        # the 20-byte FIR bank
        ops += DW(1, 0x1C + i, b)
    ops += DW(0, 0x19, 0x05)
    ops += DW(1, 0x93, 0xF0)           # FSM state-holding
    ops += DW(1, 0x94, 0x0F)
    ops += DW(1, 0x11, 0x00)           # en_dagc off
    ops += DW(1, 0x04, 0x00)           # RF/IF AGC loop off
    ops += DW(0, 0x61, 0x60)           # PID filter off
    ops += DW(1, 0xB1, 0x1B)           # zero-IF + DC/IQ estimation
    ops += DW(0, 0x0D, 0x83)           # TP_CK0 clock off
    ops += expected_set_if(0.0)
    return ops


@pytest.fixture(scope="module")
def lib():
    return _load()


def test_init_demod_trace(lib):
    """The init program is write-for-write the reference's."""
    h = lib.rtl_open_sim(25e3, 0.6, 0.0, 1, TUNER_IDS["r820t"])
    assert h
    try:
        got = wire_log(lib, h)
        want = expected_init_demod()
        assert got[:len(want)] == want
        # the op right after init_demod is the repeater-on write that
        # gates the tuner probe (reference probe loop :478-509)
        rep_on = DW(1, 0x01, 0x18)
        assert got[len(want):len(want) + 2] == rep_on
    finally:
        lib.rtl_close(h)


@pytest.mark.parametrize("rate", [1.024e6, 2.048e6, 2.4e6, 3.2e6])
def test_sample_rate_registers(lib, rate):
    """ratio = floor(xtal * 2^22 / rate) & ~3 -> page1 0x9f/0xa1
    (reference :705-743)."""
    h = lib.rtl_open_sim(25e3, 0.6, 0.0, 1, TUNER_IDS["e4k"])
    assert h
    try:
        lib.rtl_wire_log_clear(h)
        assert lib.rtl_set_sample_rate(h, rate) == 0
        got = wire_log(lib, h)
        ratio = (int(28.8e6) * (1 << 22)) // int(rate)
        ratio &= ~3
        want = DW(1, 0x9F, (ratio >> 16) & 0xFFFF, 2) \
            + DW(1, 0xA1, ratio & 0xFFFF, 2)
        assert got[:len(want)] == want
        # the programmed real rate is xtal * 2^22 / ratio
        real = 28.8e6 * (1 << 22) / ratio
        assert abs(lib.rtl_get_sample_rate(h) - real) < 1e-6 * real
    finally:
        lib.rtl_close(h)


def test_set_if_nonzero_branch(lib):
    """A tuner with a non-zero IF (R820T) flips the demod into low-IF:
    spectrum inversion on, I-only ADC (reference :995-1009)."""
    h = lib.rtl_open_sim(25e3, 0.6, 0.0, 1, TUNER_IDS["r820t"])
    assert h
    try:
        lib.rtl_wire_log_clear(h)
        assert lib.rtl_set_frequency(h, 100e6) == 0
        got = wire_log(lib, h)
        # after the tuner's I2C program + repeater writes comes
        # set_if(IF): find the 0xB1 page-1 write and check the low-IF
        # branch values
        b1_writes = [op for op in got
                     if op[0] == 1 and op[1] == (0xB1 << 8) | 0x20
                     and op[2] == 0x11]
        assert b1_writes, "no page-1 0xb1 write after tune"
        assert b1_writes[-1][4] == 0x1A  # zero-IF disabled
        adc = [op for op in got
               if op[0] == 1 and op[1] == (0x08 << 8) | 0x20
               and op[2] == 0x10]
        assert adc and adc[-1][4] == 0x4D  # I-only ADC input
        inv = [op for op in got
               if op[0] == 1 and op[1] == (0x15 << 8) | 0x20
               and op[2] == 0x11]
        assert inv and inv[-1][4] == 0x01  # spectrum inversion on
    finally:
        lib.rtl_close(h)


def test_endpoint_reset_on_start(lib):
    """reset(): EPA_CTL 0x1002 then 0x0000 before streaming
    (reference :860-866)."""
    h = lib.rtl_open_sim(25e3, 0.6, 0.0, 1, TUNER_IDS["e4k"])
    assert h
    try:
        lib.rtl_wire_log_clear(h)
        assert lib.rtl_start(h, 1 << 16) == 0
        got = wire_log(lib, h)
        want = [W(USBB, USB_EPA_CTL, 0x1002, 2),
                W(USBB, USB_EPA_CTL, 0x0000, 2)]
        assert got[:2] == want
    finally:
        lib.rtl_stop(h)
        lib.rtl_close(h)


def test_gpio_rmw(lib):
    """set_gpio_output reads GPD, clears the bit in GPO, sets it in
    GPOE; set_gpio_bit rmws GPO (reference :750-775)."""
    h = lib.rtl_open_sim(25e3, 0.6, 0.0, 1, TUNER_IDS["e4k"])
    assert h
    try:
        lib.rtl_wire_log_clear(h)
        assert lib.rtl_set_gpio_output(h, 3) == 0
        assert lib.rtl_set_gpio_bit(h, 3, 1) == 0
        got = wire_log(lib, h)
        # reads: GPD then GPOE then GPO; writes: GPO (bit cleared),
        # GPOE (bit set), GPO (bit set)
        assert got[0][:3] == (0, GPD, SYSB << 8)
        assert got[1] == W(SYSB, GPO, 0x00)
        assert got[2][:3] == (0, GPOE, SYSB << 8)
        assert got[3] == W(SYSB, GPOE, 0x08)
        assert got[4][:3] == (0, GPO, SYSB << 8)
        assert got[5] == W(SYSB, GPO, 0x08)
    finally:
        lib.rtl_close(h)


def test_device_table_products(lib):
    """VID/PID opens resolve product names + tuner hints from the
    device table (reference :193-216)."""
    # NOXON rev 1 hints fc0013
    src = RTLSource(transport="sim", tuner="", vid=0x0CCD, pid=0x00B3)
    try:
        assert src.product_name() == "Terratec NOXON (rev 1)"
        assert src.tuner_name() == "fc0013"
        assert "Terratec NOXON (rev 1)" in src.name()
    finally:
        src.close()
    # ezcap is the canonical 0x0bda:0x2838
    src = RTLSource(transport="sim", tuner="r820t", vid=0x0BDA, pid=0x2838)
    try:
        assert src.product_name() == "ezcap EzTV"
        assert src.tuner_name() == "r820t"
    finally:
        src.close()


def test_device_table_complete(lib):
    """All 21 reference table rows present with exact identities."""
    n = lib.rtl_device_table_count()
    assert n == 21
    name = ctypes.c_char_p()
    vid = ctypes.c_uint16()
    pid = ctypes.c_uint16()
    hint = ctypes.c_char_p()
    rows = {}
    for i in range(n):
        lib.rtl_device_table_get(i, ctypes.byref(name), ctypes.byref(vid),
                                 ctypes.byref(pid), ctypes.byref(hint))
        rows[(vid.value, pid.value)] = (name.value.decode(),
                                        hint.value.decode())
    assert rows[(0x0BDA, 0x2838)][0] == "ezcap EzTV"
    assert rows[(0x1B80, 0xD395)] == ("Peak", "fc0012")
    assert rows[(0x1D19, 0x1102)] == ("Dexatek Technology (rev 2)",
                                      "fc0013")
    assert rows[(0x185B, 0x0650)][0] == "Compro Videomate U650F"


# -------------------------------------------------------------------------
# the port's driver against the JAX package's, and its build
# -------------------------------------------------------------------------

from grbaz_tpu.io import rtl_source as jrtl  # noqa: E402

WAIT_S = 20.0


def _pair(**kw):
    return RTLSource(**kw), jrtl.RTLSource(**kw)


def _read_n(dev, n, timeout=WAIT_S):
    """``n`` samples from a started device, keeping every short read."""
    out, got = [], 0
    deadline = time.monotonic() + timeout
    while got < n:
        assert time.monotonic() < deadline, f"only {got} of {n} samples"
        x = dev.read_samples(n - got)
        out.append(x)
        got += len(x)
    return np.concatenate(out)


@pytest.mark.parametrize("tuner", sorted(TUNER_IDS))
def test_sim_driver_matches_jax(tuner):
    """The same sim arguments give the same I2C and wire logs, LO,
    gains, rates and samples in both packages."""
    port, jax_ = _pair(transport="sim", tuner=tuner, tone_offset=30e3,
                       rate=2.048e6, seed=3)
    try:
        assert port.i2c_log() == jax_.i2c_log()
        assert wire_log(port._lib, port._h) == jrtl.wire_log(jax_._lib,
                                                             jax_._h)
        assert port.name() == jax_.name()
        assert vars(port.gain_range()) == vars(jax_.gain_range())
        for rf in (100e6, 433.92e6, 900e6):
            assert port.freq(rf) == jax_.freq(rf)
            assert port.freq() == jax_.freq()
            assert port.actual_lo() == jax_.actual_lo()
        assert port.set_gain_mode(True) == jax_.set_gain_mode(True)
        r = port.gain_range()
        g = 0.5 * (r.start + r.stop)
        assert port.gain(g) == jax_.gain(g)
        assert port.gain() == jax_.gain()
        assert port.sample_rate(2.4e6) == jax_.sample_rate(2.4e6)
        assert port.sample_rate() == jax_.sample_rate()
        assert port.i2c_log() == jax_.i2c_log()
        assert wire_log(port._lib, port._h) == jrtl.wire_log(jax_._lib,
                                                             jax_._h)
        for d in (port, jax_):
            assert d.start()
        n = 1 << 15
        np.testing.assert_array_equal(_read_n(port, n), _read_n(jax_, n))
        for d in (port, jax_):
            assert d.stats()["overflows"] == 0
    finally:
        port.close()
        jax_.close()


def test_file_transport_matches_jax_and_the_bytes(tmp_path):
    """The file transport hands out the capture's bytes as
    ``(b - 127.5) / 127.5``, equal in both packages, and loops at the
    end of the file."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 2 * 20000, dtype=np.uint8)
    path = tmp_path / "cap.u8"
    raw.tofile(path)
    want = (raw.astype(np.float32) - 127.5) / 127.5
    want = (want[0::2] + 1j * want[1::2]).astype(np.complex64)
    port, jax_ = _pair(transport="file", path=str(path), tuner="r820t",
                       rate=3.2e6)
    try:
        assert port.tuner_name() == jax_.tuner_name() == "r820t"
        assert port.i2c_log() == jax_.i2c_log()
        for d in (port, jax_):
            assert d.start()
        n = len(want) + 5000
        got, jgot = _read_n(port, n), _read_n(jax_, n)
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(got[:len(want)], want)
        np.testing.assert_array_equal(got[len(want):], want[:5000])
        assert port.stats()["overflows"] == 0
    finally:
        port.close()
        jax_.close()


def test_library_builds_in_build_dir_from_every_source(tmp_path,
                                                      monkeypatch):
    """The driver is the port's own build: under ``_build/``, named after
    the hash of the .cc and of both files it includes, never the JAX
    tree's prebuilt library."""
    from grbaz_tpu_torch import native
    lib = _load()
    path = native.library_path("rtlsdr_core", native.RTLSDR_SOURCES)
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build"
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert "grbaz_tpu_torch" in str(path)
    src = native.SRC_DIR
    for name in native.RTLSDR_SOURCES:
        copy = tmp_path / name
        shutil.copytree(src, copy,
                        ignore=shutil.ignore_patterns("__pycache__"))
        monkeypatch.setattr(native, "SRC_DIR", copy)
        assert native.library_path("rtlsdr_core",
                                   native.RTLSDR_SOURCES) == path
        with open(copy / name, "a") as fh:
            fh.write("\n// edited\n")
        other = native.library_path("rtlsdr_core", native.RTLSDR_SOURCES)
        assert other != path and other.parent == native.BUILD_DIR, name


def test_create_device_hint_opens_the_ports_driver():
    from grbaz_tpu_torch.net.devices import DEVICE_REGISTRY, create_device
    d = create_device("rtl_sdr transport=sim tuner=fc0012 rate=2048000")
    try:
        assert isinstance(d, RTLSource)
        assert d.tuner_name() == "fc0012"
        assert DEVICE_REGISTRY["rtl"] is RTLSource
        assert DEVICE_REGISTRY["rtl_sdr"] is RTLSource
    finally:
        d.close()


# -------------------------------------------------------------------------
# the RTL path: chip_smoke's u8 scene on the CPU, and rtl_fm over the
# BorIP server's RTL hint in both packages
# -------------------------------------------------------------------------

def test_chip_smoke_rtl_scene_on_cpu(tmp_path):
    """``chip_smoke.rtl_path``'s scene at a small block on the CPU: the
    file transport's reads equal the capture's bytes as read_samples
    converts them, no overflow, and the audio of (a) the driver and (c)
    the TCP frame plane through the pump is bit-equal to the Flowgraph
    over the capture; every tag at its offset."""
    import torch

    import chip_smoke as cs
    from grbaz_tpu_torch.models.wbfm import WBFMConfig
    n = 1 << 14
    cfg = WBFMConfig(block_size=n, audio_chain="cascade",
                     center_freq=cs.STATION_HZ)
    total = 2 * n + n // 2
    cap = str(tmp_path / "capture.u8")
    x, _, counts, outs = cs.rtl_scene(cap, total, cfg, torch.device("cpu"))
    raw = np.fromfile(cap, np.uint8)
    assert len(raw) == 2 * total
    np.testing.assert_array_equal(x, cs.u8_samples(raw))
    assert np.abs(x).max() <= np.sqrt(2) and counts == [n, n, n // 2]
    ref = [d[:int(c)].numpy() for d, c in (o["audio"] for o in outs)]
    ex = cs.ingest_executor(cfg, torch.device("cpu"))
    run = cs.rtl_run(ex, cap, total, cs.FS, drop=False)
    cs.check_rtl_run(run, ref, x, "rtl scene")
    assert run["tuner"] == "r820t" and run["rtl"]["overflows"] == 0
    assert abs(run["freq"] - cs.RTL_TUNE_HZ) < 1e3 < run["lo"]
    run = cs.tcp_run(ex, x, drop=False)
    cs.check_rtl_run(run, ref, x, "tcp scene")
    cs.check_tags(run, "tcp scene")
    assert len(run["tags"]) == 3


def test_rtl_fm_over_the_rtl_hint_equals_jax(tmp_path, capsys, monkeypatch):
    """``rtl_fm --borip`` against each package's BorIPServer serving the
    same u8 capture through the package's RTL driver (``DEVICE`` from the
    hint ``rtl transport=file ...``). ``--freq`` both tunes the device
    and centres the channel, so the tuner is asked for the station's
    offset, below its range; both apps go on, and their WAVs agree
    within 3 LSB."""
    import chip_smoke as cs
    from grbaz_tpu.apps import rtl_fm as j_rtl
    from grbaz_tpu.net import borip_client as j_client
    from grbaz_tpu.net.borip_server import BorIPServer as JServer
    from grbaz_tpu_torch.apps import rtl_fm
    from grbaz_tpu_torch.net import borip_client
    from grbaz_tpu_torch.net.borip_server import BorIPServer
    from tests.test_torch_apps import _Recorder, tone_hz

    rate, station = 1.024e6, 100e3
    n = int(0.25 * rate)
    st = rtl_fm.FMStation(rate, station, 25e3)
    x = st.read_samples(n) * 0.8
    cap = tmp_path / "cap.u8"
    cs.u8_iq(x).tofile(str(cap))
    hint = f"rtl transport=file path={cap} rate={int(rate)} tuner=r820t"
    argv = ["--borip", None, "--rate", str(rate), "--freq", str(station),
            "--seconds", "0.1", "--block", str(32 * 368), "--audio-rate",
            "32e3"]
    wavs = []
    for server, main, client, extra in (
            (JServer, j_rtl.main, j_client, []),
            (BorIPServer, rtl_fm.main, borip_client, ["--device", "cpu"])):
        srv = server(("127.0.0.1", 0), default_device=hint)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        # the file transport paces at 4x the rate and loops, so the
        # client's ring must hold what arrives while the JAX app
        # compiles its chain (the default 8192 packets last 0.75 s here)
        monkeypatch.setattr(client, "UDPSampleReceiver", functools.partial(
            client.UDPSampleReceiver, ring_packets=1 << 16))
        rec = _Recorder(monkeypatch, client)
        wav = str(tmp_path / f"{len(wavs)}.wav")
        try:
            args = list(argv)
            args[1] = f"127.0.0.1:{srv.port}"
            assert main(args + ["-o", wav] + extra) == 0
        finally:
            for dev in rec.made:
                dev.close()
            srv.shutdown()
            srv.server_close()
        assert len(rec.made) == 1
        assert rec.made[0].final_stats["dropped"] == 0
        assert rec.made[0].final_stats["overruns"] == 0
        wavs.append(wav)
    capsys.readouterr()
    pcm = cs.same_wav(wavs[1], wavs[0])
    assert abs(tone_hz(pcm, 32e3) - 1000.0) < 20.0
