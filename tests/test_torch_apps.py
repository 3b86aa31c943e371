"""The port's receive apps (``grbaz_tpu_torch/apps``) against the JAX
package's: each app's ``main(argv + ["--device", "cpu"])`` against the
JAX app's ``main(argv)`` at a small size, over the synthetic source, a
capture file the test writes (``--input``) and loopback UDP (``--borip``,
``--udp-port``).

Tolerances: WAV samples within 3 LSB (1e-4 of full scale); the CSVs'
dB values within one printed LSB (0.01, the apps write ``%.2f``) or, in
linear power, within 1e-4 of their frame's peak; images within one
level of the colour gradient; stdout equal up to its printed precision.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs

from grbaz_tpu.apps import am_fft as j_am
from grbaz_tpu.apps import fac as j_fac
from grbaz_tpu.apps import papr as j_papr
from grbaz_tpu.apps import realtime_fft as j_rfft
from grbaz_tpu.apps import rtl_fm as j_rtl
from grbaz_tpu.apps import scanner as j_scan
from grbaz_tpu.net import borip_client as j_client
from grbaz_tpu.net import udp as j_udp
from grbaz_tpu_torch.apps import (am_fft, fac, papr, realtime_fft, rtl_fm,
                                  scanner)
from grbaz_tpu_torch.net import borip_client, udp
from grbaz_tpu_torch.net.borip_server import BorIPServer
from tests.test_file_source import make_wav

WAIT_S = 25.0
RTL = ["--rate", "256e3", "--decim", "4", "--audio-rate", "32e3",
       "--block", "16384"]
RTL_STATION_HZ = 50e3


# the comparisons are chip_smoke's, which holds the card runs to the CPU's
same_wav, same_png, fill = cs.same_wav, cs.same_png, cs.fill
same_csv, read_wav = cs.same_db_csv, cs.read_wav


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def outputs(tmp_path, tag, names):
    return {n: str(tmp_path / f"{tag}_{n}") for n in names}


def both(tmp_path, capsys, j_main, t_main, argv, names=()):
    """The JAX app and the port's (on the CPU) over the same argv, each
    writing its own copy of the ``names`` outputs: (jax, port) stdout
    with the output paths masked, and the two output dicts."""
    res = []
    for tag, main, extra in (("jax", j_main, []),
                             ("port", t_main, ["--device", "cpu"])):
        files = outputs(tmp_path, tag, names)
        args = fill(argv, files) + extra
        out = run(main, args, capsys)
        for n, p in files.items():
            out = out.replace(p, n)
        res.append((out, files))
    return res[0][0], res[1][0], res[0][1], res[1][1]


# -- signals ----------------------------------------------------------------

def fm_capture(n, rate=256e3, offset=RTL_STATION_HZ, seed=2):
    """An FM station (1 kHz tone) with noise, quantized to the BorIP wire
    (so the wire carries it losslessly)."""
    st = rtl_fm.FMStation(rate, offset, 25e3)
    x = st.read_samples(n) * 0.7
    rng = np.random.default_rng(seed)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return udp.ishort_bytes_to_complex(
        udp.complex_to_ishort_bytes(x.astype(np.complex64)))


def test_fm_capture_is_lossless_on_the_wire():
    x = fm_capture(4096)
    np.testing.assert_array_equal(
        udp.ishort_bytes_to_complex(udp.complex_to_ishort_bytes(x)), x)


def tone_hz(pcm, rate):
    a = pcm.astype(np.float64)[len(pcm) // 4:]
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
    return (np.argmax(spec[3:]) + 3) * rate / len(a)


# -- rtl_fm -----------------------------------------------------------------

def test_rtl_fm_synth(tmp_path, capsys):
    argv = ["--synth", "--seconds", "0.25", "--freq", "30e3", "-o",
            "{a.wav}"] + RTL
    jo, to, jf, tf = both(tmp_path, capsys, j_rtl.main, rtl_fm.main, argv,
                          ["a.wav"])
    assert jo == to
    pcm = same_wav(tf["a.wav"], jf["a.wav"])
    assert abs(tone_hz(pcm, 32e3) - 1000.0) < 20.0


@pytest.mark.parametrize("fmt", ["c64", "wav"])
def test_rtl_fm_input(tmp_path, capsys, fmt):
    x = fm_capture(3 * 16384 + 5000)
    path = tmp_path / f"cap.{fmt}"
    if fmt == "c64":
        x.tofile(str(path))
        argv = ["--input", str(path), "--fmt", "c64"]
    else:
        make_wav(str(path), x, rate=256000)
        argv = ["--input", str(path)]
    argv += ["--freq", str(RTL_STATION_HZ), "-o", "{a.wav}"] + RTL
    jo, to, jf, tf = both(tmp_path, capsys, j_rtl.main, rtl_fm.main, argv,
                          ["a.wav"])
    assert jo == to
    pcm = same_wav(tf["a.wav"], jf["a.wav"])
    # every sample read, the partial last block included
    assert len(pcm) > (3 * 16384 + 4000) // 8
    assert abs(tone_hz(pcm, 32e3) - 1000.0) < 20.0


class _Recorder:
    """Wraps a package's ``RemoteDevice`` so the test sees each instance
    and its receiver's stats at close."""

    def __init__(self, monkeypatch, module):
        self.made = []
        rec = self

        class Remote(module.RemoteDevice):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.made.append(self)

            def close(self):
                if getattr(self, "final_stats", None) is None:
                    self.final_stats = self.rx.stats()
                self._rfile.close()   # the JAX client leaves it open
                super().close()

        monkeypatch.setattr(module, "RemoteDevice", Remote)


def test_rtl_fm_borip(tmp_path, capsys, monkeypatch):
    """rtl_fm --borip against the port's BorIP server serving a FileDevice
    paced at the stream's rate: the JAX app and the port's read the same
    samples (no drop) and agree; the port's audio is bit-equal to its
    --input run over the same capture."""
    n = 4 * 16384
    x = fm_capture(n)
    cap = tmp_path / "cap.c64"
    x.tofile(str(cap))
    srv = BorIPServer(("127.0.0.1", 0),
                      default_device=f"file {cap} rate=256000 realtime=1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    recs = [_Recorder(monkeypatch, j_client), _Recorder(monkeypatch,
                                                        borip_client)]
    try:
        argv = ["--borip", f"127.0.0.1:{srv.port}", "--seconds",
                str(n / 256e3), "--freq", str(RTL_STATION_HZ), "-o",
                "{a.wav}"] + RTL
        jo, to, jf, tf = both(tmp_path, capsys, j_rtl.main, rtl_fm.main,
                              argv, ["a.wav"])
    finally:
        for r in recs:
            for dev in r.made:
                dev.close()
        srv.shutdown()
        srv.server_close()
    assert jo == to
    for r in recs:
        assert len(r.made) == 1
        assert r.made[0].final_stats["dropped"] == 0
        assert r.made[0].final_stats["overruns"] == 0
    pcm = same_wav(tf["a.wav"], jf["a.wav"])
    assert abs(tone_hz(pcm, 32e3) - 1000.0) < 20.0
    ref = tmp_path / "ref.wav"
    assert rtl_fm.main(["--input", str(cap), "--fmt", "c64", "--freq",
                        str(RTL_STATION_HZ), "-o", str(ref), "--device",
                        "cpu"] + RTL) == 0
    _, want = read_wav(str(ref))
    np.testing.assert_array_equal(pcm, want[:len(pcm)])


# -- UDP-fed apps -----------------------------------------------------------

def _udp_run(monkeypatch, module, main, argv, signal):
    """Run ``main(argv + ["--udp-port", P])`` in a thread; once its
    receiver is bound, send ``signal`` over BorIP from the start, never
    more than 16 packets ahead of the receiver, until the app is done.
    Returns the receiver's stats at its close."""
    made, bound = [], threading.Event()

    class Rx(module.UDPSampleReceiver):
        def __init__(self, *a, **k):
            self._guard = threading.Lock()
            self.final_stats = None
            super().__init__(*a, **k)
            made.append(self)
            bound.set()

        def stats(self):
            with self._guard:
                return self.final_stats or super().stats()

        def close(self):
            with self._guard:
                if self.final_stats is None:
                    self.final_stats = super().stats()
                    super().close()

    monkeypatch.setattr(module, "UDPSampleReceiver", Rx)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    result = {}
    app = threading.Thread(target=lambda: result.update(
        rc=main(argv + ["--udp-port", str(port)])), daemon=True)
    app.start()
    assert bound.wait(WAIT_S)
    rx = made[0]
    tx = udp.UDPSampleSender("127.0.0.1", port, bor=True)
    per = udp.DEFAULT_PAYLOAD // 4
    deadline = time.monotonic() + WAIT_S
    sent = packets = 0
    while app.is_alive() and sent < len(signal) \
            and time.monotonic() < deadline:
        chunk = signal[sent:sent + 16 * per]
        tx.send_complex(chunk)
        sent += len(chunk)
        packets += -(-len(chunk) // per)
        while app.is_alive() and rx.stats()["packets"] < packets - 16 \
                and time.monotonic() < deadline:
            time.sleep(0.0005)
    app.join(WAIT_S)
    tx.close()
    assert not app.is_alive(), "the app did not finish on the samples sent"
    rx.close()
    assert result.get("rc") == 0
    return rx.final_stats


def _udp_app(tmp_path, capsys, monkeypatch, module, main, argv, names,
             signal, tag, extra=()):
    """One app fed over UDP (:func:`_udp_run`), no packet lost: its
    stdout with the output paths masked, and its outputs."""
    files = outputs(tmp_path, tag, names)
    stats = _udp_run(monkeypatch, module, main,
                     fill(argv, files) + list(extra), signal)
    assert stats["dropped"] == 0 and stats["overruns"] == 0
    out = capsys.readouterr().out
    for n, p in files.items():
        out = out.replace(p, n)
    return out, files


def _udp_both(tmp_path, capsys, monkeypatch, j_main, t_main, argv, names,
              signal):
    jo, jf = _udp_app(tmp_path, capsys, monkeypatch, j_udp, j_main, argv,
                      names, signal, "jax")
    to, tf = _udp_app(tmp_path, capsys, monkeypatch, udp, t_main, argv,
                      names, signal, "port", ["--device", "cpu"])
    return jo, to, jf, tf


def spectral_signal(n, seed=4):
    """Two tones and noise, quantized to the wire."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (0.5 * np.exp(2j * np.pi * 0.1 * t) + 0.05 * np.exp(
        2j * np.pi * -0.23 * t) + 0.01 * (rng.standard_normal(n) + 1j
                                          * rng.standard_normal(n)))
    return udp.ishort_bytes_to_complex(udp.complex_to_ishort_bytes(
        x.astype(np.complex64)))


def pulse_signal(n, rate=250e3, seed=5):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = np.where(k % int(rate / 5e3) < 4, 0.9, 0.0) \
        + 0.01 * rng.standard_normal(n)
    return udp.ishort_bytes_to_complex(udp.complex_to_ishort_bytes(
        x.astype(np.complex64)))


def test_realtime_fft_synth(tmp_path, capsys):
    argv = ["--synth", "--frames", "8", "--block", "16384", "--csv",
            "{s.csv}", "--waterfall", "{w.png}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_rfft.main, realtime_fft.main,
                          argv, ["s.csv", "w.png"])
    assert jo == to
    assert same_csv(tf["s.csv"], jf["s.csv"]).shape == (8, 4096)
    same_png(tf["w.png"], jf["w.png"])


# the JAX apps' UDP read takes whole packets only and waits forever once
# a block needs less than one, so the JAX side runs at blocks that are a
# whole number of packets (368 samples): 256 packets = 23 FFTs of 4096,
# 32 packets = 23 FAC frames of 512
PACKET = udp.DEFAULT_PAYLOAD // 4
RFFT_WIRE_BLOCK = 256 * PACKET
FAC_WIRE_BLOCK = 32 * PACKET


def test_realtime_fft_input_and_udp(tmp_path, capsys, monkeypatch):
    """--input over a capture: the JAX app and the port's agree; the
    port's --udp-port run over the same samples on the wire, at a block
    that ends inside a packet, writes the same CSV and image."""
    x = spectral_signal(3 * 16384)
    cap = tmp_path / "cap.c64"
    x.tofile(str(cap))
    argv = ["--frames", "8", "--block", "16384", "--csv", "{s.csv}",
            "--waterfall", "{w.png}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_rfft.main, realtime_fft.main,
                          ["--input", str(cap)] + argv, ["s.csv", "w.png"])
    assert jo == to
    same_csv(tf["s.csv"], jf["s.csv"])
    same_png(tf["w.png"], jf["w.png"])
    uo, uf = _udp_app(tmp_path, capsys, monkeypatch, udp, realtime_fft.main,
                      argv, ["s.csv", "w.png"], x, "udp", ["--device", "cpu"])
    assert uo == to
    assert open(uf["s.csv"]).read() == open(tf["s.csv"]).read()
    assert open(uf["w.png"], "rb").read() == open(tf["w.png"], "rb").read()


def test_realtime_fft_udp_against_jax(tmp_path, capsys, monkeypatch):
    x = spectral_signal(2 * RFFT_WIRE_BLOCK)
    argv = ["--frames", "30", "--block", str(RFFT_WIRE_BLOCK), "--csv",
            "{s.csv}", "--waterfall", "{w.png}"]
    jo, to, jf, tf = _udp_both(tmp_path, capsys, monkeypatch, j_rfft.main,
                               realtime_fft.main, argv, ["s.csv", "w.png"],
                               x)
    assert jo == to
    assert same_csv(tf["s.csv"], jf["s.csv"]).shape == (30, 4096)
    same_png(tf["w.png"], jf["w.png"])


def same_fac_out(a, b, size=512):
    """fac's stdout: the FAC of a real signal's |FFT| is symmetric, bins k
    and size - k tie in exact arithmetic, so the printed strongest bin
    may be either of the pair; the rest of the line is equal."""
    key = "strongest correlation at bin"
    ha, ta = a.split(key)
    hb, tb = b.split(key)
    ka, kb = int(ta.split()[0]), int(tb.split()[0])
    assert ha == hb and ta.split()[1:] == tb.split()[1:]
    assert min(ka, size - ka) == min(kb, size - kb)
    return ka


def test_fac_synth(tmp_path, capsys):
    argv = ["--frames", "4", "--block", "16384", "--csv", "{f.csv}",
            "--png", "{f.png}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_fac.main, fac.main, argv,
                          ["f.csv", "f.png"])
    bin_ = same_fac_out(jo, to)
    assert min(bin_, 512 - bin_) % 50 == 0 and bin_ > 0
    same_csv(tf["f.csv"], jf["f.csv"])
    same_png(tf["f.png"], jf["f.png"])


def test_fac_input_and_udp(tmp_path, capsys, monkeypatch):
    x = pulse_signal(24 * 16384)
    cap = tmp_path / "cap.c64"
    x.tofile(str(cap))
    argv = ["--frames", "3", "--block", "16384", "--csv", "{f.csv}",
            "--png", "{f.png}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_fac.main, fac.main,
                          ["--input", str(cap)] + argv, ["f.csv", "f.png"])
    same_fac_out(jo, to)
    same_csv(tf["f.csv"], jf["f.csv"])
    same_png(tf["f.png"], jf["f.png"])
    uo, uf = _udp_app(tmp_path, capsys, monkeypatch, udp, fac.main, argv,
                      ["f.csv", "f.png"], x, "udp", ["--device", "cpu"])
    assert uo == to
    assert open(uf["f.csv"]).read() == open(tf["f.csv"]).read()


def test_fac_udp_against_jax(tmp_path, capsys, monkeypatch):
    x = pulse_signal(30 * FAC_WIRE_BLOCK)
    argv = ["--frames", "3", "--block", str(FAC_WIRE_BLOCK), "--csv",
            "{f.csv}", "--png", "{f.png}"]
    jo, to, jf, tf = _udp_both(tmp_path, capsys, monkeypatch, j_fac.main,
                               fac.main, argv, ["f.csv", "f.png"], x)
    same_fac_out(jo, to)
    same_csv(tf["f.csv"], jf["f.csv"])
    same_png(tf["f.png"], jf["f.png"])


# -- am_fft, scanner, papr --------------------------------------------------

def test_am_fft_synth(tmp_path, capsys):
    argv = ["--blocks", "2", "--block", "16384", "-f", "100e3", "-o",
            "{am.wav}", "--csv", "{am.csv}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_am.main, am_fft.main, argv,
                          ["am.wav", "am.csv"])
    assert jo == to
    pcm = same_wav(tf["am.wav"], jf["am.wav"])
    assert abs(tone_hz(pcm, 64e3) - 1000.0) < 70.0
    spectra = same_csv(tf["am.csv"], jf["am.csv"])
    assert np.argmax(spectra[-1]) == 512   # the carrier, in the centre bin


def test_am_fft_input(tmp_path, capsys):
    rng = np.random.default_rng(8)
    n = 3 * 16384
    t = np.arange(n) / 1.024e6
    x = (0.5 * (1 + 0.6 * np.sin(2 * np.pi * 800 * t))
         * np.exp(2j * np.pi * -150e3 * t)
         + 0.005 * rng.standard_normal(n)).astype(np.complex64)
    cap = tmp_path / "cap.c64"
    x.tofile(str(cap))
    argv = ["--input", str(cap), "--blocks", "3", "--block", "16384",
            "--freq=-150e3", "-o", "{am.wav}", "--csv", "{am.csv}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_am.main, am_fft.main, argv,
                          ["am.wav", "am.csv"])
    assert jo == to
    pcm = same_wav(tf["am.wav"], jf["am.wav"])
    assert abs(tone_hz(pcm, 64e3) - 800.0) < 70.0
    same_csv(tf["am.csv"], jf["am.csv"])


def test_scanner_synth(capsys):
    argv = ["--blocks", "2", "--block", "8192"]
    jo, to, _, _ = both(None, capsys, j_scan.main, scanner.main, argv)
    assert jo == to
    assert "-300.0 kHz : 2/2" in to and "+100.0 kHz : 2/2" in to


def test_scanner_input(tmp_path, capsys):
    rng = np.random.default_rng(6)
    n = 3 * 8192
    t = np.arange(n) / 1.024e6
    x = sum(0.5 * np.exp(2j * np.pi * f * t) for f in (-200e3, 300e3))
    x = (x + 0.002 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    cap = tmp_path / "cap.c64"
    x.tofile(str(cap))
    argv = ["--input", str(cap), "--blocks", "3", "--block", "8192"]
    jo, to, _, _ = both(tmp_path, capsys, j_scan.main, scanner.main, argv)
    assert jo == to
    assert "-200.0 kHz : 3/3" in to and "+300.0 kHz : 3/3" in to


def _same_papr(jo, to):
    a = json.loads(jo.strip().splitlines()[-1])
    b = json.loads(to.strip().splitlines()[-1])
    assert a["samples"] == b["samples"]
    assert a["papr_db"] == b["papr_db"]
    assert a["papr_ma_db"] == b["papr_ma_db"]
    for k in ("avg_power", "peak_power"):
        assert b[k] == pytest.approx(a[k], rel=1e-6)
    return b


def test_papr_synth(tmp_path, capsys):
    argv = ["-T", "16384", "--csv", "{c.csv}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_papr.main, papr.main, argv,
                          ["c.csv"])
    rep = _same_papr(jo, to)
    assert 2.0 < rep["papr_db"] < 12.0
    assert open(tf["c.csv"]).readline() == "db_above_avg,prob\n"
    ccdf = np.loadtxt(tf["c.csv"], delimiter=",", skiprows=1)
    want = np.loadtxt(jf["c.csv"], delimiter=",", skiprows=1)
    np.testing.assert_allclose(ccdf, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ["c8", "c64", "i16", "u8"])
def test_papr_input(tmp_path, capsys, fmt):
    rng = np.random.default_rng(7)
    n = 20000
    raw = {"c8": rng.integers(-128, 127, 2 * n, dtype=np.int8),
           "c64": (0.3 * rng.standard_normal(2 * n)).astype(np.float32),
           "i16": rng.integers(-20000, 20000, 2 * n, dtype=np.int16),
           "u8": rng.integers(0, 256, 2 * n, dtype=np.uint8)}[fmt]
    cap = tmp_path / f"cap.{fmt}"
    raw.tofile(str(cap))
    argv = [str(cap), "-t", fmt, "-T", "16384", "-w", "33", "--csv",
            "{c.csv}"]
    jo, to, jf, tf = both(tmp_path, capsys, j_papr.main, papr.main, argv,
                          ["c.csv"])
    assert _same_papr(jo, to)["samples"] == 16384
    np.testing.assert_allclose(
        np.loadtxt(tf["c.csv"], delimiter=",", skiprows=1),
        np.loadtxt(jf["c.csv"], delimiter=",", skiprows=1), rtol=0,
        atol=1e-5)


def test_papr_moving_average_matches_numpy_same():
    """The port's moving average is numpy's convolve(mode="same") with a
    box of w taps, even and odd w."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(500).astype(np.float32)
    for w in (1, 4, 7, 256):
        ma = papr.analyze(torch.from_numpy(x), torch.zeros(500), w)[2]
        want = np.convolve(x * x, np.ones(w) / w, mode="same").max()
        assert float(ma) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("app", ["rtl_fm", "realtime_fft", "fac", "am_fft",
                                 "scanner", "papr"])
def test_cuda_device_without_card_raises(app, tmp_path):
    main = dict(rtl_fm=rtl_fm.main, realtime_fft=realtime_fft.main,
                fac=fac.main, am_fft=am_fft.main, scanner=scanner.main,
                papr=papr.main)[app]
    argv = dict(rtl_fm=["--synth", "-o", str(tmp_path / "a.wav")],
                realtime_fft=["--synth"]).get(app, [])
    from grbaz_tpu_torch.core.device import resolve_device
    if torch.cuda.is_available():   # the default device is the card
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv + ["--device", "cuda"])
