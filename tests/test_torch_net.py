"""The port's network plane (``grbaz_tpu_torch/net``) against the JAX
package's, on loopback: the UDP wire format in BorIP and ATA modes for
the native and Python arms, drop detection, the ishort conversion, the
BorIP server's verbs, streaming and teardown, and each package's sender,
receiver, client and server against the other's."""

import socket
import threading
import time

import numpy as np
import pytest

from grbaz_tpu.net import borip_server as jserver
from grbaz_tpu.net import udp as judp
from grbaz_tpu.net.borip_client import RemoteDevice as JRemoteDevice
from grbaz_tpu_torch.core.stream import stream_flags
from grbaz_tpu_torch.net import devices, udp
from grbaz_tpu_torch.net.borip_client import RemoteDevice
from grbaz_tpu_torch.net.borip_server import BorIPServer

WAIT_S = 20.0   # every wait has a deadline well inside the test's time


def _wait(cond, timeout=WAIT_S, dt=0.005):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(dt)
    return True


@pytest.fixture(params=["native", "python"])
def impl(request):
    return dict(force_python=request.param == "python")


def _tone(n, f=0.01, amp=0.5):
    return (np.exp(2j * np.pi * f * np.arange(n)) * amp).astype(np.complex64)


def test_native_engine_builds_into_the_port_build_dir():
    from grbaz_tpu_torch import native
    rx = udp.UDPSampleReceiver(port=0)
    try:
        assert rx._lib is not None
        path = native.library_path("boripnet", "boripnet.cc")
        assert path.exists() and path.parent == native.BUILD_DIR
        assert path.parent.name == "_build"
    finally:
        rx.close()


def test_udp_loopback_roundtrip(impl):
    rx = udp.UDPSampleReceiver(port=0, bor=True, **impl)
    tx = udp.UDPSampleSender("127.0.0.1", rx.port, bor=True, **impl)
    x = _tone(4096)
    tx.send_complex(x)
    assert _wait(lambda: rx.stats()["packets"] >= 12)
    got, flags = rx.read_complex(len(x))
    assert len(got) == len(x)
    assert np.max(np.abs(got - x)) < 2e-4   # i16 quantization only
    assert flags & stream_flags.STREAM_START
    assert rx.stats()["dropped"] == 0
    tx.close()
    rx.close()


def test_udp_wire_format_exact(impl):
    """The BorIP header on the wire is {u8 flags, u8 notif, u16 seq LE}."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(WAIT_S)
    port = sock.getsockname()[1]
    tx = udp.UDPSampleSender("127.0.0.1", port, bor=True, payload_size=64,
                             **impl)
    tx.send_bytes(b"\x11" * 100)  # 2 packets: 64 + 36
    p1, _ = sock.recvfrom(2048)
    p2, _ = sock.recvfrom(2048)
    f1, _, i1 = udp.BOR_HEADER.unpack(p1[:4])
    _, _, i2 = udp.BOR_HEADER.unpack(p2[:4])
    assert f1 & stream_flags.STREAM_START
    assert i2 == (i1 + 1) & 0xFFFF
    assert len(p1) == 4 + 64 and len(p2) == 4 + 36
    assert p1[4:] == b"\x11" * 64 and p2[4:] == b"\x11" * 36
    tx.end_stream()
    p3, _ = sock.recvfrom(2048)
    f3, _, i3 = udp.BOR_HEADER.unpack(p3)
    assert f3 == stream_flags.STREAM_END | stream_flags.EMPTY_PAYLOAD
    assert i3 == (i2 + 1) & 0xFFFF and len(p3) == 4
    tx.close()
    sock.close()


def test_udp_drop_detection(impl):
    """A skipped seq number raises the dropped count and NETWORK_OVERRUN."""
    rx = udp.UDPSampleReceiver(port=0, bor=True, **impl)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dest = ("127.0.0.1", rx.port)
    payload = b"\x00" * 16
    hdr = udp.BOR_HEADER
    sock.sendto(hdr.pack(stream_flags.STREAM_START, 0, 0) + payload, dest)
    sock.sendto(hdr.pack(0, 0, 1) + payload, dest)
    sock.sendto(hdr.pack(0, 0, 4) + payload, dest)  # 2 and 3 lost
    assert _wait(lambda: rx.stats()["packets"] >= 3)
    data, flags = rx.read_bytes(4096)
    assert data == payload * 3
    assert rx.stats()["dropped"] == 2
    assert flags & stream_flags.NETWORK_OVERRUN
    rx.close()
    sock.close()


def test_udp_ata_mode(impl):
    """ATA dialect: 64-byte header, u32 seq, stream metadata carried."""
    rx = udp.UDPSampleReceiver(port=0, mode=udp.MODE_ATA, **impl)
    tx = udp.UDPSampleSender("127.0.0.1", rx.port, mode=udp.MODE_ATA,
                             payload_size=256, **impl)
    tx.set_ata_meta(freq=1.42e9, rate=104.8576e6, chan=7)
    tx.send_bytes(b"\xab" * 600)  # 3 packets: 256 + 256 + 88
    assert _wait(lambda: rx.stats()["packets"] >= 3)
    data, flags = rx.read_bytes(4096)
    assert data == b"\xab" * 600
    assert rx.stats()["dropped"] == 0
    info = rx.ata_info()
    assert info["freq"] == pytest.approx(1.42e9)
    assert info["sample_rate"] == pytest.approx(104.8576e6)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    hdr = udp.ATA_HEADER.pack(0, 1, 16, 0, 0, 0, 1, 0, 64, 0, 7, 100,
                              1.42e9, 104.8576e6, 1.0, 0.0, 12345, 0, 16)
    sock.sendto(hdr + b"\x00" * 16, ("127.0.0.1", rx.port))
    assert _wait(lambda: rx.stats()["packets"] >= 4)
    _, flags = rx.read_bytes(4096)
    assert rx.stats()["dropped"] == 100 - 3
    assert flags & stream_flags.NETWORK_OVERRUN
    assert rx.ata_info()["abs_time"] == 12345
    tx.close()
    rx.close()
    sock.close()


def test_udp_ata_wire_format_exact(impl):
    """The ATA header is the 64-byte packed layout with u32 seq/len."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(WAIT_S)
    port = sock.getsockname()[1]
    tx = udp.UDPSampleSender("127.0.0.1", port, mode=udp.MODE_ATA,
                             payload_size=128, **impl)
    tx.set_ata_meta(freq=100e6, rate=2e6, item_bytes=4)
    tx.send_bytes(b"\x22" * 200)  # 2 packets: 128 + 72
    p1, _ = sock.recvfrom(4096)
    p2, _ = sock.recvfrom(4096)
    assert len(p1) == 64 + 128 and len(p2) == 64 + 72
    h1 = udp.ATA_HEADER.unpack(p1[:64])
    h2 = udp.ATA_HEADER.unpack(p2[:64])
    # (seq, freq, rate, absTime, len) positions: 11, 12, 13, 16, 18
    assert h1[11] == 0 and h2[11] == 1
    assert h1[12] == pytest.approx(100e6) and h1[13] == pytest.approx(2e6)
    assert h1[16] == 0 and h2[16] == 128 // 4
    assert h1[18] == 128 and h2[18] == 72
    assert p1[64:] == b"\x22" * 128
    tx.close()
    sock.close()


def test_ishort_conversion_roundtrip():
    rng = np.random.default_rng(0)
    x = (np.clip(rng.standard_normal(256), -1, 1)
         + 1j * np.clip(rng.standard_normal(256), -1, 1)).astype(np.complex64)
    wire = udp.complex_to_ishort_bytes(x)
    assert wire == judp.complex_to_ishort_bytes(x)
    back = udp.ishort_bytes_to_complex(wire)
    assert np.max(np.abs(back - x)) < 1e-4
    np.testing.assert_array_equal(back, judp.ishort_bytes_to_complex(wire))


@pytest.mark.parametrize("mode", ["bor", "ata"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_udp_cross_package_bytes_equal(mode, direction):
    """Each package's sender feeds the other's receiver: the bytes out
    equal the bytes in, in BorIP and ATA modes."""
    kw = dict(bor=True) if mode == "bor" else dict(mode=udp.MODE_ATA)
    rx_mod, tx_mod = (udp, judp) if direction == "jax_to_port" \
        else (judp, udp)
    rx = rx_mod.UDPSampleReceiver(port=0, **kw)
    tx = tx_mod.UDPSampleSender("127.0.0.1", rx.port, **kw)
    data = np.random.default_rng(7).integers(
        0, 256, 20 * udp.DEFAULT_PAYLOAD + 100, dtype=np.uint8).tobytes()
    for i in range(0, len(data), 4 * udp.DEFAULT_PAYLOAD):
        tx.send_bytes(data[i:i + 4 * udp.DEFAULT_PAYLOAD])
        assert _wait(lambda: rx.stats()["packets"]
                     >= -(-min(i + 4 * udp.DEFAULT_PAYLOAD, len(data))
                          // udp.DEFAULT_PAYLOAD))
    got, flags = rx.read_bytes(len(data))
    assert got == data
    assert rx.stats()["dropped"] == 0
    tx.close()
    rx.close()


def test_read_bytes_equal_to_the_jax_receiver():
    """The port's read_bytes (the ring drained through a numpy buffer)
    returns the bytes the JAX receiver's ``bytes(buf[:n])`` returns on the
    same packets, read in the same pieces."""
    rxs = [udp.UDPSampleReceiver(port=0), judp.UDPSampleReceiver(port=0)]
    assert rxs[0]._lib is not None and rxs[1]._lib is not None
    tx = udp.UDPSampleSender(bor=True)
    x = np.random.default_rng(3).standard_normal(8192).astype(np.float32)
    wire = udp.complex_to_ishort_bytes((0.3 * (x[::2] + 1j * x[1::2]))
                                       .astype(np.complex64))
    for rx in rxs:
        tx.connect("127.0.0.1", rx.port)
        tx.send_bytes(wire)
        n = -(-len(wire) // udp.DEFAULT_PAYLOAD)
        assert _wait(lambda: rx.stats()["packets"] >= n)
    pieces = [1000, udp.DEFAULT_PAYLOAD, 3 * udp.DEFAULT_PAYLOAD + 5, 1 << 20]
    outs = [[rx.read_bytes(m) for m in pieces] for rx in rxs]
    assert [b for b, _ in outs[0]] == [b for b, _ in outs[1]]
    assert b"".join(b for b, _ in outs[0]) == wire
    assert len(outs[0][0][0]) == 0   # a read smaller than one packet
    tx.close()
    for rx in rxs:
        rx.close()


# -- the BorIP server and client -------------------------------------------

def _serve(server_cls):
    srv = server_cls(("127.0.0.1", 0))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def server():
    srv = _serve(BorIPServer)
    yield srv
    srv.shutdown()
    srv.server_close()


def _session(client_cls, port):
    """Each verb's answer and the tone bin of the streamed samples."""
    dev = client_cls("127.0.0.1", port, udp_port=0, keepalive=False)
    try:
        info = dev.select_device("synth tone_offset=5000 rate=100000 "
                                 "realtime=0 noise=0")
        answers = dict(
            info=info, freq=dev.set_freq(1.234e6), gain=dev.set_gain(10.0),
            rate=dev.set_sample_rate(100e3), antenna=dev.set_antenna("SYNTH"),
            ping=dev.command("PING"), bogus=dev.command("BOGUS"),
            header=dev.command("HEADER"), freq_q=dev.command("FREQ"),
            gain_q=dev.command("GAIN"), antenna_q=dev.command("ANTENNA"),
            rate_q=dev.command("RATE"))
        assert dev.start()
        answers["ping_running"] = dev.command("PING")
        x = dev.wait_samples(16384, timeout=WAIT_S)
        spec = np.abs(np.fft.fft(x * np.hanning(len(x))))
        answers["tone_bin"] = int(np.argmax(spec))
        answers["stop"] = dev.command("STOP")
        answers["go_again"] = dev.command("GO")
        answers["stop_again"] = dev.command("STOP")
    finally:
        dev.close()
    return answers


def test_server_verbs_and_streaming(server):
    got = _session(RemoteDevice, server.port)
    assert got["info"]["name"] == "Synthetic"
    assert got["info"]["serial"] == "SYN0001"
    assert got["info"]["gain_max"] == 30.0
    assert got["freq"] and got["gain"] and got["antenna"]
    assert got["rate"] == 100e3
    assert got["ping"] == "PONG" and got["ping_running"] == "PONG RUNNING"
    assert got["bogus"] == "UNKNOWN"
    assert got["header"] == "ON"
    assert float(got["freq_q"]) == 1.234e6
    assert got["tone_bin"] == round(0.05 * 16384)   # 5 kHz at 100 kS/s


@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_cross_package_client_and_server(pair):
    """The port's client against the JAX server, and the JAX client
    against the port's server: the same answers, the same tone bin, as
    each package against itself."""
    client, srv_cls = ((RemoteDevice, jserver.BorIPServer)
                       if pair == "port_client_jax_server"
                       else (JRemoteDevice, BorIPServer))
    srv = _serve(srv_cls)
    ref = _serve(jserver.BorIPServer)
    try:
        got = _session(client, srv.port)
        want = _session(JRemoteDevice, ref.port)
    finally:
        for s in (srv, ref):
            s.shutdown()
            s.server_close()
    assert got == want


def test_server_verbs_without_device(server):
    dev = RemoteDevice("127.0.0.1", server.port, udp_port=0, keepalive=False)
    assert dev.command("FREQ 1e6") == "DEVICE"
    assert dev.command("GO") == "DEVICE"
    assert dev.command("STOP") == "DEVICE"
    resp = dev.command("DEVICE nosuchdevice")
    assert resp.startswith("-")
    assert dev.command("PING").startswith("PONG")
    dev.close()


def test_server_device_teardown_on_disconnect(server):
    dev = RemoteDevice("127.0.0.1", server.port, udp_port=0, keepalive=False)
    dev.select_device("synth realtime=0")
    dev.start()
    dev.close()
    dev2 = RemoteDevice("127.0.0.1", server.port, udp_port=0, keepalive=False)
    assert dev2.command("PING").startswith("PONG")
    dev2.close()


def test_rtl_hint_raises_rather_than_substitute(server):
    """The hints ``rtl`` and ``rtl_sdr`` open the port's own RTL2832
    driver, never another device in its place: ``create_device`` returns
    the port's RTLSource, and the BorIP ``DEVICE rtl ...`` verb opens it
    through the port's server (a hint the driver refuses still raises)."""
    from grbaz_tpu_torch.io.rtl_source import RTLSource
    for hint in ("rtl transport=sim", "rtl_sdr transport=sim tuner=e4000"):
        d = devices.create_device(hint)
        try:
            assert type(d) is RTLSource
            assert d.tuner_name() == ("e4000" if "e4000" in hint
                                      else "r820t")
        finally:
            d.close()
    with pytest.raises(ValueError, match="unknown transport"):
        devices.create_device("rtl transport=nosuch")
    dev = RemoteDevice("127.0.0.1", server.port, udp_port=0, keepalive=False)
    try:
        resp = dev.command("DEVICE rtl transport=sim tuner=fc0013")
        assert not resp.startswith("-"), resp
        assert "RTL2832 (fc0013)" in resp
        assert dev.command("RATE 2048000").startswith("OK")
    finally:
        dev.close()


def test_device_registry_and_file_device(tmp_path):
    assert isinstance(devices.create_device(""), devices.SyntheticDevice)
    x = _tone(1000)
    p = tmp_path / "cap.c64"
    x.tofile(str(p))
    fd = devices.create_device(f"file {p} rate=1000 loop=0")
    assert isinstance(fd, devices.FileDevice) and fd.sample_rate() == 1000
    got = fd.read_samples(1200)
    np.testing.assert_array_equal(got[:1000], x)
    assert np.all(got[1000:] == 0)
    syn = devices.SyntheticDevice(tone_offset=1e3, rate=8e3, realtime=False,
                                  seed=4)
    from grbaz_tpu.net.devices import SyntheticDevice as JSyn
    jsyn = JSyn(tone_offset=1e3, rate=8e3, realtime=False, seed=4)
    np.testing.assert_array_equal(syn.read_samples(500),
                                  jsyn.read_samples(500))
