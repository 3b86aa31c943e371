"""The port's TCP frame plane (``grbaz_tpu_torch/net/tcp.py`` over
``native/tcpframe.cc``) and its legacy USRP shim pass the JAX package's
tests, and speak the JAX package's wire.

The first section repeats ``tests/test_net.py:208-407`` on the port's
copies (the Python and native frame sinks and sources, reconnects, and
the ``usrp.source_c`` BorIP fallback against the port's server). The
second sends frames from the port's native sink to the JAX native
source, and from the JAX Python sink to the port's native source, and
holds samples and tags equal.
"""

import threading
import time

import numpy as np
import pytest

from grbaz_tpu_torch.net.borip_server import BorIPServer


def _wait(cond, timeout=5.0, dt=0.01):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(dt)
    return True


# -------------------------------------------------------------------------
# tests/test_net.py's TCP and USRP-shim tests on the port's copies
# -------------------------------------------------------------------------

def test_tcp_frames_with_tags():
    from grbaz_tpu_torch.net.tcp import TCPFrameSink, TCPFrameSource
    src = TCPFrameSource(port=0, dtype=np.complex64)
    sink = TCPFrameSink("127.0.0.1", src.port)
    x1 = (np.arange(100) + 1j).astype(np.complex64)
    x2 = (np.arange(50) * 2.0).astype(np.complex64)
    assert sink.send_samples(x1, tags=[{"offset": 0, "key": "rx_time",
                                        "value": [12, 0.5]}])
    assert sink.send_samples(x2)
    sink.end_stream()

    def drain():
        frames = []
        t0 = time.monotonic()
        while len(frames) < 2 and time.monotonic() - t0 < 5:
            d, tags = src.read()
            if len(d):
                frames.append((d, tags))
            else:
                time.sleep(0.01)
        return frames

    frames = drain()
    assert len(frames) == 2
    d1, t1 = frames[0]
    np.testing.assert_array_equal(d1, x1)
    assert t1[0]["key"] == "rx_time" and t1[0]["value"] == [12, 0.5]
    d2, t2 = frames[1]
    np.testing.assert_array_equal(d2, x2)
    assert t2 == []
    assert _wait(lambda: src.stream_ended())
    sink.close()
    src.close()


def test_tcp_source_accepts_reconnect():
    from grbaz_tpu_torch.net.tcp import TCPFrameSink, TCPFrameSource
    src = TCPFrameSource(port=0, dtype=np.float32)
    s1 = TCPFrameSink("127.0.0.1", src.port)
    s1.send_samples(np.ones(10, np.float32))
    s1.close()
    time.sleep(0.3)
    s2 = TCPFrameSink("127.0.0.1", src.port)  # second client after first left
    s2.send_samples(np.full(5, 2.0, np.float32))
    t0 = time.monotonic()
    seen = []
    while len(seen) < 2 and time.monotonic() - t0 < 5:
        d, _ = src.read()
        if len(d):
            seen.append(d)
        time.sleep(0.01)
    assert len(seen) == 2
    np.testing.assert_array_equal(seen[1], np.full(5, 2.0, np.float32))
    s2.close()
    src.close()


# ---------------------------------------------------------------------------
# native TCP frame engine (C++ tcpframe.cc) <-> Python protocol layer
# ---------------------------------------------------------------------------

def test_native_tcp_sink_to_native_source():
    import time
    from grbaz_tpu_torch.net.tcp import NativeTCPFrameSink, NativeTCPFrameSource

    src = NativeTCPFrameSource(port=0, dtype=np.complex64)
    sink = NativeTCPFrameSink("127.0.0.1", src.port)
    x1 = (np.arange(100) + 1j).astype(np.complex64)
    x2 = (np.arange(100, 300) - 2j).astype(np.complex64)
    assert sink.send_samples(x1, tags=[{"offset": 0, "tags": {"rx_freq": 100e6}}])
    assert sink.send_samples(x2)
    sink.end_stream()

    got, tags = [], []
    deadline = time.time() + 5
    while time.time() < deadline and (sum(len(g) for g in got) < 300
                                      or not src.stream_ended()):
        s, t = src.read()
        if len(s):
            got.append(s)
        tags.extend(t)
        time.sleep(0.01)
    y = np.concatenate(got) if got else np.zeros(0, np.complex64)
    np.testing.assert_array_equal(y, np.concatenate([x1, x2]))
    assert any(t.get("tags", {}).get("rx_freq") == 100e6 for t in tags)
    assert src.stream_ended()
    st = src.stats()
    assert st["frames"] == 2 and st["bytes"] == 300 * 8
    sink.close()
    src.close()


def test_native_tcp_interop_with_python_layer():
    """Python TCPFrameSink -> native source, and native sink -> Python
    TCPFrameSource: both directions speak the same wire format."""
    import time
    from grbaz_tpu_torch.net.tcp import (NativeTCPFrameSink, NativeTCPFrameSource,
                                   TCPFrameSink, TCPFrameSource)

    # python -> native
    nsrc = NativeTCPFrameSource(port=0, dtype=np.float32)
    psink = TCPFrameSink("127.0.0.1", nsrc.port)
    x = np.linspace(0, 1, 257, dtype=np.float32)
    assert psink.send_samples(x, tags=[{"offset": 3, "tags": {"k": "v"}}])
    got, tags = [], []
    deadline = time.time() + 5
    while time.time() < deadline and sum(len(g) for g in got) < len(x):
        s, t = nsrc.read()
        if len(s):
            got.append(s)
        tags.extend(t)
        time.sleep(0.01)
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert tags and tags[0]["tags"] == {"k": "v"}
    psink.close()
    nsrc.close()

    # native -> python
    psrc = TCPFrameSource(port=0, dtype=np.float32)
    nsink = NativeTCPFrameSink("127.0.0.1", psrc.port)
    assert nsink.send_samples(x, tags=[{"offset": 0, "tags": {"q": 7}}])
    deadline = time.time() + 5
    while time.time() < deadline:
        s, t = psrc.read()
        if len(s):
            np.testing.assert_array_equal(s, x)
            assert t and t[0]["tags"] == {"q": 7}
            break
        time.sleep(0.01)
    else:
        raise AssertionError("python source never got the native frame")
    nsink.close()
    psrc.close()


def test_native_tcp_sink_reconnect():
    import time
    from grbaz_tpu_torch.net.tcp import NativeTCPFrameSink, NativeTCPFrameSource

    src = NativeTCPFrameSource(port=0, dtype=np.float32)
    port = src.port
    sink = NativeTCPFrameSink("127.0.0.1", port, auto_reconnect=True)
    x = np.ones(16, np.float32)
    assert sink.send_samples(x)
    time.sleep(0.2)
    src.close()  # drop the receiver
    time.sleep(0.2)
    sink.send_samples(x)  # fails (maybe after a buffered success)
    time.sleep(0.2)
    for _ in range(5):
        if not sink.send_samples(x):
            break
        time.sleep(0.1)
    # bring a new receiver up on the same port; sink must reconnect
    src2 = NativeTCPFrameSource(port=port, dtype=np.float32)
    deadline = time.time() + 5
    ok = False
    while time.time() < deadline and not ok:
        ok = sink.send_samples(x)
        time.sleep(0.1)
    assert ok, "sink never reconnected"
    deadline = time.time() + 5
    while time.time() < deadline:
        s, _ = src2.read()
        if len(s):
            np.testing.assert_array_equal(s, x)
            break
        time.sleep(0.05)
    else:
        raise AssertionError("no data after reconnect")
    sink.close()
    src2.close()


def test_usrp_shim_transparent_borip_fallback(monkeypatch):
    """A bare legacy ``usrp.source_c()`` silently becomes a remote BorIP
    device when [borip] server is configured — the reference's
    monkey-patch fallback (python/borip.py:561-573)."""
    srv = BorIPServer(("127.0.0.1", 0),
                      default_device="synth rate=100000 realtime=0")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv("GRBAZ_BORIP_SERVER",
                           f"127.0.0.1:{srv.server_address[1]}")
        from grbaz_tpu_torch.compat import usrp
        u = usrp.source_c(decim_rate=640)  # 64 MHz / 640 = 100 kS/s
        assert type(u._dev).__name__ == "BorIPRemoteDevice"
        assert u.adc_freq() == 64e6
        sub = u.pick_rx_subdevice() if hasattr(u, "pick_rx_subdevice") \
            else None
        tr = u.tune(0, u.selected_subdev((0, 0)), 1.5e6)
        assert tr is not None
        # streaming: samples arrive over the BorIP UDP plane
        assert u._dev.start()
        x = u._dev.read_samples(256)
        assert len(x) == 256 and x.dtype == np.complex64
        u._dev.close()
    finally:
        srv.shutdown()
        srv.server_close()


# -------------------------------------------------------------------------
# the port's TCP frame plane against the JAX package's
# -------------------------------------------------------------------------

WAIT_S = 20.0


def _drain(src, n_items, deadline_s=WAIT_S, need_end=False):
    """Read ``src`` until it has ``n_items`` samples (and, with
    ``need_end``, its stream end): (samples, tags)."""
    got, tags = [], []
    deadline = time.monotonic() + deadline_s
    while sum(len(g) for g in got) < n_items or (
            need_end and not src.stream_ended()):
        assert time.monotonic() < deadline, "the source stalled"
        s, t = src.read()
        if len(s):
            got.append(s)
        tags.extend(t)
        time.sleep(0.005)
    return np.concatenate(got), tags


def _blocks(rng, n_blocks, n):
    return [(rng.standard_normal(n) + 1j * rng.standard_normal(n))
            .astype(np.complex64) for _ in range(n_blocks)]


def test_port_native_sink_to_jax_native_source():
    from grbaz_tpu.net.tcp import NativeTCPFrameSource as JSource
    from grbaz_tpu_torch.net.tcp import NativeTCPFrameSink
    xs = _blocks(np.random.default_rng(1), 4, 3000)
    src = JSource(port=0, dtype=np.complex64)
    sink = NativeTCPFrameSink("127.0.0.1", src.port)
    try:
        assert sink._lib is not None
        for b, x in enumerate(xs):
            assert sink.send_samples(x, tags=[{"offset": 3000 * b,
                                               "value": b}])
        sink.end_stream()
        y, tags = _drain(src, 12000, need_end=True)
        np.testing.assert_array_equal(y, np.concatenate(xs))
        assert [(t["offset"], t["value"], t["_offset"]) for t in tags] == \
            [(3000 * b, b, 3000 * b * 8) for b in range(4)]
        assert src.stats()["ring_overruns"] == 0
        assert sink.stats()["frames"] == 9   # 4 tags, 4 data, the end
    finally:
        sink.close()
        src.close()


def test_jax_python_sink_to_port_native_source():
    from grbaz_tpu.net.tcp import TCPFrameSink as JSink
    from grbaz_tpu_torch.net.tcp import NativeTCPFrameSource
    xs = _blocks(np.random.default_rng(2), 3, 2048)
    src = NativeTCPFrameSource(port=0, dtype=np.complex64)
    sink = JSink("127.0.0.1", src.port)
    try:
        assert src._lib is not None
        for b, x in enumerate(xs):
            assert sink.send_samples(x, tags=[{"offset": 2048 * b,
                                               "tags": {"block": b}}])
        sink.end_stream()
        y, tags = _drain(src, 3 * 2048, need_end=True)
        np.testing.assert_array_equal(y, np.concatenate(xs))
        assert [(t["offset"], t["tags"], t["_offset"]) for t in tags] == \
            [(2048 * b, {"block": b}, 2048 * b * 8) for b in range(3)]
    finally:
        sink.close()
        src.close()


@pytest.mark.parametrize("port_sink", [True, False], ids=["port-to-jax",
                                                          "jax-to-port"])
def test_python_frame_layers_interoperate(port_sink):
    """The Python layers of the two packages, each way: frames, tags and
    the stream end."""
    from grbaz_tpu.net import tcp as jtcp
    from grbaz_tpu_torch.net import tcp as ttcp
    sink_mod, src_mod = (ttcp, jtcp) if port_sink else (jtcp, ttcp)
    src = src_mod.TCPFrameSource(port=0, dtype=np.float32)
    sink = sink_mod.TCPFrameSink("127.0.0.1", src.port)
    x = np.linspace(-1, 1, 513, dtype=np.float32)
    try:
        assert sink.send_samples(x, tags=[{"offset": 0, "key": "k",
                                           "value": [1, 2.5]}])
        sink.end_stream()
        deadline = time.monotonic() + WAIT_S
        while True:
            assert time.monotonic() < deadline, "no frame"
            d, tags = src.read()
            if len(d):
                break
            time.sleep(0.01)
        np.testing.assert_array_equal(d, x)
        assert tags[0]["key"] == "k" and tags[0]["value"] == [1, 2.5]
        assert _wait(src.stream_ended, timeout=WAIT_S)
    finally:
        sink.close()
        src.close()


def test_native_tcp_engine_builds_into_the_port_build_dir():
    from grbaz_tpu_torch import native
    lib = native.load_tcpframe()
    path = native.library_path("tcpframe", "tcpframe.cc")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert lib._name == str(path)
