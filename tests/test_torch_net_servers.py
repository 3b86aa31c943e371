"""The port's net servers and controllers (``grbaz_tpu_torch/net/
{rate_synchroniser,radar_server,message_server,control_server,
hw_control}.py``) pass the JAX package's tests, and agree with the JAX
modules.

The first sections repeat ``tests/test_radar_server.py``, the
event-to-message and GPSDO tests of ``tests/test_utils_misc.py``, the
message, control-server and hardware-control tests of
``tests/test_misc_obs.py`` and the rate-synchroniser test of
``tests/test_burst.py`` on the port's copies. The last holds them to the
JAX modules: the rate synchroniser's params equal, and the port's
FractionalResampler run with them equal to JAX's over several blocks;
``pack_detector_events`` over the port's RadarDetector rows (tensors)
byte-equal to JAX's over its own; the control server over the port's
tensor params; the message bridge over a tensor event block.
"""

import base64
import queue
import socket
import time

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.net.devices import SyntheticDevice
from grbaz_tpu_torch.net.hw_control import (FreqHopper, SoftwareAGC,
                                            delayed_start,
                                            finite_acquisition)
from grbaz_tpu_torch.net.message_server import MessageServer
from grbaz_tpu_torch.net.radar_server import (REPORT, RadarReportQueue,
                                              RadarServer, TSF_ROLLOVER,
                                              pack_detector_events,
                                              unpack_reports)
from grbaz_tpu_torch.net.rate_synchroniser import RateSynchroniser


# -------------------------------------------------------------------------
# tests/test_radar_server.py on the port's copy
# -------------------------------------------------------------------------

class FakeRadar:
    def __init__(self):
        self.freqs = []
        self.params = {}

    def set_freq(self, mhz):
        self.freqs.append(mhz)
        return True

    def set_param(self, name, value):
        self.params[name] = value


def _readlines(sock, n, timeout=10.0):
    sock.settimeout(timeout)
    buf = b""
    lines = []
    while len(lines) < n:
        chunk = sock.recv(4096)
        if not chunk:
            break
        buf += chunk
        while b"\n" in buf and len(lines) < n:
            line, buf = buf.split(b"\n", 1)
            lines.append(line.decode())
    return lines


def test_sweep_protocol_and_reports():
    radar = FakeRadar()
    q = RadarReportQueue()
    srv = RadarServer(radar, port=0, report_queue=q, detector=radar)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port))
        # detector param verbs route through set_param
        c.sendall(b"RSSI 34\nPHEIGHT 12\n")
        # reports that the dwell should pick up
        q.insert(REPORT.pack(100, 50, 3, 0, 0))
        q.insert(REPORT.pack(200, 60, 4, 0, 0))
        c.sendall(b"START 100 110 5 0.05\n")
        # sweep: 100, 105, 110 -> 3 DATA lines then END
        lines = _readlines(c, 4)
        assert [l.split()[0] for l in lines] == ["DATA"] * 3 + ["END"]
        freqs = [int(l.split()[1]) for l in lines[:3]]
        assert freqs == [100, 105, 110]
        assert radar.freqs[:3] == [100, 105, 110]
        assert radar.params == {"RSSI": 34, "PHEIGHT": 12}
        # reports inserted before the first dwell arrive in some DATA line
        # (first dwell clears on tune; re-inserted data shows up after)
        c.close()
    finally:
        srv.stop()


def test_fixed_freq_command():
    radar = FakeRadar()
    srv = RadarServer(radar, port=0)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port))
        c.sendall(b"FREQ 5260\n")
        (line,) = _readlines(c, 1)
        assert line == "FREQ 5260"
        assert radar.freqs == [5260]
        c.close()
    finally:
        srv.stop()


def test_data_payload_roundtrip():
    radar = FakeRadar()
    q = RadarReportQueue()
    srv = RadarServer(radar, port=0, report_queue=q)
    try:
        c = socket.create_connection(("127.0.0.1", srv.port))
        time.sleep(0.1)
        raw = REPORT.pack(1234, 77, 9, 1, 2)
        # single-frequency sweep: start==stop -> one DATA then END
        c.sendall(b"START 5000 5000 5 0.3\n")
        time.sleep(0.1)  # after tune+clear, inside the dwell
        q.insert(raw)
        lines = _readlines(c, 2)
        assert lines[0].startswith("DATA 5000 ")
        payload = base64.b64decode(lines[0].split()[2])
        assert payload == raw
        reps = unpack_reports(payload)
        assert reps[0].tsf == 1234 and reps[0].rssi == 77
        assert reps[0].width == 9 and reps[0].type == 1
        c.close()
    finally:
        srv.stop()


def test_tsf_rollover_unwrap():
    """Reports wrapping the 15-bit TSF must unwrap monotonically."""
    data = (REPORT.pack(30000, 1, 1, 0, 0)
            + REPORT.pack(100, 2, 1, 0, 0)      # rolled over
            + REPORT.pack(200, 3, 1, 0, 0))
    reps = unpack_reports(data)
    # earlier reports are shifted down by the rollover amount
    assert reps[0].tsf == 30000 - TSF_ROLLOVER
    assert reps[1].tsf == 100 and reps[2].tsf == 200
    assert reps[0].tsf < reps[1].tsf < reps[2].tsf


def test_pack_detector_events():
    data = pack_detector_events(starts=[1000], lengths=[5], maxima=[0.1],
                                sample_rate=1e6)
    reps = unpack_reports(data)
    assert reps[0].tsf == 1000  # 1000 samples @ 1 MHz = 1000 us
    assert reps[0].width == 5
    assert reps[0].rssi == 90  # 10log10(0.1)+100


# -------------------------------------------------------------------------
# tests/test_utils_misc.py:72, :102 on the port's copies
# -------------------------------------------------------------------------

def test_event_to_message():
    from grbaz_tpu_torch.net.message_server import EventToMessage
    q = queue.Queue()
    bridge = EventToMessage(q, appendix=" via radar")
    ev = np.array([[1, 2.5], [3, 4.5], [0, 0]], np.float32)
    n = bridge.post(ev, count=2)
    assert n == 2
    assert q.get_nowait().endswith(" via radar")
    assert "4.5" in q.get_nowait()
    assert q.empty()


def test_gpsdo_monitor():
    from grbaz_tpu_torch.net.hw_control import GPSDOMonitor
    t = [1000.0]
    state = dict(locked=False)

    def sensors():
        # gps time runs 1 ppm fast relative to host
        return dict(gps_time=t[0] * (1 + 1e-6), gps_locked=state["locked"],
                    ref_locked=True)

    mon = GPSDOMonitor(sensors, now=lambda: t[0])
    for i in range(10):
        if i == 3:
            state["locked"] = True
        mon.sample()
        t[0] += 1.0
    # drift: 1 ppm of 1 s interval = 1e-6 s/sample
    assert mon.drift() == pytest.approx(1e-6, rel=0.05)
    kinds = [(k, v) for _, k, v in mon.lock_transitions]
    assert ("gps_locked", False) in kinds   # first sample records state
    assert ("gps_locked", True) in kinds    # the lock transition
    assert len(mon.history) == 10


# -------------------------------------------------------------------------
# tests/test_misc_obs.py:140-210 and tests/test_burst.py:128 on the port's
# copies
# -------------------------------------------------------------------------

def test_message_server_broadcast():
    srv = MessageServer(("127.0.0.1", 0))
    c1 = socket.create_connection(("127.0.0.1", srv.port), 2)
    c2 = socket.create_connection(("127.0.0.1", srv.port), 2)
    time.sleep(0.2)
    n = srv.post("radar pulse start=123 len=40")
    assert n == 2
    for c in (c1, c2):
        c.settimeout(2)
        assert c.recv(100) == b"radar pulse start=123 len=40\n"
    c1.close()
    time.sleep(0.2)
    assert srv.post("second") >= 1
    c2.close()
    srv.close()


def test_control_server_xmlrpc():
    from xmlrpc.client import ServerProxy
    from grbaz_tpu_torch.net.control_server import ControlServer

    class Holder:
        params = {"resampler": dict(inc_int=np.int32(5),
                                    inc_frac=np.uint32(123))}

    h = Holder()
    cs = ControlServer(h, ("127.0.0.1", 0))
    cli = ServerProxy(f"http://127.0.0.1:{cs.port}")
    assert cli.list_params() == {"resampler": ["inc_frac", "inc_int"]}
    assert cli.get_param("resampler", "inc_int") == 5
    cli.set_resampler_inc_int(7)
    assert int(h.params["resampler"]["inc_int"]) == 7
    assert h.params["resampler"]["inc_int"].dtype == np.int32
    cs.close()


def test_freq_hopper_and_agc_and_acquire():
    tuned = []
    hopper = FreqHopper(tuned.append, [1e6, 2e6, 3e6], dwell=0.01,
                        drop_length=100, drop_callback=lambda n: None)
    for _ in range(5):
        hopper.hop()
    assert tuned == [1e6, 2e6, 3e6, 1e6, 2e6]

    gains = []
    agc = SoftwareAGC(gains.append, gain=10.0, target=0.5, hold_time=0.0)
    agc.feed(0.9)   # too hot -> step down
    agc.feed(0.96)  # saturated -> big backoff
    agc.feed(0.1)   # too cold -> step up
    assert gains == [9.0, 6.0, 7.0]

    dev = SyntheticDevice(tone_offset=1000.0, rate=100e3, realtime=False,
                          noise=0.0)
    x = finite_acquisition(dev, 5000, skip=100)
    assert len(x) == 5000 and not dev.is_running()
    spec = np.abs(np.fft.fft(x))
    assert abs(np.argmax(spec) / len(x) - 0.01) < 1e-3


def test_delayed_start_alignment():
    fake_now = [99.7]

    def clock():
        return fake_now[0]

    def sleeper(dt):
        fake_now[0] += dt

    t = delayed_start(offset=0.25, clock=clock, sleeper=sleeper)
    assert t == 100.25
    assert abs(fake_now[0] - 100.25) < 0.02


def test_rate_synchroniser_locks_and_corrects():
    rs = RateSynchroniser(target_period=100.0, base_ratio=5.0,
                          alpha=0.3, lock_window=8, lock_sd=1e-3)
    # stream runs 0.1% fast: measured period 100.1
    updates = 0
    for _ in range(50):
        p = rs.feed(100.1)
        if p is not None:
            updates += 1
    assert rs.locked
    assert updates < 50  # corrections stop after lock
    ip, fp = rs.ppb()
    assert abs((ip + fp) / 1e9 - 5.005) < 1e-3
    # params are exact fixed-point for the resampler
    pr = rs.params()
    assert "inc_int" in pr and "inc_frac" in pr
    # glitch rejection
    before = rs.ewma
    rs.feed(200.0)
    assert rs.ewma == before


# -------------------------------------------------------------------------
# the port's copies against the JAX modules
# -------------------------------------------------------------------------

def _periods(n, seed):
    """A period measurement stream: a 0.1% fast clock with jitter and a
    glitch."""
    rng = np.random.default_rng(seed)
    p = 100.1 + 0.01 * rng.standard_normal(n)
    p[n // 3] = 180.0
    return p


def test_rate_synchroniser_params_equal_jax():
    from grbaz_tpu.net.rate_synchroniser import RateSynchroniser as JRS
    kw = dict(target_period=100.0, base_ratio=3.2e6 / 48e3 / 8, alpha=0.2,
              lock_window=8, lock_sd=2e-4)
    rs, jrs = RateSynchroniser(**kw), JRS(**kw)
    for p in _periods(60, 3):
        a, b = rs.feed(p), jrs.feed(p)
        assert (a is None) == (b is None)
        if a is not None:
            assert {k: (type(v), v) for k, v in a.items()} == \
                {k: (type(v), v) for k, v in b.items()}
        assert rs.ewma == jrs.ewma and rs.locked == jrs.locked
        assert rs.ppb() == jrs.ppb()
    assert rs.locked and rs.updates == jrs.updates


def test_rate_synchroniser_params_drive_the_ports_resampler():
    """Each correction, fed to the port's FractionalResampler and to the
    JAX one between blocks, gives JAX's output over several blocks
    (counts, q and mu equal, samples within 1e-5 of the max)."""
    import jax
    import jax.numpy as jnp

    from grbaz_tpu.core.stream import Stream as JStream
    from grbaz_tpu.net.rate_synchroniser import RateSynchroniser as JRS
    from grbaz_tpu.ops.resampler import FractionalResampler as JFR
    from grbaz_tpu_torch.convert import params_from_numpy
    from grbaz_tpu_torch.core.stream import Stream
    from grbaz_tpu_torch.ops.resampler import FractionalResampler

    n, ratio = 4096, 250e3 / 48e3
    kw = dict(target_period=100.0, base_ratio=ratio, alpha=0.3,
              lock_window=4, lock_sd=1e-3)
    rs, jrs = RateSynchroniser(**kw), JRS(**kw)
    port = FractionalResampler(n, ratio, device="cpu")
    jfr = JFR(n, ratio)
    st, pr = port.init_state(), port.init_params()
    jst = jax.tree_util.tree_map(jnp.asarray, jfr.init_state())
    jpr = jfr.init_params()
    rng = np.random.default_rng(9)
    periods = _periods(6, 4)
    for b in range(6):
        a, j = rs.feed(periods[b]), jrs.feed(periods[b])
        if a is not None:
            pr = params_from_numpy(a, "cpu")
            jpr = j
        x = rng.standard_normal(n).astype(np.float32)
        st, (y,) = port.apply(st, pr, Stream.full(torch.from_numpy(x),
                                                  sample_rate=250e3))
        jst, (jy,) = jfr.apply(jst, jpr, JStream.full(jnp.asarray(x),
                                                      sample_rate=250e3))
        k = int(jy.count)
        assert int(y.count) == k
        got, want = y.data.numpy()[:k], np.asarray(jy.data)[:k]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert int(st["mu_int"]) == int(jst["mu_int"])
        assert int(st["mu_frac"]) == int(np.asarray(jst["mu_frac"]))


@pytest.mark.parametrize("rate", [1e6, 3.2e6])
def test_pack_detector_events_over_port_rows_equals_jax(rate):
    """Wire records from the port's RadarDetector rows, handed over as
    tensors, byte-equal to the JAX module's over JAX's rows."""
    import jax.numpy as jnp

    from grbaz_tpu.core.stream import Stream as JStream
    from grbaz_tpu.net.radar_server import pack_detector_events as jpack
    from grbaz_tpu.ops.detect import RadarDetector as JRadar
    from grbaz_tpu_torch.core.stream import Stream
    from grbaz_tpu_torch.ops.detect import RadarDetector

    rng = np.random.default_rng(int(rate))
    x = (0.05 + 0.01 * rng.random(4096)).astype(np.float32)
    x[100:140] = 2.0
    for start in range(300, 4000, 470):   # bursts of varied width and peak
        x[start:start + rng.integers(3, 300)] = 1.5 + 20 * rng.random()
    kw = dict(base_level=0.1, threshold_db=10.0)
    det, jdet = RadarDetector(**kw, device="cpu"), JRadar(**kw)
    _, (ev,) = det.apply(det.init_state(), det.init_params(),
                         Stream.full(torch.from_numpy(x)))
    _, (jev,) = jdet.apply(jdet.init_state(), jdet.init_params(),
                           JStream.full(jnp.asarray(x)))
    rows = torch.from_numpy(det.decode_events(ev.data, ev.count))
    jrows = JRadar.decode_events(np.asarray(jev.data), int(jev.count))
    assert len(rows) == len(jrows) > 3
    data = pack_detector_events(rows[:, 0], rows[:, 1], rows[:, 2], rate)
    assert data == jpack(jrows[:, 0], jrows[:, 1], jrows[:, 2], rate)
    reps = unpack_reports(data)
    assert reps[0].width == 40 and len(reps) == len(rows)


def test_control_server_over_port_tensor_params():
    """The port's params are tensors: the server reads them and sets a
    leaf as a tensor of its dtype on its device."""
    from xmlrpc.client import ServerProxy

    from grbaz_tpu_torch.net.control_server import ControlServer
    from grbaz_tpu_torch.ops.resampler import FractionalResampler

    class Holder:
        params = {"resampler": FractionalResampler(
            1024, 25 / 24, device="cpu").init_params()}

    h = Holder()
    cs = ControlServer(h, ("127.0.0.1", 0))
    try:
        cli = ServerProxy(f"http://127.0.0.1:{cs.port}")
        assert cli.list_params() == {"resampler": ["inc_frac", "inc_int"]}
        frac = int(h.params["resampler"]["inc_frac"])
        assert cli.get_resampler_inc_frac() == frac
        cli.set_resampler_inc_int(7)
        leaf = h.params["resampler"]["inc_int"]
        assert isinstance(leaf, torch.Tensor)
        assert leaf.dtype == torch.int32 and int(leaf) == 7
        assert cli.get_param("resampler", "inc_int") == 7
    finally:
        cs.close()


def test_event_to_message_over_a_tensor_block():
    from grbaz_tpu.net.message_server import EventToMessage as JBridge
    from grbaz_tpu_torch.net.message_server import EventToMessage
    ev = np.array([[1, 2.5], [3, 4.5], [7, 8.5]], np.float32)
    q, jq = queue.Queue(), queue.Queue()
    assert EventToMessage(q, " tail").post(torch.from_numpy(ev),
                                           torch.tensor(2)) == 2
    assert JBridge(jq, " tail").post(ev, 2) == 2
    assert [q.get_nowait() for _ in range(2)] == \
        [jq.get_nowait() for _ in range(2)]
    assert q.empty() and jq.empty()
