"""Port segment scans and PeakDetector == grbaz_tpu (bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.ops import fir as jfir
from grbaz_tpu.ops import segments as jseg
from grbaz_tpu.ops.detect import Correlator as JCorr
from grbaz_tpu.ops.detect import PeakDetector as JPeak
from grbaz_tpu.ops.detect import RadarDetector as JRadar
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import fir as tfir
from grbaz_tpu_torch.ops import segments as tseg
from grbaz_tpu_torch.ops.cuda import peak_fsm as tpf
from grbaz_tpu_torch.ops.detect import Correlator, PeakDetector, RadarDetector
from tests.torch_parity import jax_run, port_run

CPU = "cpu"


def _values(gen, n, kind):
    """Float values with many ties and -inf samples, or int32 values."""
    if kind == "ties":
        v = gen.integers(-3, 3, n).astype(np.float32)
        v[gen.random(n) < 0.3] = -np.inf
        return v
    if kind == "normal":
        return gen.standard_normal(n).astype(np.float32)
    return gen.integers(-5, 5, n).astype(np.int32)


def _both(fn, *args):
    j = fn(jseg, *(jnp.asarray(a) for a in args))
    t = fn(tseg, *(torch.from_numpy(a) for a in args))
    return j, t


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("p_reset", [0.0, 0.03, 0.5])
@pytest.mark.parametrize("kind", ["ties", "normal", "int"])
def test_seg_prefix_max_and_maxpos_bit_equal(seed, n, p_reset, kind):
    """Values with ties (the earlier position kept), -inf before the first
    reset (NO_POS) and at resets (a reset keeps its own position)."""
    gen = np.random.default_rng(seed * 1000 + n)
    reset = gen.random(n) < p_reset
    v = _values(gen, n, kind)
    if kind == "ties" and n > 2:
        v[0] = -np.inf
        reset[1] = True
        v[1] = -np.inf
    pos = gen.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    (jm, jp), (tm, tp) = _both(lambda m, r, x, p: m.seg_prefix_maxpos(r, x, p),
                               reset, v, pos)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert tp.dtype == torch.int32
    jm, tm = _both(lambda m, r, x: m.seg_prefix_max(r, x), reset, v)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [1, 300, 5000])
def test_running_and_next_true_index_bit_equal(seed, n):
    gen = np.random.default_rng(seed + n)
    mask = gen.random(n) < 0.05
    idx = gen.integers(0, 1 << 30, n).astype(np.int32)
    for s in (tseg.NO_POS, 17):
        j, t = _both(lambda m, a, b: m.running_last_true(a, b, s), mask, idx)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    j, t = _both(lambda m, a: m.next_true_index(a, n), mask)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("p_reset", [0.0, 0.01, 0.3])
def test_seg_prefix_sum_within_f32(p_reset):
    """Another summation order: within f32 rounding of the segment sums."""
    gen = np.random.default_rng(3)
    n = 20000
    reset = gen.random(n) < p_reset
    v = (gen.standard_normal(n) * 3).astype(np.float32)
    j, t = _both(lambda m, r, x: m.seg_prefix_sum(r, x), reset, v)
    j = np.asarray(j)
    assert t.dtype == torch.float32
    mag = np.abs(v).sum()
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6 * mag)


def _signal(kind, n, gen):
    if kind == 0:
        return np.abs(gen.standard_normal(n)).astype(np.float32)
    if kind == 1:
        x = gen.random(n).astype(np.float32)
        x[::50] += 3.0
        return x
    return np.cumsum(gen.standard_normal(n)).astype(np.float32)


CASES = [dict(min_diff=0.0, min_len=1),
         dict(min_diff=0.3, min_len=2, drop=0.1),
         dict(min_diff=1.0, min_len=1, alpha=0.3),
         dict(min_diff=0.3, min_len=3, threshold=0.5)]


@pytest.mark.parametrize("kw", CASES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("bs", [256, 2048, 700])
def test_peak_detector_bit_equal_to_jax_and_serial_mirror(kw, kind, bs):
    """Marks and idx_diff against the JAX block-parallel apply and its
    per-sample serial mirror (_apply_scan), over chained blocks (rises
    that span blocks; a short last block where bs does not divide n),
    the last block with count < capacity; and the carried state."""
    gen = np.random.default_rng(kind * 7 + bs)
    n = 2048
    x = _signal(kind, n, gen)
    blocks = [x[i:i + bs] for i in range(0, n, bs)]
    counts = [len(b) for b in blocks]
    counts[-1] = max(counts[-1] - 5, 0)
    jo, js = jax_run(JPeak(**kw), blocks, counts)
    so, _ = jax_run(JPeak(**kw), blocks, counts,
                    fn=JPeak(**kw)._apply_scan)
    to, ts = port_run(PeakDetector(**kw, device=CPU), blocks, counts)
    for j, s, t in zip(jo, so, to):
        for port in range(2):
            np.testing.assert_array_equal(j[port][0], t[port][0])
            np.testing.assert_array_equal(s[port][0], t[port][0])
            assert j[port][1] == t[port][1]
        assert t[1][0].dtype == np.int32
    assert sum(float(t[0][0].sum()) for t in to) > 0
    for k, v in js.items():
        if k == "ave":  # with alpha != 1, a scan rounded another way
            np.testing.assert_allclose(to_numpy(ts[k]), np.asarray(v),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)


@pytest.mark.parametrize("kw", [dict(lockout=10), dict(look_ahead=4)])
def test_peak_detector_sequential_family_raises(kw):
    """The sequential family (lockout, look-ahead) raised while it had no
    kernel, hence the name; it now runs. On the CPU it runs the FSM's
    plain version, which marks each rise's peak and then locks out (or
    splits a run at a stale peak)."""
    pd = PeakDetector(min_diff=0.5, device=CPU, **kw)
    x = torch.zeros(64)
    x[10:12] = torch.tensor([0.3, 1.0])
    x[14:16] = torch.tensor([0.3, 1.0])
    st, (marks, diff) = pd.apply(pd.init_state(), pd.init_params(),
                                 Stream.full(x))
    got = torch.nonzero(marks.data).flatten().tolist()
    assert got == ([11] if "lockout" in kw else [11, 15])
    assert diff.data.dtype == torch.int32 and int(st["global_idx"]) == 64


FSM_CASES = [dict(min_diff=0.5, lockout=64),
             dict(min_diff=0.3, min_len=2, lockout=10, drop=0.1),
             dict(min_diff=0.3, lockout=5, look_ahead=4, alpha=0.3),
             dict(min_diff=1.0, look_ahead=3, threshold=0.5)]


@pytest.mark.parametrize("kw", FSM_CASES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("bs", [256, 1024, 8192])
def test_peak_fsm_plain_bit_equal_to_jax_scan(kw, kind, bs):
    """The lockout / look-ahead FSM's plain version == the JAX serial scan
    (_apply_scan, what the JAX block runs for these configurations):
    marks, idx_diff and every state field bit for bit over chained blocks
    (peaks of earlier blocks summed at sample 0)."""
    gen = np.random.default_rng(kind * 11 + bs)
    n = max(2 * bs, 2048)
    x = _signal(kind, n, gen)
    blocks = [x[i:i + bs] for i in range(0, n, bs)]
    jo, js = jax_run(JPeak(**kw), blocks)
    to, ts = port_run(PeakDetector(**kw, device=CPU), blocks)
    for j, t in zip(jo, to):
        for port in range(2):
            np.testing.assert_array_equal(j[port][0], t[port][0])
    assert sum(float(t[0][0].sum()) for t in to) > 0
    for k, v in js.items():
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)
        assert np.asarray(v).dtype == to_numpy(ts[k]).dtype


def test_peak_fsm_rows_are_independent_streams():
    """[B, n] rows walk as B streams, each equal to its own single-row run
    (the decoder-bank shape of the kernel)."""
    gen = np.random.default_rng(5)
    x = torch.from_numpy(_signal(1, 3 * 700, gen).reshape(3, 700))
    pd = PeakDetector(min_diff=0.3, lockout=20, device=CPU)
    one = {k: v.reshape(1) for k, v in pd.init_state().items()}
    batch = {k: v.expand(3).clone() for k, v in one.items()}
    thr = torch.tensor([float("-inf")])
    m, d, st = tpf.peak_fsm(x, batch, thr, **pd.fsm_config())
    for r in range(3):
        mr, dr, sr = tpf.peak_fsm(x[r:r + 1], one, thr, **pd.fsm_config())
        assert torch.equal(m[r], mr[0]) and torch.equal(d[r], dr[0])
        assert all(torch.equal(st[k][r], sr[k][0]) for k in st)


def test_peak_fsm_state_from_jax_and_checkpoint(tmp_path):
    """A mid-stream JAX state of the lockout detector, through
    states_from_numpy and through the JAX .npz, continues bit-equal; the
    port's state loads back into the JAX package."""
    gen = np.random.default_rng(9)
    x = _signal(1, 3000, gen)
    kw = dict(min_diff=0.3, lockout=40)
    _, js = jax_run(JPeak(**kw), [x[:1000]])
    jo, _ = jax_run(JPeak(**kw), [x[1000:]], state=js)
    pd = PeakDetector(**kw, device=CPU)
    st = states_from_numpy(jax.tree_util.tree_map(np.asarray, js), CPU)
    to, ts = port_run(pd, [x[1000:]], state=st)
    np.testing.assert_array_equal(jo[0][0][0], to[0][0][0])
    np.testing.assert_array_equal(jo[0][1][0], to[0][1][0])
    p = str(tmp_path / "pd.npz")
    jckpt.save_state(p, {"pd": js})
    back, _, _ = tckpt.load_state(p, {"pd": pd.init_state()})
    to2, ts2 = port_run(pd, [x[1000:]], state=back["pd"])
    np.testing.assert_array_equal(jo[0][0][0], to2[0][0][0])
    tckpt.save_state(p, {"pd": ts2})
    jback, _, _ = jckpt.load_state(p, {"pd": JPeak(**kw).init_state()})
    for k, v in jback["pd"].items():
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)


# ---------------------------------------------------------------------------
# RadarDetector
# ---------------------------------------------------------------------------

def _radar_signal(rng, n):
    x = (0.05 + 0.3 * (rng.random(n) < 0.15)
         * (0.5 + rng.random(n))).astype(np.float32)
    x[500:530] = 2.0    # a burst across the first block boundary
    return x


def _radar_close(jo, to):
    for j, t in zip(jo, to):
        (jd, jc), (td, tc) = j[0], t[0]
        assert jc == tc
        jd, td = np.asarray(jd), np.asarray(td)
        # start limbs, lengths and maxima bit for bit; sums to f32 rounding
        np.testing.assert_array_equal(jd[:, :3].view(np.int32),
                                      td[:, :3].view(np.int32))
        np.testing.assert_allclose(td[:, 3], jd[:, 3], rtol=1e-5, atol=0)


@pytest.mark.parametrize("bs", [512, 700, 3072])
def test_radar_detector_equals_jax(bs):
    """Events (bitcast int32 starts, lengths, max bit for bit; sums within
    1e-5 relative), counts and the carried state, bursts across blocks;
    the last block short."""
    rng = np.random.default_rng(bs)
    x = _radar_signal(rng, 3072)
    blocks = [x[i:i + bs] for i in range(0, len(x), bs)]
    counts = [len(b) for b in blocks]
    kw = dict(base_level=0.1, threshold_db=10.0)
    jo, js = jax_run(JRadar(**kw), blocks, counts)
    to, ts = port_run(RadarDetector(**kw, device=CPU), blocks, counts)
    _radar_close(jo, to)
    for k, v in js.items():
        if k == "bsum":
            np.testing.assert_allclose(to_numpy(ts[k]), np.asarray(v),
                                       rtol=1e-5)
        else:
            np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)
    rows = RadarDetector.decode_events(torch.from_numpy(to[0][0][0]),
                                       to[0][0][1])
    np.testing.assert_allclose(rows, JRadar.decode_events(jo[0][0][0],
                                                          jo[0][0][1]),
                               rtol=1e-5)


def test_radar_detector_overflow_equals_jax():
    """The overflow shape of the JAX test: 2*cap+1 bursts in one block,
    the list clamped at MAX_EVENTS, the loss counted, the open burst
    carried exactly; then a JAX mid-stream state continues in the port."""
    cap = RadarDetector.MAX_EVENTS
    n = 4 * cap + 3
    x = np.where(np.arange(n) % 2 == 0, 5.0, 0.01).astype(np.float32)
    x[-1] = 5.0
    kw = dict(base_level=0.1, threshold_db=10.0)
    jo, js = jax_run(JRadar(**kw), [x])
    to, ts = port_run(RadarDetector(**kw, device=CPU), [x])
    _radar_close(jo, to)
    assert to[0][0][1] == cap and int(ts["dropped"]) == cap + 1
    for k, v in js.items():
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)
    y = _radar_signal(np.random.default_rng(4), 1024)
    jo, _ = jax_run(JRadar(**kw), [y], state=js)
    st = states_from_numpy(jax.tree_util.tree_map(np.asarray, js), CPU)
    to, _ = port_run(RadarDetector(**kw, device=CPU), [y], state=st)
    _radar_close(jo, to)


# ---------------------------------------------------------------------------
# Correlator and the FFT FIR under it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [31, 63, 64, 127])
@pytest.mark.parametrize("bs", [1024, 2048])
def test_correlator_equals_jax(L, bs):
    """Both paths (direct below 64 taps, FFT from 64): surfaces within
    1e-5 of the max correlation, triggers and counts, over chained blocks
    with syncs planted across a boundary; the peak at the documented
    latency."""
    rng = np.random.default_rng(L + bs)
    sync = (rng.standard_normal(L) + 1j * rng.standard_normal(L)) \
        .astype(np.complex64)
    sync /= np.sqrt(np.mean(np.abs(sync) ** 2))
    n = 3 * bs
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for p in (300, bs - L // 2, 2 * bs + 700):
        x[p:p + L] += sync
    x = x.astype(np.complex64)
    blocks = [x[i:i + bs] for i in range(0, n, bs)]
    kw = dict(sync=sync, window_length=512, threshold=L * 0.5, width=16)
    jo, js = jax_run(JCorr(**kw), blocks)
    to, ts = port_run(Correlator(**kw, device=CPU), blocks)
    scale = max(float(np.abs(j[1][0]).max()) for j in jo)
    for j, t in zip(jo, to):
        for port in range(2):
            assert j[port][1] == t[port][1]
            np.testing.assert_allclose(t[port][0], j[port][0], rtol=0,
                                       atol=1e-5 * scale)
    np.testing.assert_allclose(ts["tail"].numpy(), np.asarray(js["tail"]),
                               rtol=1e-6)
    trig = np.concatenate([t[1][0] for t in to])
    hits = np.nonzero(trig)[0]
    assert len(hits) == 3
    surf = np.concatenate([t[0][0] for t in to])
    assert (np.argmax(surf[hits], axis=1) == 8).all()


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("decim", [1, 3])
def test_fft_fir_frame_equals_jax(rng, complex_taps, decim):
    taps = rng.standard_normal(150).astype(np.float32)
    h = jfir.prepare_taps(taps, decim)
    if complex_taps:
        h = (h + 1j * rng.standard_normal(h.shape[0])).astype(np.complex64)
    for frame in ((rng.standard_normal(5000)
                   + 1j * rng.standard_normal(5000)).astype(np.complex64),
                  rng.standard_normal(5000).astype(np.float32)):
        ref = np.asarray(jfir.fft_fir_frame(jnp.asarray(frame),
                                            jnp.asarray(h), decim))
        got = tfir.fft_fir_frame(torch.from_numpy(frame), torch.from_numpy(h),
                                 decim).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_peak_detector_state_checkpoint_both_ways(tmp_path):
    """int32 and bool leaves keep their types through the converters and
    both packages' checkpoints; a detector resumed from the JAX file
    continues bit-equal."""
    gen = np.random.default_rng(2)
    x = _signal(1, 3000, gen)
    kw = dict(min_diff=0.3, min_len=2)
    _, js = jax_run(JPeak(**kw), [x[:1000]])
    pd = PeakDetector(**kw, device=CPU)
    template = pd.init_state()
    assert {k: v.dtype for k, v in template.items()
            if v.dtype != torch.float32} == dict(
        rising=torch.bool, rise_count=torch.int32, peak_age=torch.int32,
        lockout_count=torch.int32, last_peak_global=torch.int32,
        global_idx=torch.int32)
    p = str(tmp_path / "pd.npz")
    jckpt.save_state(p, {"pd": js})
    st, _, _ = tckpt.load_state(p, {"pd": template})
    jo, _ = jax_run(JPeak(**kw), [x[1000:]], state=js)
    to, ts = port_run(pd, [x[1000:]], state=st["pd"])
    np.testing.assert_array_equal(jo[0][0][0], to[0][0][0])
    np.testing.assert_array_equal(jo[0][1][0], to[0][1][0])
    tckpt.save_state(p, {"pd": ts})
    back, _, _ = jckpt.load_state(p, {"pd": JPeak(**kw).init_state()})
    for k, v in back["pd"].items():
        assert np.asarray(v).dtype == np.asarray(JPeak().init_state()[k]).dtype
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]))
    again = states_from_numpy(to_numpy(ts), CPU)
    assert all(again[k].dtype == ts[k].dtype for k in ts)
