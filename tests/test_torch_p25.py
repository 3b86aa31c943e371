"""The port's P25 device blocks (``ops/p25.py``, ``ops/fsk4.py``,
``models/p25.py``) against the JAX package's on the CPU.

Tolerances:

* ``P25FrameSync``: bit-equal events (as int32 bit patterns, so the
  bitcast symbol index is compared exactly), counts and the whole state
  after every block;
* ``FSK4Demod``: both resample with the same exact 32.32 positions and
  the same taps, but sum in another order, so the soft symbols agree
  within 1e-5 of their max; a dibit may differ only where the JAX soft
  symbol lies within 1e-5 of a slicing threshold (0 or +-1). The
  integer state (positions, carried count, chosen phase) and the carried
  input tail are equal; the carried partial symbol is resampled values
  (1e-5 of its max) and the eye scale is a float sum (1e-6 relative);
* ``build_p25_rx``: the graph step against the jitted JAX step at the
  FSK4 bars (the FSK4 input tail, the discriminator's output, within
  1e-5 of its max: ``atan2`` differs in the last bits, as in the
  QuadratureDemod tests), frame events bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.core.stream import StreamMeta as JMeta
from grbaz_tpu.models import p25 as jm
from grbaz_tpu.ops import fsk4 as jf
from grbaz_tpu.ops import p25 as jp
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.core.stream import StreamMeta as TMeta
from grbaz_tpu_torch.core.stream import decode_i32
from grbaz_tpu_torch.models import p25 as tm
from grbaz_tpu_torch.ops import fsk4 as tf
from grbaz_tpu_torch.ops import p25 as tp

SOFT_REL = 1e-5
SCALE_REL = 1e-6
LEVEL = {1: 3.0, 0: 1.0, 2: -1.0, 3: -3.0}


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


def run_both(jblk, tblk, blocks, counts, jstate=None):
    """Both blocks over the same blocks: [(JAX outputs, port outputs, JAX
    state, port state)] after each block, as numpy."""
    js = jstate if jstate is not None else jblk.init_state()
    js = jax.tree_util.tree_map(jnp.asarray, js)
    ts = states_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jm_, tm_ = JMeta.start(1.0), TMeta.start(1.0, device="cpu")
    steps = []
    for x, c in zip(blocks, counts):
        js, jo = jblk.apply(js, jblk.init_params(), JStream(
            jnp.asarray(x), jnp.int32(c), jm_))
        ts, to = tblk.apply(ts, tblk.init_params(), TStream(
            torch.from_numpy(np.ascontiguousarray(x)),
            torch.tensor(c, dtype=torch.int32), tm_))
        steps.append(([(np.asarray(o.data), int(o.count)) for o in jo],
                      [(o.data.numpy(), int(o.count)) for o in to],
                      jax.tree_util.tree_map(np.asarray, js), to_numpy(ts)))
    return steps


# ---------------------------------------------------------------------------
# P25FrameSync
# ---------------------------------------------------------------------------

def planted(rng, frames, gap=(20, 90)):
    """A dibit stream with ``frames`` = [(nac, duid, sync errors)] planted
    between random dibits: (dibits, [(start, nac, duid, errors)])."""
    parts, where, pos = [], [], 0
    for nac, duid, errs in frames:
        g = rng.integers(0, 4, int(rng.integers(*gap))).astype(np.uint8)
        f = tp.make_frame(nac, duid, payload_dibits=10, rng=rng)
        for i in rng.choice(24, size=errs, replace=False):
            f[i] ^= 1 + int(rng.integers(0, 3))     # another dibit value
        parts += [g, f]
        pos += len(g)
        where.append((pos, nac, duid, errs))
        pos += len(f)
    parts.append(rng.integers(0, 4, 70).astype(np.uint8))
    return np.concatenate(parts), where


def cut(dib, sizes, cap):
    """``dib`` in blocks of ``cap`` holding ``sizes`` valid dibits each
    (the rest zero): (blocks, counts)."""
    blocks, counts, i = [], [], 0
    while i < len(dib):
        c = int(sizes[len(blocks) % len(sizes)])
        b = np.zeros(cap, np.uint8)
        part = dib[i:i + c]
        b[:len(part)] = part
        blocks.append(b)
        counts.append(len(part))
        i += c
    return blocks, counts


def assert_sync_steps(steps):
    for b, (jo, to, js, ts) in enumerate(steps):
        (jev, jn), = jo
        (tev, tn), = to
        assert jn == tn, b
        assert np.array_equal(bits(jev), bits(tev)), b
        assert js.keys() == ts.keys()
        for k in js:
            assert np.array_equal(bits(js[k]), bits(ts[k])), (b, k)


def events_of(steps):
    rows = [o[1][0][0][:o[1][0][1]] for o in steps]
    rows = np.concatenate(rows).astype(np.float64)
    rows[:, 0] = decode_i32(np.concatenate(
        [o[1][0][0][:o[1][0][1], 0] for o in steps]))
    return rows


@pytest.mark.parametrize("sizes,cap", [((64,), 64), ((64, 40, 64, 13), 64),
                                       ((37, 64, 1, 64), 64), ((200,), 256)])
def test_frame_sync_matches_jax_over_chunks(sizes, cap):
    """Frames with 0 and 1 sync errors (max_errors 1) over 64-dibit
    chunks with partial counts: events and state bit-equal, every frame
    found once at its index (syncs cross block boundaries)."""
    rng = np.random.default_rng(len(sizes) + cap)
    frames = [(int(rng.integers(0, 4096)), d, e)
              for d, e in ((0x5, 0), (0xA, 1), (0x3, 0), (0x7, 1), (0x0, 0))]
    dib, where = planted(rng, frames)
    blocks, counts = cut(dib, sizes, cap)
    steps = run_both(jp.P25FrameSync(1), tp.P25FrameSync(1, device="cpu"),
                     blocks, counts)
    assert_sync_steps(steps)
    rows = events_of(steps)
    assert [tuple(int(v) for v in r) for r in rows] == where


@pytest.mark.parametrize("cut_at", [1, 12, 23, 24, 40, 55])
def test_frame_sync_across_block_boundary(cut_at):
    """A frame split at every part of its sync and NID is found once."""
    rng = np.random.default_rng(cut_at)
    dib, where = planted(rng, [(0xFED, 0x7, 0)], gap=(97, 98))
    first = where[0][0] + cut_at
    sizes = (first, len(dib) - first)
    blocks, counts = cut(dib, sizes, max(sizes))
    steps = run_both(jp.P25FrameSync(0), tp.P25FrameSync(0, device="cpu"),
                     blocks, counts)
    assert_sync_steps(steps)
    assert [tuple(int(v) for v in r) for r in events_of(steps)] == where


@pytest.mark.parametrize("max_errors", [0, 1, 2])
def test_frame_sync_error_limit(max_errors):
    """Syncs with max_errors errors are found, one more are not."""
    rng = np.random.default_rng(30 + max_errors)
    frames = [(0x111, 0x3, max_errors), (0x222, 0x5, max_errors + 1),
              (0x333, 0xA, max_errors)]
    dib, where = planted(rng, frames)
    blocks, counts = cut(dib, (96,), 96)
    steps = run_both(jp.P25FrameSync(max_errors),
                     tp.P25FrameSync(max_errors, device="cpu"),
                     blocks, counts)
    assert_sync_steps(steps)
    want = [w for w in where if w[3] <= max_errors]
    assert [tuple(int(v) for v in r) for r in events_of(steps)] == want


def test_frame_sync_counter_wraps_past_int32():
    """The int32 symbol counter started 150 dibits before 2^31: indices
    wrap to negative int32 as in JAX, events and state bit-equal."""
    rng = np.random.default_rng(9)
    dib, where = planted(rng, [(0x0A1, 0x5, 0), (0x0A2, 0xA, 1),
                               (0x0A3, 0x3, 0)], gap=(40, 60))
    blocks, counts = cut(dib, (64, 50), 64)
    start = 2 ** 31 - 150
    jblk = jp.P25FrameSync(1)
    st = dict(jblk.init_state(), global_sym=np.int32(start))
    steps = run_both(jblk, tp.P25FrameSync(1, device="cpu"), blocks, counts,
                     jstate=st)
    assert_sync_steps(steps)
    got = events_of(steps)[:, 0].astype(np.int64)
    want = [(start + w[0] + 2 ** 31) % 2 ** 32 - 2 ** 31 for w in where]
    assert list(got) == want and min(want) < 0 < max(want)


def test_frame_sync_overflow_keeps_first_events():
    """More syncs than MAX_EVENTS in one block: the first 64 are kept and
    the count is clamped, as the JAX block's _event_pack does."""
    frame = tp.make_frame(0x123, 0x5)
    dib = np.tile(np.concatenate([frame, np.ones(4, np.uint8)]), 70)
    steps = run_both(jp.P25FrameSync(0), tp.P25FrameSync(0, device="cpu"),
                     [dib], [len(dib)])
    assert_sync_steps(steps)
    assert steps[0][1][0][1] == tp.P25FrameSync.MAX_EVENTS


def test_frame_sync_constants():
    np.testing.assert_array_equal(tp.FS_DIBITS, jp.FS_DIBITS)
    assert tp.SPAN == jp.SPAN and tp.DUID_NAMES == jp.DUID_NAMES
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(tp.make_frame(0xABC, 0xA, 20, rng_a),
                                  jp.make_frame(0xABC, 0xA, 20, rng_b))


# ---------------------------------------------------------------------------
# FSK4Demod
# ---------------------------------------------------------------------------

def c4fm_baseband(rng, n_sym, sps=10, noise=0.1):
    """Rectangular C4FM discriminator output (the JAX test's signal)."""
    dib = rng.integers(0, 4, n_sym).astype(np.uint8)
    x = np.repeat(np.array([LEVEL[int(d)] for d in dib], np.float32), sps)
    return x + noise * rng.standard_normal(len(x)).astype(np.float32)


def assert_fsk4_close(jo, to, jsoft_all=None):
    """One block's outputs: counts equal, soft within SOFT_REL of its max,
    dibits equal but next to a threshold. Returns the exempt count."""
    (jd, jdn), (js_, jsn) = jo
    (td, tdn), (ts_, tsn) = to
    assert jdn == tdn == jsn == tsn
    scale = max(np.abs(js_).max(), 1e-30)
    assert np.abs(js_ - ts_).max() <= SOFT_REL * scale
    near = np.min(np.abs(js_[:, None] - np.array([-1.0, 0.0, 1.0])),
                  axis=1) < SOFT_REL
    differ = jd != td
    assert not np.any(differ & ~near)
    return int(np.sum(differ))


def assert_fsk4_state(js, ts, exact_tail=True):
    """``exact_tail``: the carried input is the block's own input (else
    the discriminator's, whose atan2 differs in the last bits)."""
    assert js.keys() == ts.keys()
    for k in ("mu_int", "mu_frac", "buf_count", "phase"):
        assert np.array_equal(bits(js[k]), bits(ts[k])), k
    if exact_tail:
        assert np.array_equal(bits(js["tail"]), bits(ts["tail"]))
    for k in ("tail", "buf"):
        assert np.abs(js[k] - ts[k]).max() <= SOFT_REL * max(
            np.abs(js[k]).max(), 1e-30), k
    assert abs(float(js["scale"]) - float(ts["scale"])) <= SCALE_REL * abs(
        float(js["scale"]))


@pytest.mark.parametrize("bs,partial", [(4000, None), (1000, 700),
                                        (1537, 1201)])
def test_fsk4_matches_jax(bs, partial):
    """Three block splits (one not a multiple of the 1.25-sample step),
    with and without a partial block mid-stream."""
    rng = np.random.default_rng(bs)
    x = c4fm_baseband(rng, 1200)
    blocks, counts = [], []
    for i in range(0, len(x), bs):
        b = np.zeros(bs, np.float32)
        part = x[i:i + bs]
        b[:len(part)] = part
        blocks.append(b)
        counts.append(len(part))
    if partial is not None:
        counts[1] = partial
    steps = run_both(jf.FSK4Demod(48000.0),
                     tf.FSK4Demod(48000.0, device="cpu"), blocks, counts)
    exempt = 0
    for jo, to, js, ts in steps:
        exempt += assert_fsk4_close(jo, to)
        assert_fsk4_state(js, ts)
    assert exempt <= 2


def test_fsk4_recovers_dibits_as_jax_test():
    """The JAX package's FSK4 test (test_autofec_fsk4.py) on the port:
    symbol accuracy above 0.95 at some constant offset."""
    rng = np.random.default_rng(3)
    dibits = rng.integers(0, 4, 2000).astype(np.uint8)
    x = np.repeat(np.array([LEVEL[int(d)] for d in dibits], np.float32), 10)
    x += 0.1 * rng.standard_normal(len(x)).astype(np.float32)
    demod = tf.FSK4Demod(48000.0, device="cpu")
    state, params = demod.init_state(), demod.init_params()
    got = []
    for i in range(0, len(x) - 4000 + 1, 4000):
        state, (d, _) = demod.apply(state, params,
                                    TStream.full(torch.from_numpy(x[i:i + 4000])))
        got.append(d.data[:int(d.count)].numpy())
    got = np.concatenate(got)
    n = min(len(got), len(dibits)) - 8
    best = max(np.mean(got[8:n] == dibits[8 + off:n + off]) for off in range(4))
    assert best > 0.95


def test_fsk4_state_carried_from_jax():
    """A state carried from the JAX block mid-stream (uint32 mu_frac,
    partial symbol, phase, scale) continues as the JAX block does."""
    rng = np.random.default_rng(12)
    x = c4fm_baseband(rng, 900)
    blocks = [x[i:i + 1800] for i in range(0, 9000, 1800)]
    jblk = jf.FSK4Demod(48000.0)
    js = jax.tree_util.tree_map(jnp.asarray, jblk.init_state())
    for b in blocks[:2]:
        js, _ = jblk.apply(js, jblk.init_params(), JStream.full(jnp.asarray(b)))
    steps = run_both(jblk, tf.FSK4Demod(48000.0, device="cpu"), blocks[2:],
                     [len(b) for b in blocks[2:]], jstate=js)
    for jo, to, js_, ts in steps:
        assert_fsk4_close(jo, to)
        assert_fsk4_state(js_, ts)


# ---------------------------------------------------------------------------
# the receive chain
# ---------------------------------------------------------------------------

def test_build_p25_rx_matches_jax_step():
    """IQ C4FM -> disc -> FSK4 -> frame sync (tests/test_p25.py's full
    chain) on both packages: the port's step against the jitted JAX step,
    block by block, and the planted frame found by both."""
    rng = np.random.default_rng(5)
    jcfg = jm.P25Config(channel_rate=48e3, block_size=1 << 12)
    tcfg = tm.P25Config(channel_rate=48e3, block_size=1 << 12)
    frame = jp.make_frame(nac=0x293, duid=0x5, payload_dibits=0, rng=rng)
    dibits = np.concatenate([rng.integers(0, 4, 300).astype(np.uint8), frame,
                             rng.integers(0, 4, 644).astype(np.uint8)])
    iq = jm.c4fm_modulate(dibits, jcfg.channel_rate)
    np.testing.assert_array_equal(iq, tm.c4fm_modulate(dibits, 48e3))
    jfg, _ = jm.build_p25_rx(jcfg)
    tfg, _ = tm.build_p25_rx(tcfg, device="cpu")
    jstep, tstep = jax.jit(jfg.build_step()), tfg.build_step()
    jst, jpr = jfg.init_states(), jfg.init_params()
    tst, tpr = tfg.init_states(), tfg.init_params()
    n = jcfg.block_size
    found = []
    for i in range(0, len(iq) - n + 1, n):
        x = iq[i:i + n]
        jst, jo = jstep(jst, jpr, {"iq": JStream(jnp.asarray(x), jnp.int32(n),
                                                 JMeta.start(48e3))})
        tst, to = tstep(tst, tpr, {"iq": TStream.full(torch.from_numpy(x),
                                                      sample_rate=48e3)})
        assert_fsk4_close(
            [(np.asarray(jo[p].data), int(jo[p].count))
             for p in ("dibits", "soft")],
            [(to[p].data.numpy(), int(to[p].count))
             for p in ("dibits", "soft")])
        jev, tev = jo["frames"], to["frames"]
        assert int(jev.count) == int(tev.count)
        assert np.array_equal(bits(np.asarray(jev.data)), bits(tev.data.numpy()))
        found += [tuple(r) for r in tev.data[:int(tev.count), 1:3].numpy()]
        assert_fsk4_state(jax.tree_util.tree_map(np.asarray, jst["fsk4"]),
                          to_numpy(tst["fsk4"]), exact_tail=False)
    assert (0x293, 0x5) in [(int(a), int(b)) for a, b in found]


def test_chip_smoke_p25_scene_on_the_cpu():
    """chip_smoke.py's P25 scene and graph (the channel at decim 32 in
    front of build_p25_rx) rehearsed on the CPU over three blocks: every
    planted LDU found at its index plus one delay, its voice bits back
    with the right keys and garbled with the keys swapped."""
    import chip_smoke as cs
    feeds, plan = cs.p25_scene(torch.device("cpu"), n_blocks=3)
    outs, _, _ = cs.run_inputs(cs.p25_graph("cpu"), feeds, cs.P25_FS)
    delay, errs, n_ldu, n_enc = cs.check_p25_outputs(outs, plan)
    assert n_ldu >= 3 and n_enc >= 1 and delay == 1
