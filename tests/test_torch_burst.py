"""Port burst and timing blocks == grbaz_tpu (ops/burst.py) on the CPU.

Event rows carry bitcast uint32 limbs (possibly NaN or denormal bit
patterns), so they are compared as int32 bit patterns: bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.core import stream as jstream
from grbaz_tpu.ops import burst as jb
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.core import stream as tstream
from grbaz_tpu_torch.ops import burst as tb
from tests.torch_parity import jax_run, port_run

CPU = "cpu"
NAN_LIMB = 0x7FC00000   # a low limb that is a NaN bit pattern as float32


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def assert_same_outputs(jo, to, event_ports=()):
    """Every port of every block equal (event ports as bit patterns)."""
    assert len(jo) == len(to)
    for j, t in zip(jo, to):
        for p, ((jd, jc), (td, tc)) in enumerate(zip(j, t)):
            assert jc == tc, (p, jc, tc)
            if p in event_ports:
                np.testing.assert_array_equal(bits(jd), bits(td))
            else:
                np.testing.assert_array_equal(jd, td)


def assert_same_state(js, ts):
    for k, v in js.items():
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)


def gate_inputs(rng, n, dens):
    trig = ((rng.random(n) < dens) * (0.6 + rng.random(n))).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32), trig


def blocks_of(arrays, bs):
    n = len(arrays[0])
    return [tuple(a[i:i + bs] for a in arrays) for i in range(0, n, bs)]


# ---------------------------------------------------------------------------
# stream bit helpers and the event pack
# ---------------------------------------------------------------------------

LIMBS = [0, 1, 5, NAN_LIMB, NAN_LIMB + 7, 0x7F800001, 0x80000000,
         0xFFC00001, 0xFFFFFFFF, 2 ** 31 - 1]


def test_bits_helpers_equal_jax():
    u = np.array(LIMBS, np.uint32)
    jf = np.asarray(jstream.bits_to_f32(jnp.asarray(u)))
    tf = tstream.bits_to_f32(torch.from_numpy(u.astype(np.int64)))
    np.testing.assert_array_equal(bits(jf), bits(tf.numpy()))
    np.testing.assert_array_equal(tstream.f32_to_bits(tf).numpy(), u)
    np.testing.assert_array_equal(
        tstream.f32_to_bits(tf, torch.int32).numpy(), u.view(np.int32))
    i32 = u.view(np.int32)   # int32 inputs map to the same patterns
    np.testing.assert_array_equal(
        bits(tstream.bits_to_f32(torch.from_numpy(i32)).numpy()), i32)
    for fn in ("decode_u32", "decode_i32"):
        np.testing.assert_array_equal(getattr(jstream, fn)(jf),
                                      getattr(tstream, fn)(tf.numpy()))
    np.testing.assert_array_equal(
        jstream.decode_abs_index(jf[::-1], jf),
        tstream.decode_abs_index(tf.numpy()[::-1], tf.numpy()))


@pytest.mark.parametrize("n,cap,p", [(200, 16, 0.02), (200, 16, 0.5),
                                     (10, 16, 0.5), (300, 64, 0.0),
                                     (64, 64, 1.0)])
def test_event_pack_bit_equal(rng, n, cap, p):
    """The first cap emitting rows in order, the count clamped; limb
    fields with NaN and denormal patterns move bit for bit."""
    emits = rng.random(n) < p
    rows = rng.standard_normal((n, 4)).astype(np.float32)
    rows[:, 0] = np.array(LIMBS * (n // len(LIMBS) + 1), np.uint32)[:n] \
        .view(np.float32)
    jr, jc = jb._event_pack(jnp.asarray(emits), jnp.asarray(rows), cap)
    tr, tc = tb._event_pack(torch.from_numpy(emits), torch.from_numpy(rows),
                            cap)
    np.testing.assert_array_equal(bits(jr), bits(tr.numpy()))
    assert int(jc) == int(tc) and tc.dtype == torch.int32


# ---------------------------------------------------------------------------
# Gate
# ---------------------------------------------------------------------------

GATE_CASES = [  # (trigger_length, density, delay), bursts under the cap
    (12, 0.02, 0), (1, 0.2, 0), (33, 0.01, 5), (3, 0.6, 0), (300, 0.01, 3)]


@pytest.mark.parametrize("retrig", [True, False])
@pytest.mark.parametrize("tl,dens,delay", GATE_CASES)
@pytest.mark.parametrize("abs_index", [0, NAN_LIMB - 700, 2 ** 32 - 500])
def test_gate_bit_equal_to_jax(rng, retrig, tl, dens, delay, abs_index):
    """Gated signal, event rows (limbs bit for bit: the low limb passes
    through NaN patterns near 0x7FC00000 and carries into the high limb
    near 2^32) and state over 6 blocks with bursts across boundaries; the
    non-retriggerable form also against the JAX serial mirror."""
    n, bs = 256 * 6, 256
    x, trig = gate_inputs(rng, n, dens)
    blocks = blocks_of((x, trig), bs)
    kw = dict(threshold=0.5, trigger_length=tl, delay_samples=delay,
              retriggerable=retrig)
    jo, js = jax_run(jb.Gate(**kw), blocks, abs_index=abs_index, rate=1e6)
    to, ts = port_run(tb.Gate(**kw, device=CPU), blocks,
                      abs_index=abs_index, rate=1e6)
    assert_same_outputs(jo, to, event_ports=(1,))
    assert_same_state(js, ts)
    g = jb.Gate(**kw)
    so, _ = jax_run(g, blocks, fn=g._apply_scan, abs_index=abs_index,
                    rate=1e6)
    for s, t in zip(so, to):
        np.testing.assert_array_equal(s[0][0], t[0][0])
        assert s[1][1] == t[1][1]
        got = jb.decode_abs_events(t[1][0], t[1][1])
        want = jb.decode_abs_events(s[1][0], s[1][1])
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
    assert any(t[0][0].any() for t in to)


@pytest.mark.parametrize("tl", [1, 2])
def test_fixed_length_gate_over_the_cap_equals_jax(rng, tl):
    """More than MAX_BURSTS=64 bursts a block: the port walks exactly 64
    jumps, as the JAX scan, and drops the same bursts."""
    x, trig = gate_inputs(rng, 2048, 0.7)
    blocks = blocks_of((x, trig), 1024)
    kw = dict(threshold=0.5, trigger_length=tl, retriggerable=False)
    jo, js = jax_run(jb.Gate(**kw), blocks, abs_index=77)
    to, ts = port_run(tb.Gate(**kw, device=CPU), blocks, abs_index=77)
    assert_same_outputs(jo, to, event_ports=(1,))
    assert_same_state(js, ts)
    assert to[0][1][1] == 64


def test_gate_byte_trigger_counts_and_decode(rng):
    """Byte mode, a short block (count < capacity) and the host decode."""
    n = 512
    trig = (rng.random(n) < 0.03).astype(np.uint8)
    x = rng.standard_normal(n).astype(np.float32)
    blocks = blocks_of((x, trig), 128)
    counts = [(128, 128)] * 3 + [(100, 100)]
    kw = dict(trigger_length=9, byte_trigger=True)
    jo, js = jax_run(jb.Gate(**kw), blocks, counts, abs_index=1 << 33)
    to, ts = port_run(tb.Gate(**kw, device=CPU), blocks, counts,
                      abs_index=1 << 33)
    assert_same_outputs(jo, to, event_ports=(1,))
    assert_same_state(js, ts)
    for t in to:
        rows = tb.decode_abs_events(torch.from_numpy(t[1][0]), t[1][1])
        np.testing.assert_array_equal(rows, jb.decode_abs_events(t[1][0],
                                                                 t[1][1]))
        assert (rows[:, 0] >= 1 << 33).all()


@pytest.mark.parametrize("retrig", [True, False])
def test_gate_state_from_jax_and_checkpoint_both_ways(rng, retrig, tmp_path):
    """A mid-burst JAX state (numpy bools and ints) continues in the port
    exactly as in the JAX block, through states_from_numpy and through
    each package's .npz checkpoint read by the other."""
    x, trig = gate_inputs(rng, 1024, 0.05)
    trig[250:262] = 2.0   # a burst open across the first boundary
    blocks = blocks_of((x, trig), 256)
    kw = dict(threshold=0.5, trigger_length=40, retriggerable=retrig)
    _, js = jax_run(jb.Gate(**kw), blocks[:1])
    assert bool(js["in_burst"])
    jo, _ = jax_run(jb.Gate(**kw), blocks[1:], state=js)
    gate = tb.Gate(**kw, device=CPU)
    st = states_from_numpy(jax.tree_util.tree_map(np.asarray, js), CPU)
    assert st["in_burst"].dtype == torch.bool
    to, ts = port_run(gate, blocks[1:], state=st)
    assert_same_outputs(jo, to, event_ports=(1,))
    p = str(tmp_path / "g.npz")
    jckpt.save_state(p, {"g": js})
    back, _, _ = tckpt.load_state(p, {"g": gate.init_state()})
    to2, ts2 = port_run(gate, blocks[1:], state=back["g"])
    assert_same_outputs(jo, to2, event_ports=(1,))
    tckpt.save_state(p, {"g": ts2})
    jback, _, _ = jckpt.load_state(p, {"g": jb.Gate(**kw).init_state()})
    assert_same_state(jback["g"], ts2)


# ---------------------------------------------------------------------------
# BurstTagger, BurstBuffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [0, 1, 5, 64, 300])
def test_burst_tagger_equals_jax(rng, length):
    marks = (rng.random(1024) < 0.01).astype(np.float32)
    blocks = [marks[i:i + 256] for i in range(0, 1024, 256)]
    jo, js = jax_run(jb.BurstTagger(length), blocks)
    to, ts = port_run(tb.BurstTagger(length, device=CPU), blocks)
    assert_same_outputs(jo, to)
    assert_same_state(js, ts)
    assert to[0][1][0].dtype == np.uint8


def burst_buffer_inputs(rng, n, p_eob):
    so = (rng.random(n) < 0.05).astype(np.int32)
    eo = (rng.random(n) < p_eob).astype(np.int32)
    x = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x, so, eo


@pytest.mark.parametrize("ml,p_eob", [(8, 0.08), (32, 0.02), (100, 0.005)])
def test_burst_buffer_equals_jax_and_serial_mirror(rng, ml, p_eob):
    """Frames, lengths, counts and state over 4 blocks (bursts across
    several blocks, max_len truncation), equal to the JAX block and to
    its per-sample serial mirror."""
    blocks = blocks_of(burst_buffer_inputs(rng, 1024, p_eob), 256)
    jo, js = jax_run(jb.BurstBuffer(ml), blocks)
    to, ts = port_run(tb.BurstBuffer(ml, device=CPU), blocks)
    assert_same_outputs(jo, to)
    assert_same_state(js, ts)
    bb = jb.BurstBuffer(ml)
    so, _ = jax_run(bb, blocks, fn=bb._apply_scan)
    assert_same_outputs(so, to)
    assert sum(t[0][1] for t in to) > 0


def test_burst_buffer_state_from_jax_continues(rng, tmp_path):
    x, so, eo = burst_buffer_inputs(rng, 768, 0.002)
    so[150:250], so[250], eo[200:400] = 0, 1, 0  # open across a boundary
    blocks = blocks_of((x, so, eo), 256)
    _, js = jax_run(jb.BurstBuffer(100), blocks[:1])
    assert bool(js["active"])
    jo, _ = jax_run(jb.BurstBuffer(100), blocks[1:], state=js)
    bb = tb.BurstBuffer(100, device=CPU)
    p = str(tmp_path / "bb.npz")
    jckpt.save_state(p, {"bb": js})
    st, _, _ = tckpt.load_state(p, {"bb": bb.init_state()})
    to, ts = port_run(bb, blocks[1:], state=st["bb"])
    assert_same_outputs(jo, to)
    again = states_from_numpy(jax.tree_util.tree_map(np.asarray, js), CPU)
    assert_same_outputs(jo, port_run(bb, blocks[1:], state=again)[0])


# ---------------------------------------------------------------------------
# Merge, TimeKeeper, Sweep, NonBlocker, rx_time_of
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["limb", "u32"])
def test_merge_places_bursts_like_jax(rng, field):
    """Bursts whose starts straddle the block edges and the 2^32 limb
    wrap, given as the bitcast limb field or as uint32 values; overlapping
    bursts sum."""
    n, L, cap = 256, 16, 6
    base = 2 ** 32 - 100
    main = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    bursts = (rng.standard_normal((cap, L))
              + 1j * rng.standard_normal((cap, L))).astype(np.complex64)
    rel = np.array([-5, 0, 98, 105, 250, 251])
    starts = ((base + rel) & 0xFFFFFFFF).astype(np.uint32)
    sdata = starts.view(np.float32) if field == "limb" else starts
    jm = jstream.StreamMeta.start(1.0, abs_index=base)
    js = [jstream.Stream(jnp.asarray(a), jnp.int32(c), jm)
          for a, c in ((main, n), (bursts, 5), (sdata, 5))]
    _, (jy,) = jb.Merge(L).apply(None, None, *js)
    tm = tstream.StreamMeta.start(1.0, abs_index=base, device=CPU)
    tdata = torch.from_numpy(sdata if field == "limb"
                             else starts.astype(np.int64))
    def count(c):
        return torch.tensor(c, dtype=torch.int32)
    ts = [tstream.Stream(torch.from_numpy(a), count(c), tm)
          for a, c in ((main, n), (bursts, 5))]
    ts.append(tstream.Stream(tdata, count(5), tm))
    _, (ty,) = tb.Merge(L).apply(None, None, *ts)
    np.testing.assert_allclose(ty.data.numpy(), np.asarray(jy.data),
                               rtol=0, atol=1e-6)


def test_timekeeper_sweep_nonblocker_rx_time_equal_jax(rng):
    x = rng.standard_normal(300).astype(np.float32)
    abs_index = 2 ** 32 + 12345
    jm = jstream.StreamMeta.start(3.2e6, epoch_sec=17, epoch_frac=0.25,
                                  abs_index=abs_index)
    tm = tstream.StreamMeta.start(3.2e6, epoch_sec=17, epoch_frac=0.25,
                                  abs_index=abs_index, device=CPU)
    js = jstream.Stream(jnp.asarray(x), jnp.int32(250), jm)
    ts = tstream.Stream(torch.from_numpy(x),
                        torch.tensor(250, dtype=torch.int32), tm)
    _, (_, jr) = jb.TimeKeeper().apply(None, {"offset": np.float32(0.5)}, js)
    tk = tb.TimeKeeper(device=CPU)
    _, (y, tr) = tk.apply(None, dict(offset=torch.tensor(0.5)), ts)
    assert y is ts and int(tr.count) == int(jr.count) == 1
    np.testing.assert_array_equal(bits(jr.data), bits(tr.data.numpy()))
    assert jstream.decode_abs_index(tr.data[0, 0].numpy(),
                                    tr.data[0, 1].numpy()) == abs_index
    _, (jn,) = jb.NonBlocker().apply(None, None, js)
    _, (tn,) = tb.NonBlocker().apply(None, None, ts)
    np.testing.assert_array_equal(np.asarray(jn.data), tn.data.numpy())
    assert int(jn.count) == int(tn.count) == 300
    assert jb.rx_time_of(js) == tb.rx_time_of(ts)
    for rate, target in ((2e9, 100.0), (-3e9, -50.0)):
        sw, tsw = jb.Sweep(start=10.0), tb.Sweep(start=10.0, device=CPU)
        jst, tst = sw.init_state(), tsw.init_state()
        pr = dict(target=np.float32(target), rate=np.float32(rate))
        for _ in range(2):
            jst, (jy,) = sw.apply(jst, pr, js)
            tst, (ty,) = tsw.apply(
                tst, dict(target=torch.tensor(np.float32(target)),
                          rate=torch.tensor(np.float32(rate))), ts)
            np.testing.assert_allclose(ty.data.numpy(), np.asarray(jy.data),
                                       rtol=1e-6)
