"""The port's decoders (ops/decode.py) == the JAX package's, on the CPU.

The serial plain versions of the Manchester, DPLL and ACARS FSMs are held
bit for bit to the JAX scans over seeded inputs cut into blocks (partial
last blocks included): outputs, counts and the whole carried state after
every block. The DPLL is bit-equal because the plain version computes
what XLA compiles on the CPU (``phase * period`` for the scan's
``phase / freq``, one fused multiply-add in the update, on the product
that XLA does not share with the clamp's bounds).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.core.stream import StreamMeta as JMeta
from grbaz_tpu.ops import decode as jd
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.core.stream import StreamMeta as TMeta
from grbaz_tpu_torch.ops import decode as td

import chip_smoke
from torch_parity import split


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 or b.dtype == np.float32:
        return a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def step_both(jblk, tblk, blocks, counts):
    """Both blocks over the same blocks; asserts every output, count and
    the whole state equal after each block. Returns the port's outputs."""
    js = jax.tree_util.tree_map(jnp.asarray, jblk.init_state())
    ts = tblk.init_state()
    jm, tm = JMeta.start(1.0), TMeta.start(1.0, device="cpu")
    outs = []
    for b, (x, c) in enumerate(zip(blocks, counts)):
        js, jo = jblk.apply(js, jblk.init_params(), JStream(
            jnp.asarray(x), jnp.int32(c), jm))
        ts, to = tblk.apply(ts, tblk.init_params(), TStream(
            torch.from_numpy(np.ascontiguousarray(x)),
            torch.tensor(c, dtype=torch.int32), tm))
        for p, (j, t) in enumerate(zip(jo, to)):
            assert same(j.data, t.data.numpy()), (b, p)
            assert int(j.count) == int(t.count), (b, p)
        jn, tn = jax.tree_util.tree_map(np.asarray, js), to_numpy(ts)
        assert jn.keys() == tn.keys()
        for k in jn:
            assert same(jn[k], tn[k]), (b, k, jn[k], tn[k])
        outs.append(to)
    return outs


def manchester_chips(rng, n_bits, drop=None, flips=0):
    bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    chips = np.stack([1 - bits, bits], 1).reshape(-1)
    if drop is not None:
        chips = np.delete(chips, drop)
    chips[rng.integers(0, len(chips), flips)] ^= 1
    return chips, bits


@pytest.mark.parametrize("bs", [700, 1000, 4096])
@pytest.mark.parametrize("original,window,threshold",
                         [(False, 16, 8), (True, 12, 5), (False, 31, 20)])
def test_manchester_matches_jax(bs, original, window, threshold):
    rng = np.random.default_rng(bs + window)
    chips, _ = manchester_chips(rng, 3000, drop=1001, flips=6)
    blocks, counts = split(chips, bs)
    counts[0] = min(counts[0], bs - 33)    # a partial block mid-stream
    step_both(jd.ManchesterDecode(original, window, threshold),
              td.ManchesterDecode(original, window, threshold, device="cpu"),
              blocks, counts)


def test_manchester_resyncs_after_a_dropped_chip():
    # tests/test_decode_fec.py:42-58: whole blocks of 1000 chips only
    rng = np.random.default_rng(1)
    chips, bits = manchester_chips(rng, 4000, drop=1001)
    blocks = [chips[i:i + 1000] for i in range(0, len(chips) - 999, 1000)]
    outs = step_both(jd.ManchesterDecode(), td.ManchesterDecode(device="cpu"),
                     blocks, [1000] * len(blocks))
    got = np.concatenate([o[0].data[: int(o[0].count)].numpy()
                          for o in outs])
    tail = got[-1000:]
    assert max(np.mean(tail == bits[o:o + 1000])
               for o in range(len(bits) - 1000)) > 0.99


def pulse_train(rng, n, period, jitter=2.0, strays=5):
    pulses = np.zeros(n, np.uint8)
    pos = rng.uniform(0, period)
    while pos < n:
        pulses[int(pos)] = 1
        pos += period + rng.normal(0, jitter)
    pulses[rng.integers(0, n, strays)] = 1
    return pulses


@pytest.mark.parametrize("bs", [3000, 5000])
@pytest.mark.parametrize("period,start,gain,rel,ign",
                         [(100.3, 97.0, 0.1, 0.05, 0.5),
                          (16.0, 15.0, 0.05, 0.05, 0.5),
                          (60.0, 75.0, 0.3, 0.4, 0.3),
                          (40.0, 41.0, 0.3, 0.3, 0.5)])
def test_dpll_matches_jax(bs, period, start, gain, rel, ign):
    rng = np.random.default_rng(int(period) + bs)
    pulses = pulse_train(rng, 20000, period)
    blocks, counts = split(pulses, bs)
    step_both(jd.DPLLBitSync(start, gain, rel, ign),
              td.DPLLBitSync(start, gain, rel, ign, device="cpu"),
              blocks, counts)


def test_dpll_overflow_events_sum_into_the_last_row():
    pulses = np.zeros(4000, np.uint8)
    pulses[::3] = 1
    outs = step_both(jd.DPLLBitSync(3.0, 0.1), td.DPLLBitSync(
        3.0, 0.1, device="cpu"), [pulses], [4000])
    ev = outs[0][2]
    assert int(ev.count) == 512
    assert float(ev.data[511, 0]) > 3.0 * 100    # many diffs of 3 summed


def test_dpll_tracks_period():
    rng = np.random.default_rng(0)
    pulses = pulse_train(rng, 20000, 100.3, jitter=0.0, strays=0)
    blocks, counts = split(pulses, 5000)
    outs = step_both(jd.DPLLBitSync(97.0, 0.1),
                     td.DPLLBitSync(97.0, 0.1, device="cpu"), blocks, counts)
    assert abs(float(outs[-1][1].data[-1]) - 100.3) < 1.0


@pytest.mark.parametrize("a,b,c", [(0.95, 100.3, 5.015),
                                   (0.9, 97.0, 10.03),
                                   (np.float32(1 / 3), 3.0, -1.0)])
def test_fma32_rounds_once(a, b, c):
    a, b, c = np.float32(a), np.float32(b), np.float32(c)
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    got = td.fma32(a, b, c)
    lo = np.nextafter(got, np.float32(-np.inf))
    hi = np.nextafter(got, np.float32(np.inf))
    err = abs(Fraction(float(got)) - exact)
    assert err <= abs(Fraction(float(lo)) - exact)
    assert err <= abs(Fraction(float(hi)) - exact)


@pytest.mark.parametrize("sign", [1, -1])
def test_fma32_resolves_float64_ties_by_the_lost_bits(sign):
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is halfway between two float32
    # values; a c of +-2^-60 is lost in the float64 sum but decides the
    # rounding
    a = np.float32(1 + 2 ** -12)
    c = np.float32(sign * 2.0 ** -60)
    got = td.fma32(a, a, c)
    want = np.float32(1 + 2 ** -11 + (2 ** -23 if sign > 0 else 0))
    assert got == want
    assert np.float32(float(a) * float(a) + float(c)) == np.float32(
        1 + 2 ** -11)          # the plain double rounding ties to even


def acars_metrics(rng, packets, gap=(20, 90), tail=200):
    air = []
    for _ in range(packets):
        air.append(np.zeros(int(rng.integers(*gap)), np.int64))
        air.append(chip_smoke.acars_air(chip_smoke.acars_payload(
            rng, b"HELLO %d" % len(air))))
    air.append(np.zeros(tail, np.int64))
    bits = np.concatenate(air)
    return (np.where(bits == 1, -1.0, 1.0)
            * rng.uniform(0.5, 1.5, len(bits))).astype(np.float32)


@pytest.mark.parametrize("bs", [None, 900, 2500])
def test_acars_matches_jax(bs):
    rng = np.random.default_rng(3)
    m = acars_metrics(rng, 7)
    m[5] = 0.0                   # a zero metric reads as air bit 1
    bs = bs or len(m)            # one block: 7 packets, row 3 summed
    blocks, counts = split(m, bs)
    outs = step_both(jd.ACARSDecoder(), td.ACARSDecoder(device="cpu"),
                     blocks, counts)
    if bs == len(m):
        assert int(outs[0][0].count) == 4


def test_acars_threshold_and_a_packet_cut_at_252_bytes():
    rng = np.random.default_rng(4)
    # a packet with no DEL runs to 252 bytes; a preamble with 3 wrong
    # bits syncs only at threshold 3
    long = [0x01] + [0x41] * 260
    air = np.concatenate([np.zeros(50, np.int64), chip_smoke.acars_air(long),
                          np.zeros(50, np.int64)])
    pre = chip_smoke.acars_air(chip_smoke.acars_payload(rng, b"X"))
    pre[[3, 9, 20]] ^= 1
    air = np.concatenate([air, pre, np.zeros(100, np.int64)])
    m = np.where(air == 1, -1.0, 1.0).astype(np.float32)
    for thr in (2, 3):
        outs = step_both(jd.ACARSDecoder(thr), td.ACARSDecoder(
            thr, device="cpu"), [m], [len(m)])
        assert int(outs[0][0].count) == (1 if thr == 2 else 2)
        assert int(outs[0][0].data[0, 0]) == 252


def test_compact_matches_jax():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(300).astype(np.float32)
    keep = rng.random(300) < 0.4
    for cap in (None, 150, 40):
        jo, jc = jd._compact(jnp.asarray(vals), jnp.asarray(keep), cap)
        to, tc = td._compact(torch.from_numpy(vals), torch.from_numpy(keep),
                             cap)
        assert same(np.asarray(jo), to.numpy()) and int(jc) == int(tc)


@pytest.mark.parametrize("blk", ["ManchesterDecode", "DPLLBitSync",
                                 "ACARSDecoder"])
def test_states_carry_across_packages(blk):
    args = (97.0,) if blk == "DPLLBitSync" else ()
    jb = getattr(jd, blk)(*args)
    tb = getattr(td, blk)(*args, device="cpu")
    st = states_from_numpy(jb.init_state(), device="cpu")
    assert st.keys() == tb.init_state().keys()
    for k, v in tb.init_state().items():
        assert st[k].dtype == v.dtype and torch.equal(st[k], v), k
    back = to_numpy(tb.init_state())
    for k, v in jb.init_state().items():
        assert back[k].dtype == np.asarray(v).dtype and same(back[k], v), k


def test_chip_smoke_decoders_scene_on_the_cpu():
    feeds, pays, data = chip_smoke.decoder_scene("cpu")
    outs = {k: chip_smoke.run_inputs(fg, [dict(iq=x) for x in feeds[k]],
                                     chip_smoke.DEC_RATE[k])[0]
            for k, fg in chip_smoke.decoder_graphs("cpu").items()}
    chip_smoke.check_decoder_outputs(outs, pays, data)
