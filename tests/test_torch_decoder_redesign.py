"""Numpy models of the redesigned decoder kernels' schemes, on the CPU.

* The Viterbi kernel's traceback (``csrc/viterbi.cu``: ``trace_map``,
  ``trace_bits``): the decisions packed in the kernel's word layout
  (word w of step t at ``((t // 32) * S + w) * 32 + t % 32``), every
  chunk of L steps mapped from end state to start state, the maps
  composed from the lowest-index best final state, every chunk's bits
  traced from its end state. Held to the serial traceback and to
  ``fec.viterbi_plain`` for several L and T (T = 1, T < L, T not a
  multiple of L).
* The DPLL walk (``csrc/dpll_walk.cu``): tiles of 1024 samples, four
  neighbouring samples a lane in groups of 128, and a pulse list in
  sample order; the walk from pulse to pulse (the fadd chain between
  pulses, freq computed again only on a pulse); each pulse's period by
  its place in the list, and the period estimates from the pulses before
  each lane's four samples and their popcount. Held bit for bit to
  ``decode.dpll_plain`` over chained calls on rows with no pulse, a
  pulse at sample 0, more than 511 events, with and without the fused
  gain product.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from grbaz_tpu_torch.ops import decode, fec

f32 = np.float32


# ---------------------------------------------------------------------------
# the Viterbi kernel's chunked traceback
# ---------------------------------------------------------------------------

def forward(soft, exp):
    """(choices [T, ns] bool, final path metrics [ns]): the add-compare-
    select pass in float32, as ``fec.viterbi_plain`` runs it."""
    ns = exp.shape[0]
    st = np.arange(ns)
    prev = np.stack([(2 * st) % ns, (2 * st + 1) % ns], 1)
    pm = np.full(ns, -1e9, f32)
    pm[0] = 0.0
    choices = np.zeros((len(soft), ns), bool)
    for t, (r0, r1) in enumerate(soft):
        bm = (exp[:, :, 0] * r0).astype(f32) + (exp[:, :, 1] * r1).astype(f32)
        cand = pm[prev] + bm
        c = cand[:, 1] > cand[:, 0]
        new = np.where(c, cand[:, 1], cand[:, 0])
        pm = new - new.max()
        choices[t] = c
    return choices, pm


def pack(choices):
    """The kernel's decision words: S = max(ns / 32, 1) words a step, in
    groups of 32 steps, word w of step t at ((t // 32) * S + w) * 32 +
    t % 32 (bit s % 32 of word s // 32 is state s's choice)."""
    t_len, ns = choices.shape
    s_words = max(ns // 32, 1)
    groups = -(-t_len // 32)
    words = np.zeros(groups * s_words * 32, np.uint32)
    for t in range(t_len):
        for w in range(s_words):
            bits = choices[t, 32 * w:32 * w + 32].astype(np.uint64)
            v = int((bits << np.arange(len(bits), dtype=np.uint64)).sum())
            words[((t // 32) * s_words + w) * 32 + t % 32] = v
    return words


def pred(words, t, s, ns):
    """The state step t came from, given the state it reached."""
    s_words = max(ns // 32, 1)
    w = int(words[((t // 32) * s_words + (s >> 5)) * 32 + t % 32])
    return 2 * (s & (ns // 2 - 1)) + ((w >> (s & 31)) & 1)


def serial_traceback(choices, pm):
    ns = choices.shape[1]
    bits = np.zeros(len(choices), np.uint8)
    s = int(np.argmax(pm))
    for t in range(len(choices) - 1, -1, -1):
        bits[t] = s >> (ns.bit_length() - 2)
        s = 2 * (s % (ns // 2)) + int(choices[t, s])
    return bits


def chunked_traceback(words, t_len, ns, best, chunk):
    """trace_map, then trace_bits, as the kernel runs them."""
    chunks = -(-t_len // chunk)
    maps = np.full((chunks, ns), -1, np.int64)
    for c in range(1, chunks):          # in parallel on the card
        t0 = c * chunk
        for s0 in range(ns):
            s = s0
            for t in range(min(t_len, t0 + chunk) - 1, t0 - 1, -1):
                s = pred(words, t, s, ns)
            maps[c, s0] = s
    bits = np.zeros(t_len, np.uint8)
    for c in range(chunks):             # in parallel on the card
        s = best
        for d in range(chunks - 1, c, -1):
            s = int(maps[d, s])
        for t in range(min(t_len, (c + 1) * chunk) - 1, c * chunk - 1, -1):
            bits[t] = s >> (ns.bit_length() - 2)
            s = pred(words, t, s, ns)
    return bits


@pytest.mark.parametrize("k,polys", [(2, (0o3, 0o2)), (5, (0o23, 0o35)),
                                     (7, (0o171, 0o133))])
@pytest.mark.parametrize("t_len", [1, 5, 31, 32, 33, 100, 511, 513, 1500])
@pytest.mark.parametrize("chunk", [32, 96, 512])
def test_chunked_traceback_equals_the_serial_one(k, polys, t_len, chunk):
    rng = np.random.default_rng(k * 1000 + t_len)
    bits = rng.integers(0, 2, t_len).astype(np.uint8)
    soft = fec.conv_encode(bits, k, polys).astype(f32) * 2 - 1
    soft = (soft + 0.8 * rng.standard_normal(soft.shape)).astype(f32)
    soft[rng.random(t_len) < 0.1] = 0.0      # erasures: ties
    exp = fec.expected_outputs(k, polys)
    choices, pm = forward(soft, exp)
    ns = exp.shape[0]
    best = int(np.flatnonzero(pm == pm.max())[0])
    want = serial_traceback(choices, pm)
    got = chunked_traceback(pack(choices), t_len, ns, best, chunk)
    np.testing.assert_array_equal(got, want)
    plain_bits, plain_pm = fec.viterbi_plain(torch.from_numpy(soft),
                                             torch.from_numpy(exp))
    np.testing.assert_array_equal(want, plain_bits.numpy())
    np.testing.assert_array_equal(pm.view(np.int32),
                                  plain_pm.numpy().view(np.int32))


def test_path_metrics_are_never_negative_zero():
    # the kernel's max is a redux.sync over order-preserving int32 keys,
    # which tells -0 from +0: no normalised metric may be -0, erasures
    # (+-0 soft pairs) included
    rng = np.random.default_rng(3)
    k, polys = 7, (0o171, 0o133)
    soft = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0], f32), (3000, 2))
    exp = fec.expected_outputs(k, polys)
    ns = exp.shape[0]
    st = np.arange(ns)
    prev = np.stack([(2 * st) % ns, (2 * st + 1) % ns], 1)
    pm = np.where(st == 0, f32(0), f32(-1e9)).astype(f32)
    for r0, r1 in soft:
        bm = (exp[:, :, 0] * r0).astype(f32) + (exp[:, :, 1] * r1).astype(f32)
        cand = pm[prev] + bm
        new = np.where(cand[:, 1] > cand[:, 0], cand[:, 1], cand[:, 0])
        assert not np.any((new == 0) & np.signbit(new))
        pm = new - new.max()
        assert not np.any((pm == 0) & np.signbit(pm))


# ---------------------------------------------------------------------------
# the DPLL kernel's pulse-to-pulse walk
# ---------------------------------------------------------------------------

TILE = 1024
MAX_EVENTS = decode.DPLL_MAX_EVENTS


def advance(phase, freq, n):
    """n samples with no pulse: the fadd chain, one float32 rounding a
    sample."""
    if n <= 0:
        return phase
    return np.add.accumulate(np.concatenate([[phase], np.full(n, freq, f32)]),
                             dtype=f32)[-1]


def i32(v):
    return decode._i32(v)


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if b.dtype == f32:
        return a.dtype == f32 and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def dpll_walk_model(pulses, state, gain, rel, ign):
    """The kernel's walk over rows [B, n] (uint8) from the [B] state
    numpy arrays; returns what ``decode.dpll_plain`` returns, as numpy."""
    rows, n = pulses.shape
    omg, g, lo, hi, ig = f32(1 - gain), f32(gain), f32(1 - rel), \
        f32(1 + rel), f32(ign)
    fuse = decode.dpll_fuses_gain(gain, rel)
    p_out = (pulses != 0).astype(np.uint8)
    periods = np.full((rows, n), np.nan, f32)
    events = np.full((rows, MAX_EVENTS, 3), np.nan, f32)
    n_ev = np.zeros(rows, np.int32)
    new = {key: np.array(v, copy=True) for key, v in state.items()}
    for r in range(rows):
        per, ph = f32(state["period"][r]), f32(state["phase"][r])
        cnt, last = int(state["count"][r]), int(state["last_idx"][r])
        gidx = int(state["global_idx"][r])
        freq = f32(1) / per
        k, pos = 0, 0
        sums = np.zeros(3, f32)
        for t0 in range(0, n, TILE):
            tile = np.zeros(TILE, bool)
            tile[:min(TILE, n - t0)] = pulses[r, t0:t0 + TILE] != 0
            # lane l's four samples 128 grp + 4 l + j of group grp as a mask
            nib = [[int(sum(tile[128 * grp + 4 * lane + j] << j
                            for j in range(4))) for lane in range(32)]
                   for grp in range(TILE // 128)]
            # the pulse list: group by group, lane by lane
            base, total = [], 0
            for grp in range(TILE // 128):
                counts = [bin(v).count("1") for v in nib[grp]]
                base.append([total + sum(counts[:lane])
                             for lane in range(32)])
                total += sum(counts)
            plist = [128 * grp + 4 * lane + j for grp in range(TILE // 128)
                     for lane in range(32) for j in range(4)
                     if nib[grp][lane] >> j & 1]
            assert plist == sorted(plist) and len(plist) == total
            pper = np.full(TILE, np.nan, f32)
            start = per
            for p, j in enumerate(plist):
                i = t0 + j
                ph = advance(ph, freq, i - pos)
                pos = i + 1
                phase = f32(ph + freq)
                cur = f32(phase * per)
                if cnt > 0 and abs(f32(f32(cur - per) / per)) < ig:
                    clamped = min(max(cur, f32(per * lo)), f32(per * hi))
                    per = (decode.fma32(g, clamped, f32(omg * per))
                           if fuse else
                           decode.fma32(omg, per, f32(g * clamped)))
                    freq = f32(1) / per
                now = i32(gidx + i)
                if last >= 0:
                    row = np.array([i32(now - last), per, cur], f32)
                    if k < MAX_EVENTS - 1:
                        events[r, k] = row
                    else:
                        sums = (sums + row).astype(f32)
                    k += 1
                ph, cnt, last = f32(0), i32(cnt + 1), now
                pper[p] = per
            # the estimates: the pulses before the lane's four plus those
            # of its four up to the sample
            for grp in range(TILE // 128):
                for lane in range(32):
                    for j in range(4):
                        i = t0 + 128 * grp + 4 * lane + j
                        if i < n:
                            before = base[grp][lane] + bin(
                                nib[grp][lane] & ((2 << j) - 1)).count("1")
                            periods[r, i] = (pper[before - 1] if before
                                             else start)
        ph = advance(ph, freq, n - pos)
        events[r, min(k, MAX_EVENTS - 1):MAX_EVENTS - 1] = 0
        events[r, MAX_EVENTS - 1] = sums
        n_ev[r] = min(k, MAX_EVENTS)
        new["period"][r], new["phase"][r] = per, ph
        new["count"][r], new["last_idx"][r] = cnt, last
        new["global_idx"][r] = i32(gidx + n)
    return p_out, periods, events, n_ev, new


@pytest.mark.parametrize("gain,rel,ign", [(0.05, 0.05, 0.5), (0.3, 0.4, 0.3),
                                          (0.1, 0.05, 0.5)])
@pytest.mark.parametrize("n", [3000, 1024, 700])
def test_dpll_walk_model_equals_the_plain_walk(gain, rel, ign, n):
    rng = np.random.default_rng(int(gain * 100) + n)
    rows = np.concatenate([chip_smoke.dpll_edge_rows(rng, n, calls=3),
                           chip_smoke.pulse_rows(rng, 2, 3 * n,
                                                 period=(3.0, 120.0))])
    state = {k: v.numpy() for k, v in chip_smoke.rows_state(
        decode.DPLLBitSync(16.0, device="cpu"), len(rows), "cpu").items()}
    state["period"] = np.array([3.1, 47.0, 3.0, 100.0, 15.5, 40.0, 97.0,
                                11.0], f32)
    state["global_idx"] = np.array([0, 2 ** 31 - 2000, 5, -7, 0, 1, 0, 9],
                                   np.int32)
    sm, sp = state, {k: torch.from_numpy(v) for k, v in state.items()}
    for c in range(3):
        x = np.ascontiguousarray(rows[:, c * n:(c + 1) * n])
        got = dpll_walk_model(x, sm, gain, rel, ign)
        want = decode.dpll_plain(torch.from_numpy(x), sp, gain, rel, ign)
        for a, b in zip(got[:-1], want[:-1]):
            assert same(a, b.numpy()), c
        sm, sp = got[-1], want[-1]
        for key in sp:
            assert same(sm[key], sp[key].numpy()), (c, key)
    # the edge rows did what they are for
    if n >= 3 * MAX_EVENTS:
        assert int(want[3][2]) == MAX_EVENTS     # past 511 events a call
    assert int(want[3][0]) == 0              # no pulse

