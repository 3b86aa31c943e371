"""Numpy models of the redesigned ACARS and Manchester kernels' schemes, on
the CPU, held bit for bit to the plain versions (``decode.acars_plain``,
``decode.manchester_plain``) over three chained calls, and a few of them
to the JAX blocks.

* The ACARS walk (``csrc/acars_fsm.cu``), sync to sync: the air bits, the
  candidate mask (``popc(shift_i ^ 0x3FFE5C5C) <= threshold`` for every
  bit i, the carried register supplying the bits before the call) and the
  running parity of the air bits, all from the input; then from one sync
  to the next, each packet decoded at once (byte k is the XOR of the air
  bits since the sync over bits ``s + 1 + 8k .. s + 8 + 8k``; the length
  ``etx + 4`` if the byte at ``etx + 3`` is DEL, else 252), packets 0-2
  into rows 0-2 and every later one added into row 3 in order; the
  search resuming the bit after the packet's last. A carried packet is
  finished first from its carried fields; one whose fields no real walk
  leaves (a partial byte outside 0-7 bits or above 255, a byte count
  outside 0-251) is walked bit by bit.
* The Manchester walk (``csrc/manchester_fsm.cu``), chunks over the state
  classes: the first 64 samples walked step by step from the carried
  state; from there, while the state agrees with what the input and its
  (phase, hist_len) rebuild, every chunk of ``chunk`` samples walked
  from each of the 2 (window + 1) classes from slip to slip (a slip at
  the first pair end, at least ``window - hist_len - 1`` pairs on, whose
  last ``window`` pairs hold ``threshold`` violations), the chunks' maps
  composed in order, each chunk walked again from its true class to mark
  its emitting pair ends, and the marks compacted in sample order. A
  carried state that the input cannot rebuild after 64 samples is walked
  step by step to the end.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from grbaz_tpu_torch.ops import decode

PRE = decode.ACARS_PREAMBLE
M32 = 0xFFFFFFFF


def brev32(v: int) -> int:
    return int(f"{v & M32:032b}"[::-1], 2)


def popc(v: int) -> int:
    return bin(v & M32).count("1")


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if b.dtype == np.float32:
        return a.dtype == np.float32 and np.array_equal(a.view(np.int32),
                                                        b.view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def chained(model, plain, xs, state):
    """Each input of ``xs`` through the model and the plain version in
    turn, each from its own last state; every output and the whole state
    equal after each call."""
    sm, sp = state, state
    outs = []
    for c, x in enumerate(xs):
        gm, gp = model(x, sm), plain(torch.from_numpy(x), sp)
        for a, b in zip(gm[:-1], gp[:-1]):
            assert same(a, b.numpy()), c
        sm, sp = gm[-1], gp[-1]
        for k in sp:
            assert same(np.asarray(sm[k]), sp[k].numpy()), (c, k)
        sm = {k: torch.from_numpy(np.asarray(v)) for k, v in sm.items()}
        outs.append(gp)
    return outs


def calls(a, k=3):
    n = a.shape[1] // k
    return [np.ascontiguousarray(a[:, c * n:(c + 1) * n]) for c in range(k)]


# ---------------------------------------------------------------------------
# the ACARS kernel's walk from sync to sync
# ---------------------------------------------------------------------------

MAXP = decode.ACARS_MAX_PACKET


def candidates(bits, shift, thr):
    """Bit i set where the register after air bit i, the last 32 air bits
    (the carried register's before the call), is within ``thr`` wrong
    bits of the preamble: over 32 bits read oldest first, as the kernel's
    funnel shifts read its staged words, against the reversed preamble."""
    older = [(brev32(shift) >> j) & 1 for j in range(32)]   # samples -32..-1
    ext = np.array(older + list(bits), np.int64)
    pre_r = brev32(PRE)
    out = np.zeros(len(bits), bool)
    for i in range(len(bits)):
        f = int((ext[i + 1:i + 33] << np.arange(32)).sum())   # i-31 .. i
        out[i] = popc(f ^ pre_r) <= thr
    return out, ext


def acars_step_u32(s, bit, thr, pkt):
    """One step of the JAX scan in its int32 arithmetic (the kernel's
    bit-by-bit walk of a carried packet no real walk leaves); returns the
    finished packet's length or 0."""
    s["shift"] = ((s["shift"] << 1) | bit) & M32
    dec = s["prev_bit"] ^ bit
    if s["searching"]:
        if popc(s["shift"] ^ PRE) <= thr:
            s.update(searching=0, prev_bit=0, cur_byte=0, bit_count=0,
                     byte_count=0, parity_errors=0, etx_index=-1, got_etx=0)
            pkt[:] = 0
        else:
            s["prev_bit"] = dec
        return 0
    s["prev_bit"] = dec
    cur = ((s["cur_byte"] << 1) | dec) & M32
    if s["bit_count"] + 1 != 8:
        s["cur_byte"] = cur - (1 << 32) if cur >> 31 else cur
        s["bit_count"] += 1
        return 0
    bc = s["byte_count"]
    val = int(f"{cur & 0xFF:08b}"[::-1], 2) & 0x7F
    pkt[min(max(bc, 0), MAXP - 1)] = val
    is_etx = bc > 13 and val == 3
    got_del = s["etx_index"] > 0 and bc == s["etx_index"] + 3 and val == 0x7F
    if is_etx:
        s["got_etx"] = 1
        if s["etx_index"] < 0:
            s["etx_index"] = bc
    if popc(cur) % 2 == 0:
        s["parity_errors"] += 1
    s["cur_byte"], s["bit_count"] = 0, 0
    if got_del or bc + 1 >= MAXP:
        return bc + 1
    s["byte_count"] = bc + 1
    return 0


def decode_packet(px, n, p0, q, cur0, bits0, byte0, par0, etx0, got0, pkt0):
    """One packet at once from its first air bit p0, the decoded bit at i
    being ``q ^ px[i]``, from a partial byte (cur0, bits0 bits), byte0
    bytes, par0 parity errors, etx0, got0 and the bytes pkt0. Returns
    (finished, last bit, fields): the packet's row fields if finished,
    else the open packet's state at the call's end."""
    dec = lambda i: q ^ int(px[i])                           # noqa: E731
    first = p0 + (8 - bits0) - 1                             # byte 0's end
    ends = first + 8 * np.arange(MAXP - byte0)
    done = int((ends <= n - 1).sum())
    vals, bad, etx, fin, got = [], [], etx0, None, got0
    for k in range(done):
        lo = ends[k] - 7 if k else p0
        cur = 0
        for i in range(lo, ends[k] + 1):
            cur = (cur << 1) | dec(i)
        if k == 0:
            cur |= cur0 << (8 - bits0)
        val = int(f"{cur & 0xFF:08b}"[::-1], 2) & 0x7F
        bc = byte0 + k
        old = etx                     # the JAX step reads the old index
        if bc > 13 and val == 3:
            got = 1
            if etx < 0:
                etx = bc
        vals.append(val)
        bad.append(popc(cur) % 2 == 0)
        if (old > 0 and bc == old + 3 and val == 0x7F) or bc + 1 >= MAXP:
            fin = k
            break
    pkt = np.array(pkt0, np.float32, copy=True)
    pkt[byte0:byte0 + len(vals)] = vals
    if fin is not None:
        return True, int(ends[fin]), dict(
            length=byte0 + fin + 1, parity=par0 + int(sum(bad)), pkt=pkt)
    start = int(ends[done - 1]) + 1 if done else p0
    cur = cur0 if not done else 0
    for i in range(start, n):
        cur = (cur << 1) | dec(i)
    return False, n - 1, dict(cur_byte=cur, bit_count=(bits0 if not done
                                                       else 0) + n - start,
                              byte_count=byte0 + done,
                              parity_errors=par0 + int(sum(bad)),
                              etx_index=etx, got_etx=got, pkt=pkt)


def acars_model(metrics, state, thr, resume=1):
    """The kernel's scheme over rows ``metrics`` [B, n]; returns what
    ``decode.acars_plain`` returns, as numpy. The search resumes ``resume``
    bits after a packet's last (1; 0 is a mutant)."""
    rows, n = metrics.shape
    st = {k: v.numpy().astype(np.int64).copy() if k != "pkt" else
          v.numpy().astype(np.float32).copy() for k, v in state.items()}
    out = np.zeros((rows, 4, 2 + MAXP), np.float32)
    n_pk = np.zeros(rows, np.int32)
    for r in range(rows):
        bits = (~(metrics[r] > np.float32(0))).astype(np.int64)
        s = {k: int(st[k][r]) for k in decode.ACARS_FIELDS}
        pkt = st["pkt"][r].copy()
        cand, ext = candidates(bits, s["shift"], thr)
        px = np.cumsum(bits) & 1
        q, pos, k, open_pkt = s["prev_bit"], 0, 0, None

        def emit(length, parity, row_pkt):
            nonlocal k
            row = np.concatenate([np.array([length, parity], np.float32),
                                  row_pkt])
            slot = min(k, 3)
            out[r, slot] = out[r, slot] + row
            k += 1

        def reset():
            s.update(searching=1, cur_byte=0, bit_count=0, byte_count=0,
                     parity_errors=0, etx_index=-1, got_etx=0)
            pkt[:] = 0

        if not s["searching"]:
            if 0 <= s["bit_count"] <= 7 and 0 <= s["byte_count"] < MAXP \
                    and 0 <= s["cur_byte"] < 256:
                ok, last, f = decode_packet(
                    px, n, 0, s["prev_bit"], s["cur_byte"], s["bit_count"],
                    s["byte_count"], s["parity_errors"], s["etx_index"],
                    s["got_etx"], pkt)
                if ok:
                    emit(f["length"], f["parity"], f["pkt"])
                    reset()
                    pos = last + resume
                else:
                    open_pkt = f
            else:                     # walked bit by bit
                ws = dict(s, shift=s["shift"] & M32)
                wp = pkt.copy()
                for i in range(n):
                    length = acars_step_u32(ws, int(bits[i]), thr, wp)
                    if length:
                        emit(length, ws["parity_errors"], wp)
                        q = ws["prev_bit"] ^ int(px[i])
                        reset()
                        pos = i + 1
                        break
                else:
                    open_pkt = {f: ws[f] for f in (
                        "cur_byte", "bit_count", "byte_count",
                        "parity_errors", "etx_index", "got_etx")}
                    open_pkt["pkt"] = wp
                    q = ws["prev_bit"] ^ int(px[n - 1])
        while open_pkt is None:
            hits = np.flatnonzero(cand[pos:])
            if not len(hits):
                break
            sync = pos + int(hits[0])
            q = int(px[sync])
            ok, last, f = decode_packet(px, n, sync + 1, q, 0, 0, 0, 0, -1, 0,
                                        np.zeros(MAXP, np.float32))
            if ok:
                emit(f["length"], f["parity"], f["pkt"])
                reset()
                pos = last + resume
            else:
                open_pkt = f
        if open_pkt is not None:
            s.update({f: v for f, v in open_pkt.items() if f != "pkt"},
                     searching=0)
            pkt = open_pkt["pkt"]
        s["prev_bit"] = q ^ int(px[n - 1])
        s["shift"] = int((ext[n:n + 32] << np.arange(31, -1, -1)).sum())
        n_pk[r] = min(k, 4)
        for f in decode.ACARS_FIELDS:
            st[f][r] = s[f]
        st["pkt"][r] = pkt
    new = {f: st[f].astype(np.int64 if f == "shift" else np.int32)
           for f in decode.ACARS_FIELDS}
    new["searching"] = new["searching"] != 0
    new["got_etx"] = new["got_etx"] != 0
    new["pkt"] = st["pkt"]
    return out, n_pk, new


def acars_state(rows):
    return chip_smoke.rows_state(decode.ACARSDecoder(device="cpu"), rows,
                                 "cpu")


@pytest.mark.parametrize("case", ["rows", "noise", "edge", "short", "odd"])
def test_acars_model_equals_the_plain_walk(case):
    rng = np.random.default_rng(["rows", "noise", "edge", "short",
                                 "odd"].index(case))
    thr = 2
    if case == "rows":       # more than 4 packets a call: row 3 summed
        m = chip_smoke.acars_rows(rng, 3, 3 * 3000, gap=(10, 60))[0]
    elif case == "noise":    # false syncs run to 252 bytes
        m = chip_smoke.acars_noise_rows(rng, 3, 3 * 3000)
        thr = 8
    elif case == "edge":
        m = chip_smoke.acars_edge_rows(rng, 2600, calls=3)
        thr = 4
    elif case == "short":    # calls shorter than a byte and a register
        m = chip_smoke.acars_rows(rng, 2, 3 * 5, gap=(1, 3))[0]
    else:
        m = chip_smoke.acars_rows(rng, 2, 3 * 1001, gap=(10, 60))[0]
    outs = chained(lambda x, s: acars_model(x, s, thr),
                   lambda x, s: decode.acars_plain(x, s, thr), calls(m),
                   acars_state(len(m)))
    if case == "rows":
        assert max(int(o[1].max()) for o in outs) == 4
    if case == "noise":
        assert any(int(o[1].sum()) for o in outs)


def test_acars_model_takes_carried_packets_no_walk_leaves():
    # a negative byte count, a byte count past the cap and a partial byte
    # of -2 bits are walked bit by bit; a searching state's inconsistent
    # fields pass through
    rng = np.random.default_rng(9)
    m = chip_smoke.acars_rows(rng, 4, 3 * 900, gap=(10, 60))[0]
    st = acars_state(4)
    st["searching"] = torch.tensor([False, False, False, True])
    st["bit_count"] = torch.tensor([0, 3, -2, 5], dtype=torch.int32)
    st["byte_count"] = torch.tensor([-3, 300, 4, 77], dtype=torch.int32)
    st["cur_byte"] = torch.tensor([0, 5, 1, 3], dtype=torch.int32)
    st["parity_errors"] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    st["etx_index"] = torch.tensor([-1, 20, -1, 9], dtype=torch.int32)
    m[3] = 1.0              # row 3 never syncs
    chained(lambda x, s: acars_model(x, s, 2),
            lambda x, s: decode.acars_plain(x, s, 2), calls(m), st)


def test_acars_edge_rows_do_what_they_are_for():
    rng = np.random.default_rng(2)
    n = 2600
    m = chip_smoke.acars_edge_rows(rng, n, calls=3)
    st = acars_state(len(m))
    syncs_early, open_at, resumed = set(), set(), False
    for x in calls(m):
        # bits at each call's start that sync only with the carried shift
        _, n_pk, new = decode.acars_plain(torch.from_numpy(x), st, 4)
        for r in range(len(m)):
            cand, _ = candidates((~(x[r] > 0)).astype(np.int64),
                                 int(st["shift"][r]), 4)
            blind, _ = candidates((~(x[r] > 0)).astype(np.int64), 0, 4)
            if (cand[:31] & ~blind[:31]).any():
                syncs_early.add(r)
            if not bool(new["searching"][r]):
                open_at.add(int(new["bit_count"][r]))
        # a search resumed on a packet's last bit syncs there
        got = acars_model(x, st, 4, resume=0)
        resumed |= not all(same(a, b.numpy()) for a, b in zip(
            got[:2], decode.acars_plain(torch.from_numpy(x), st, 4)[:2]))
        st = new
    assert syncs_early and len(open_at) == 8 and resumed


# ---------------------------------------------------------------------------
# the Manchester kernel's chunks over the state classes
# ---------------------------------------------------------------------------

HEAD = 64           # samples walked step by step from the carried state


def man_step(s, xi, w, thr, orig):
    """The JAX scan's step on s = [phase, prev, hist, hlen]; returns the
    emitted bit or None."""
    ph, prev, hist, hlen = s
    if ph != 1:
        s[0], s[1] = 1, xi
        return None
    viol = prev == xi
    bit = int((prev == 0 and xi == 1) != orig)
    hist = ((hist << 1) | int(viol)) & ((1 << w) - 1)
    hlen = min(hlen + 1, w)
    if hlen >= w and popc(hist) >= thr:
        s[:] = [1, xi, 0, 0]
    else:
        s[:] = [0, prev, hist, hlen]
    return None if viol else bit


def rebuild(x, viol, c, ph, h, w):
    """(prev, hist) of class (ph, h) at sample c: the first of the open
    pair, and the violations of the last min(h, w) pairs, the newest in
    bit 0 (pairs ending at c - 2, c - 4, ... when ph is 1, c - 1, c - 3,
    ... when 0)."""
    prev = int(x[c - 1] if ph == 1 else x[c - 2])
    last = c - 2 if ph == 1 else c - 1
    hist = sum(int(viol[last - 2 * j]) << j for j in range(min(h, w)))
    return prev, hist


def jump_walk(slip_ok, c, end, ph, h, w, mark=None):
    """From class (ph, h) at sample c to ``end``, slip to slip: the next
    slip is the first pair end j, at least w - h - 1 pairs on, with
    ``slip_ok[j]``; after it sample j + 1 ends the next pair. Marks the
    pair ends walked in ``mark``; returns the class at ``end``."""
    p = c if ph == 1 else c + 1
    while p < end:
        q = p + 2 * max(0, w - h - 1)
        hits = [j for j in range(q, end, 2) if slip_ok[j]]
        if not hits:
            last = p + 2 * ((end - 1 - p) // 2)
            if mark is not None:
                mark[p:last + 1:2] = True
            h = min(h + (last - p) // 2 + 1, w)
            p = last + 2
            break
        j = hits[0]
        if mark is not None:
            mark[p:j + 1:2] = True
        p, h = j + 1, 0
    return (1 if p == end else 0), h


def manchester_model(bits, count, state, original, w, thr, chunk=256):
    """The kernel's scheme over rows ``bits`` [B, n]; returns what
    ``decode.manchester_plain`` returns, as numpy."""
    x_all = (bits != 0).astype(np.int64)
    rows, n = x_all.shape
    cap = n // 2 + 1
    cnt = np.broadcast_to(count.numpy().reshape(-1), (rows,))
    st = {k: v.numpy().astype(np.int64).copy() for k, v in state.items()}
    out = np.zeros((rows, cap), np.uint8)
    n_out = np.zeros(rows, np.int32)
    nc = w + 1
    for r in range(rows):
        x, valid = x_all[r], int(cnt[r])
        s = [int(st[f][r]) for f in decode.MAN_FIELDS]
        emit = np.zeros(n, bool)
        bit0 = None                  # the first sample's bit (carried prev)
        head = min(n, HEAD)
        for i in range(head):
            b = man_step(s, int(x[i]), w, thr, original)
            if b is not None and i < valid:
                emit[i] = True
                if i == 0:
                    bit0 = b
        viol = np.zeros(n, bool)
        viol[1:] = x[1:] == x[:-1]
        win = np.zeros(n, np.int64)       # violations of the last w pairs
        for j in range(2 * w - 2, n):
            win[j] = viol[j - 2 * (w - 1):j + 1:2].sum()
        slip_ok = win >= thr
        if n > HEAD:
            ph, prev, hist, h = s
            good = ph in (0, 1) and 0 <= h <= w and \
                rebuild(x, viol, HEAD, ph, h, w) == (prev, hist)
            if good:
                starts = list(range(HEAD, n, chunk))
                maps = np.zeros((len(starts), 2 * nc), np.int64)
                for k, c in enumerate(starts):   # in parallel on the card
                    for cls in range(2 * nc):
                        e = jump_walk(slip_ok, c, min(n, c + chunk),
                                      cls // nc, cls % nc, w)
                        maps[k, cls] = e[0] * nc + e[1]
                cls = ph * nc + h
                true = []
                for k in range(len(starts)):      # the composition
                    true.append(cls)
                    cls = int(maps[k, cls])
                mark = np.zeros(n, bool)
                for k, c in enumerate(starts):   # in parallel on the card
                    jump_walk(slip_ok, c, min(n, c + chunk), true[k] // nc,
                              true[k] % nc, w, mark)
                emit |= mark & ~viol & (np.arange(n) < valid)
                ph, h = cls // nc, cls % nc
                s = [ph, *rebuild(x, viol, n, ph, h, w), h]
            else:                    # step by step to the end
                for i in range(HEAD, n):
                    b = man_step(s, int(x[i]), w, thr, original)
                    if b is not None and i < valid:
                        emit[i] = True
        at = np.flatnonzero(emit)
        vals = (x[at] ^ int(original)).astype(np.int64)
        if bit0 is not None:
            vals[0] = bit0
        direct = min(len(at), cap - 1)
        out[r, :direct] = vals[:direct]
        out[r, cap - 1] = int(vals[cap - 1:].sum()) & 0xFF
        n_out[r] = min(len(at), cap)
        for f, v in zip(decode.MAN_FIELDS, s):
            st[f][r] = v
    new = {k: v.astype(np.int64 if k == "viol_hist" else np.int32)
           for k, v in st.items()}
    return out, n_out, new


def man_state(rows):
    return chip_smoke.rows_state(decode.ManchesterDecode(device="cpu"), rows,
                                 "cpu")


MAN_CASES = {  # name -> (rows maker, original, window, threshold)
    "rows": ("rows", False, 16, 8),
    "noise": ("noise", False, 16, 8),
    "original": ("rows", True, 12, 5),
    "window 1, threshold 0": ("noise", False, 1, 0),
    "window 1, threshold 2": ("rows", False, 1, 2),
    "window 31, threshold 0": ("noise", True, 31, 0),
    "window 31, threshold 32": ("rows", False, 31, 32),
    "window 31, threshold 12": ("noise", False, 31, 12),
    "window 5, threshold 3": ("noise", True, 5, 3),
}


@pytest.mark.parametrize("name", sorted(MAN_CASES))
@pytest.mark.parametrize("n", [3000, 2999, 301, 41])
def test_manchester_model_equals_the_plain_walk(name, n):
    kind, original, w, thr = MAN_CASES[name]
    rng = np.random.default_rng(n + w * 100 + thr)
    rows = 4
    chips = (chip_smoke.manchester_rows(rng, rows, 3 * n)[0]
             if kind == "rows" else
             rng.integers(0, 2, (rows, 3 * n)).astype(np.uint8))
    counts = torch.tensor([n, n - 7, max(1, n - 1000), 0], dtype=torch.int32)
    chained(lambda x, s: manchester_model(x, counts, s, original, w, thr,
                                          chunk=128),
            lambda x, s: decode.manchester_plain(x, counts, s, original, w,
                                                 thr), calls(chips),
            man_state(rows))


def test_manchester_model_takes_inconsistent_carried_states():
    # hist bits above hist_len, a prev of 5, a phase of 3; a hist_len of
    # -100 (no class after the first 64 samples: walked step by step) and
    # of -25 (in range after them, short of the violations it holds)
    rng = np.random.default_rng(11)
    chips = rng.integers(0, 2, (4, 3 * 900)).astype(np.uint8)
    chips[:2] = chip_smoke.manchester_rows(rng, 2, 3 * 900)[0]
    st = man_state(4)
    st["phase"] = torch.tensor([1, 3, 0, 1], dtype=torch.int32)
    st["prev"] = torch.tensor([5, 1, 0, 1], dtype=torch.int32)
    st["viol_hist"] = torch.tensor([0xFFFF, 0xF0F0F0F0, 3, 1])
    st["hist_len"] = torch.tensor([2, 40, -100, -25], dtype=torch.int32)
    for n in (900, 75):   # 75: the state at the end not yet a class's
        counts = torch.tensor([n], dtype=torch.int32)
        for w, thr in ((16, 8), (4, 1)):
            chained(lambda x, s: manchester_model(x, counts, s, False, w,
                                                  thr),
                    lambda x, s: decode.manchester_plain(x, counts, s, False,
                                                         w, thr),
                    calls(chips[:, :3 * n]), st)


def test_manchester_capacity_overflows_at_threshold_0():
    # threshold 0 slips at every pair end: alternating chips emit at every
    # sample after the first, past the n / 2 + 1 slots, and the last slot
    # sums them with uint8 wrap
    x = np.tile(np.array([0, 1], np.uint8), (1, 600))
    counts = torch.tensor([1200], dtype=torch.int32)
    out, n_out, _ = decode.manchester_plain(torch.from_numpy(x), counts,
                                            man_state(1), False, 1, 0)
    # emissions 600-1198 (samples 601-1199, bits x[i]) in the last slot
    assert int(n_out[0]) == 601 and int(out[0, -1]) == 300 % 256
    got = manchester_model(x, counts, man_state(1), False, 1, 0)
    assert same(got[0], out.numpy()) and same(got[1], n_out.numpy())


def test_models_equal_the_jax_blocks():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from torch_parity import jax_run, split
    from grbaz_tpu.ops import decode as jd
    rng = np.random.default_rng(21)
    # ACARS: three calls of the chip_smoke rows, and noise at threshold 8
    for m, thr in ((chip_smoke.acars_rows(rng, 1, 3 * 1500, gap=(10, 60))[0],
                    2), (chip_smoke.acars_noise_rows(rng, 1, 3 * 1500), 8)):
        blocks, counts = split(m[0], 1500)
        jo, js = jax_run(jd.ACARSDecoder(thr), blocks, counts)
        st = acars_state(1)
        for b, x in enumerate(blocks):
            got = acars_model(x[None], st, thr)
            assert same(got[0][0], jo[b][0][0]) and int(got[1][0]) == \
                jo[b][0][1]
            st = {k: torch.from_numpy(np.asarray(v)) for k, v in
                  got[2].items()}
        for k, v in js.items():
            assert same(np.asarray(st[k]).reshape(np.shape(v)),
                        np.asarray(v)), k
    # Manchester: random chips at window 5, threshold 3, a partial block
    chips = rng.integers(0, 2, 3 * 700).astype(np.uint8)
    blocks, counts = split(chips, 700)
    counts[1] = 500
    blk = jd.ManchesterDecode(True, 5, 3)
    jo, js = jax_run(blk, blocks, counts)
    st = man_state(1)
    for b, x in enumerate(blocks):
        got = manchester_model(x[None], torch.tensor([counts[b]]), st, True,
                               5, 3, chunk=128)
        assert same(got[0][0], jo[b][0][0]) and int(got[1][0]) == jo[b][0][1]
        st = {k: torch.from_numpy(np.asarray(v)) for k, v in got[2].items()}
    for k, v in js.items():
        assert same(np.asarray(st[k]).reshape(()), np.asarray(v)), k
    del jax, jnp
