"""The chunk-parallel speculative walk of the lockout peak FSM and the
chain of candidate frames of the FasTrak decoder, as numpy models, ==
their serial walks (``ops/detect.peak_fsm_plain``,
``ops/misc.fastrak_fsm_plain``) bit for bit. This module imports no JAX:
the card tests take the models from it.

``csrc/peak_fsm.cu`` cuts each row into chunks of ``chunk`` samples. Every
chunk but the first walks from a guess: an idle state (not rising, not
locked, ``ave`` and ``prev`` from the input) ``warm`` samples before its
start, whose warm-up outputs are thrown away. The chunks are then checked
in order against the true end state of the chunk before; a chunk whose
guess is not equivalent to it is walked again from it. This module holds
the scheme at small sizes, where the kernel cannot run: the chunking, the
guess, the equivalence rule, the repair, and the patches of what a
speculative walk cannot know (the last emission before the chunk, and the
dead fields of an end state whose walk saw no start). Its inner walk is
``fsm_step``, the step of the plain version.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from grbaz_tpu_torch.ops import misc as ftm

from grbaz_tpu_torch.ops.cuda import peak_fsm as pf
from grbaz_tpu_torch.ops.detect import (FSM_FIELDS, PeakDetector, _i32,
                                        fsm_constants, fsm_state_list,
                                        fsm_step)

F32 = np.float32


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


def equivalent(g: list, s: list) -> bool:
    """The rule of the kernel's check: ave, prev, rising and the lockout
    count bit-equal, and where rising, the rise's fields too."""
    ave, prev, first, peak, rising, rc, pa, lc = range(8)
    if (_bits(g[ave]) != _bits(s[ave]) or _bits(g[prev]) != _bits(s[prev])
            or g[rising] != s[rising] or g[lc] != s[lc]):
        return False
    return not g[rising] or (g[rc] == s[rc] and g[pa] == s[pa]
                             and _bits(g[first]) == _bits(s[first])
                             and _bits(g[peak]) == _bits(s[peak]))


def speculative_fsm(x: np.ndarray, state: dict, thr: np.ndarray, cfg: dict,
                    chunk: int, warm: int):
    """The kernel's scheme over ``x`` [B, n]: (marks, idx_diff, the new
    state as numpy, repaired chunks per row)."""
    k = fsm_constants(cfg["min_diff"], cfg["drop"], cfg["alpha"]) + (
        cfg["min_len"], cfg["lockout"], cfg["look_ahead"])
    rows, n = x.shape
    marks = np.zeros((rows, n), np.float32)
    idx = np.zeros((rows, n), np.int32)
    st = {name: np.array(v, copy=True) for name, v in state.items()}
    repairs = np.zeros(rows, np.int64)
    for r in range(rows):
        t, base = thr[r], int(st["global_idx"][r])
        xr = x[r]

        def emit_to_outputs(rel, pos, last):
            marks[r, rel] += 1.0
            if last >= 0:
                idx[r, rel] = _i32(int(idx[r, rel]) + pos - last)

        # speculate: every chunk walks from its guess, its emissions kept
        # aside as (rel, pos)
        recs = []
        for c0 in range(0, n, chunk):
            if c0 == 0:
                s = fsm_state_list(st, r)
            else:
                s0 = max(c0 - warm, 2)
                s = [xr[s0 - 2], xr[s0 - 1], F32(0), F32(0), False, 0, 0, 0]
                for i in range(s0, c0):
                    fsm_step(s, xr[i], t, _i32(base + i), k)
            guess, emits, saw_start = list(s), [], False
            for i in range(c0, min(c0 + chunk, n)):
                was_rising = s[4]
                pos = fsm_step(s, xr[i], t, _i32(base + i), k)
                saw_start |= s[4] and not was_rising
                if pos is not None:
                    emits.append((min(max(_i32(pos - base), 0), n - 1), pos))
            recs.append((c0, guess, s, emits, guess[4] or saw_start))
        # check in order; repair the misses; patch the rest
        true = fsm_state_list(st, r)
        last = int(st["last_peak_global"][r])
        for c0, guess, end, emits, fresh in recs:
            if c0 == 0 or equivalent(guess, true):
                for rel, pos in emits:
                    emit_to_outputs(rel, pos, last)
                    last = pos
                new = list(end)
                if not fresh:  # the dead fields: the true start's, aged
                    new[2], new[3], new[5] = true[2], true[3], true[5]
                    new[6] = _i32(true[6] + end[6] - guess[6])
                true = new
            else:
                repairs[r] += 1
                for i in range(c0, min(c0 + chunk, n)):
                    pos = fsm_step(true, xr[i], t, _i32(base + i), k)
                    if pos is not None:
                        emit_to_outputs(min(max(_i32(pos - base), 0), n - 1),
                                        pos, last)
                        last = pos
        for name, v in zip(FSM_FIELDS, true):
            st[name][r] = v
        st["last_peak_global"][r] = last
        st["global_idx"][r] = _i32(base + n)
    return marks, idx, st, repairs


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _pulses(gen, rows, n, gap, noise=2e-3, height=(0.6, 1.5), width=(1, 6)):
    """A noise floor with pulses every ``gap`` (+-gap/4) samples."""
    x = noise * gen.random((rows, n))
    for r in range(rows):
        p = int(gen.integers(1, gap))
        while p < n - 8:
            w = min(int(gen.integers(*width)), n - p)
            x[r, p:p + w] = gen.uniform(*height) * np.linspace(0.5, 1.0, w)
            p += gap + int(gen.integers(-gap // 4, gap // 4 + 1))
    return x.astype(np.float32)


def scene(name, gen):
    """(x [rows, 2 * n] for two chained calls of n, config, state
    overrides, threshold)."""
    cfg, over, thr = dict(min_diff=0.5, lockout=24), {}, float("-inf")
    n = 384
    if name == "rise across a chunk boundary":
        x = _pulses(gen, 1, 2 * n, 37, width=(6, 20))
        for c in range(16, 2 * n - 24, 32):  # ramps over the boundaries
            x[0, c - 7:c + 9] = np.linspace(0.1, 1.2, 16)
    elif name == "peak in the previous chunk":
        x = _pulses(gen, 1, 2 * n, 29)
        for c in range(64, 2 * n - 8, 64):  # peak just before, fall after
            x[0, c - 3:c + 3] = (0.2, 0.9, 1.4, 1.3, 1.1, 0.001)
        cfg = dict(min_diff=0.5, lockout=3, look_ahead=6)
    elif name == "lockout across one chunk boundary":
        x = _pulses(gen, 1, 2 * n, 23)
        cfg = dict(min_diff=0.5, lockout=12)
    elif name == "lockout across several chunk boundaries":
        x = _pulses(gen, 1, 2 * n, 41)
        cfg = dict(min_diff=0.5, lockout=150)
    elif name == "monotone ramp":
        x = np.linspace(0.01, 5.0, 2 * n, dtype=np.float32)[None]
        cfg = dict(min_diff=0.5, lockout=100)
    elif name == "flat stretch, peak_age wraps":
        x = np.full((1, 2 * n), 0.25, np.float32)
        x[0, 2 * n - 40:2 * n - 36] = (0.5, 1.5, 2.0, 0.1)
        over = dict(ave=F32(0.25), prev=F32(0.25), peak_age=2 ** 31 - 100,
                    first=np.float32(0.3),
                    peak=np.float32(0.7), rise_count=7, lockout_count=0)
    elif name == "look-ahead":
        x = _pulses(gen, 1, 2 * n, 30, width=(8, 25))
        cfg = dict(min_diff=0.3, lockout=5, look_ahead=4)
    elif name == "alpha 0.3, drop 0.2":
        x = _pulses(gen, 1, 2 * n, 26)
        cfg = dict(min_diff=0.3, lockout=20, alpha=0.3, drop=0.2)
    elif name == "carried rise peaks on sample 0":
        x = _pulses(gen, 1, 2 * n, 33)
        x[0, n - 20:n - 6] = 0.001
        x[0, n - 6:n] = np.linspace(0.2, 2.0, 6)   # a rise open at the end
        x[0, n:n + 3] = (1.9, 1.8, 0.001)           # peaks before the block
        cfg = dict(min_diff=0.5, lockout=10, look_ahead=2)
    elif name == "global_idx wraps":
        x = _pulses(gen, 1, 2 * n, 27)
        over = dict(global_idx=2 ** 31 - n - 50, last_peak_global=2 ** 31 - 9)
    elif name == "rows":
        x = _pulses(gen, 3, 2 * n, 31)
        x[1] = np.linspace(0.01, 3.0, 2 * n)
        cfg = dict(min_diff=0.4, min_len=2, lockout=40, drop=0.1)
        thr = 0.05
    elif name == "two chained calls":
        x = _pulses(gen, 2, 2 * n, 35)
        x[:, n - 31:n - 29] = (0.1, 1.0)  # its lockout crosses the calls
        x[:, n + 5:n + 7] = (0.1, 1.0)    # and swallows this bump
        cfg = dict(min_diff=0.5, lockout=64)
    else:
        raise KeyError(name)
    return x, cfg, over, thr


SCENES = ("rise across a chunk boundary", "peak in the previous chunk",
          "lockout across one chunk boundary",
          "lockout across several chunk boundaries", "monotone ramp",
          "flat stretch, peak_age wraps", "look-ahead", "alpha 0.3, drop 0.2",
          "carried rise peaks on sample 0", "global_idx wraps", "rows",
          "two chained calls")


def _start_state(rows, over):
    st = {k: v.reshape(1).expand(rows).clone().numpy()
          for k, v in PeakDetector(device="cpu").init_state().items()}
    for k, v in over.items():
        st[k][:] = v
    return st


@pytest.mark.parametrize("chunk,warm", [(8, 0), (8, 4), (16, 32), (32, 4),
                                        (64, 0), (64, 32)])
@pytest.mark.parametrize("name", SCENES)
def test_speculative_walk_bit_equal_to_plain(name, chunk, warm):
    """Marks, idx_diff and every state field of the model == the plain
    version, over two chained calls; the monotone ramp misses every chunk
    but the first."""
    gen = np.random.default_rng(len(name) * 7 + chunk + warm)
    x, kw, over, t = scene(name, gen)
    cfg = PeakDetector(**kw, device="cpu").fsm_config()
    rows, n = x.shape[0], x.shape[1] // 2
    st_m = _start_state(rows, over)
    st_p = {k: torch.from_numpy(v.copy()) for k, v in st_m.items()}
    thr = np.full(rows, t, np.float32)
    total_marks, total_repairs = 0.0, 0
    for b in range(2):
        xb = np.ascontiguousarray(x[:, b * n:(b + 1) * n])
        mm, im, st_m, rep = speculative_fsm(xb, st_m, thr, cfg, chunk, warm)
        mp, ip, st_p = pf.peak_fsm(torch.from_numpy(xb), st_p,
                                   torch.from_numpy(thr), **cfg)
        np.testing.assert_array_equal(mm, mp.numpy())
        np.testing.assert_array_equal(im, ip.numpy())
        for k, v in st_p.items():
            got = st_m[k]
            if v.dtype == torch.float32:
                got, v = got.view(np.int32), v.numpy().view(np.int32)
            np.testing.assert_array_equal(got, np.asarray(v), k)
        total_marks += float(mp.sum())
        total_repairs += int(rep.sum())
        if name == "monotone ramp":
            assert list(rep) == [-(-n // chunk) - 1]
        if name == "flat stretch, peak_age wraps" and b == 0:
            assert int(st_m["peak_age"][0]) < 0
        if name == "carried rise peaks on sample 0" and b == 1:
            assert mm[0, 0] == 1.0
    if name not in ("monotone ramp", "flat stretch, peak_age wraps"):
        assert total_marks > 0
    if name == "flat stretch, peak_age wraps":
        assert total_marks == 1
    if name == "global_idx wraps":
        assert int(st_m["global_idx"][0]) < 0


def test_speculation_hits_well_spaced_pulses():
    """With the warm-up at least the lockout, pulses far apart above a
    threshold that the noise stays under repair no chunk; with no
    warm-up, the chunks inside a lockout miss."""
    gen = np.random.default_rng(1)
    x = _pulses(gen, 2, 2048, 150, width=(2, 4))
    cfg = PeakDetector(min_diff=0.3, lockout=24,
                       device="cpu").fsm_config()
    st = _start_state(2, {})
    thr = np.full(2, 0.1, np.float32)
    _, _, _, rep = speculative_fsm(x, st, thr, cfg, 32, 32)
    assert rep.sum() == 0
    _, _, _, rep0 = speculative_fsm(x, st, thr, cfg, 32, 0)
    assert rep0.sum() > 0


# ---------------------------------------------------------------------------
# the FasTrak FSM (csrc/fastrak_fsm.cu)
#
# A fire happens only in SEARCH, at a sync hit, and the frame it starts is
# a function of the metric's signs at its sampled bits alone. Pass 1 of
# the kernel works out, for every hit of a tile, the frame a fire there
# would walk; pass 2 follows the fires from each frame's end to the first
# hit after it, one block a row, writing each frame's groups of fields and
# numbering the passing frames. A frame carried in from the call before,
# or open at the row's end, is walked step by step.
# ---------------------------------------------------------------------------

OPEN = 3   # a candidate's length code: 12, 28, 76 bits (0-2), or open


def frame_len(code: int) -> int:
    return (12, 28, 76)[code]


def _crc_bytes(crc: int, v: int, nbytes: int) -> int:
    for s in range(8 * (nbytes - 1), -1, -8):
        crc = ftm._crc16_ccitt_update(crc, (v >> s) & 0xFF)
    return crc


def frame_at(bit: np.ndarray, p: int, os_: int):
    """(length code, CRC, ID) of the frame a fire at ``p`` walks over the
    row's metric signs ``bit`` (the kernel's ``frame_at``)."""
    n = len(bit)

    def word(k0, count):
        q = p + os_ * np.arange(k0, k0 + count)
        if q[-1] >= n:
            return None
        return int("".join(map(str, bit[q])), 2)

    w = word(0, 12)
    if w is None:
        return OPEN, 0, 0
    if w != ftm.SYNC_WORD:
        return 0, 0, 0
    ty = word(12, 16)
    if ty is None:
        return OPEN, 0, 0
    crc = _crc_bytes(0, ty, 2)
    if ty != ftm.PT_ID:
        return 1, crc, 0
    ident, cw = word(28, 32), word(60, 16)
    if ident is None or cw is None:
        return OPEN, 0, 0
    return 2, _crc_bytes(_crc_bytes(crc, ident, 4), cw, 2), ident


def candidates(bit: np.ndarray, hit: np.ndarray, os_: int, tile: int):
    """Pass 1: each tile's hits in position order, as (p, code, crc, id)."""
    return [[(int(p),) + frame_at(bit, int(p), os_)
             for p in np.flatnonzero(hit[t0:t0 + tile]) + t0]
            for t0 in range(0, len(bit), tile)]


def chain_fastrak(metric, sync, state, thr, os_, tile):
    """The kernel's passes over rows [B, n] (numpy): (events, counts, the
    new state as a dict of numpy [B], candidates a row, the chain's frames
    a row)."""
    rows, n = metric.shape
    events = np.zeros((rows, ftm.MAX_EVENTS, 3), np.float32)
    n_ev = np.zeros(rows, np.int32)
    st = {k: np.array(v, np.int64, copy=True) for k, v in state.items()}
    n_cand = np.zeros(rows, np.int64)
    n_frames = np.zeros(rows, np.int64)
    for r in range(rows):
        bit = (metric[r] >= 0).astype(np.int64)
        tiles = candidates(bit, sync[r] >= thr[r], os_, tile)
        tp = np.concatenate([[0], np.cumsum([len(t) for t in tiles])])
        flat = [c for t in tiles for c in t]

        def rank(q):
            """Hits before sample q: its tile's prefix and the tile's own."""
            t = q // tile
            return int(tp[t]) + sum(1 for c in tiles[t] if c[0] < q)

        s = ftm.ft_state_list(st, r)
        carry = dict(id=s[10], count=s[11], emitted=0,
                     r31=np.zeros(3, np.float32))

        def emit(ident):
            carry["count"] = (ftm._i32(carry["count"] + 1)
                              if ident == carry["id"] else 1)
            carry["id"] = ident
            v = np.array([ident >> 16, ident & 0xFFFF, carry["count"]],
                         np.float32)
            if carry["emitted"] < ftm.MAX_EVENTS - 1:
                events[r, carry["emitted"]] = v
            else:   # row 31: the later frames summed in frame order
                carry["r31"] = carry["r31"] + v
            carry["emitted"] += 1

        def walk_frame(i, fire):
            """The frame in s stepped from sample i (a fire there if
            ``fire``) to its return to SEARCH or the row's end; returns the
            sample after."""
            while i < n:
                if not fire and s[1] > 0:
                    d = min(s[1], n - i)
                    s[1] -= d
                    i += d
                    continue
                if ftm.ft_step(s, int(bit[i]), fire, os_):
                    emit(s[9])
                fire = False
                i += 1
                if s[0] == ftm.SEARCH:
                    break
            return i

        i = walk_frame(0, False) if s[0] != ftm.SEARCH else 0
        cur = rank(i) if i < n else len(flat)
        while cur < len(flat):
            p, code, crc, ident = flat[cur]
            n_frames[r] += 1
            if code == OPEN:
                walk_frame(p, True)
                break
            # the groups a frame writes: the fire's always, crc_buf and
            # crc_bits where the sync word passed, payload_len and the ID
            # where the type passed
            s[0], s[1], s[2], s[3], s[4], s[7] = (ftm.SEARCH, os_ - 1, 0, 0,
                                                  crc, int(code > 0))
            if code > 0:
                s[5], s[6] = 0, 16 if code == 1 else 64
            if code == 2:
                s[8], s[9] = 32, ident
                if crc == 0:
                    emit(ident)
            q = p + (frame_len(code) - 1) * os_ + 1
            cur = rank(q) if q < n else len(flat)
        if carry["emitted"] >= ftm.MAX_EVENTS:
            events[r, -1] = carry["r31"]
        n_ev[r] = min(carry["emitted"], ftm.MAX_EVENTS)
        for k, v in zip(ftm.FT_FIELDS, s[:10] + [carry["id"],
                                                 carry["count"]]):
            st[k][r] = v
        n_cand[r] = len(flat)
    return events, n_ev, st, n_cand, n_frames


def _ft_plain(metric, sync, st, thr, os_):
    ev, c, new = ftm.fastrak_fsm_plain(
        torch.from_numpy(metric), torch.from_numpy(sync),
        {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()},
        torch.from_numpy(thr), os_)
    return ev.numpy(), c.numpy(), {k: v.numpy().astype(np.int64)
                                   for k, v in new.items()}


def ft_initial_state(rows):
    return {k: np.zeros(rows, np.int64) for k in ftm.FT_FIELDS}


def _same_as_plain(metric, sync, st_m, st_p, thr, os_, tile):
    """One call of the model and the plain version, held bit for bit;
    returns both new states, the model's candidates and chain frames and
    the plain version's counts."""
    em, cm, st_m, cand, frames = chain_fastrak(metric, sync, st_m, thr, os_,
                                               tile)
    ep, cp, st_p = _ft_plain(metric, sync, st_p, thr, os_)
    np.testing.assert_array_equal(em.view(np.int32), ep.view(np.int32))
    np.testing.assert_array_equal(cm, cp)
    for k in ftm.FT_FIELDS:
        np.testing.assert_array_equal(st_m[k], st_p[k], k)
    return st_m, st_p, cand, frames, cp


FT_SCENES = {
    "sparse os 8": lambda g: chip_smoke.fastrak_rows(g, 2, 2 * 4096, 8),
    "dense os 2": lambda g: chip_smoke.fastrak_rows(g, 2, 2 * 3000, 2,
                                                    gap=(0, 3)),
    "many frames os 1": lambda g: chip_smoke.fastrak_rows(g, 1, 2 * 6000, 1,
                                                          gap=(0, 4)),
    "sync held high": lambda g: (chip_smoke.fastrak_rows(g, 1, 2 * 2000,
                                                         2)[0],
                                 np.full((1, 4000), 5.0, np.float32)),
}
# tiles of the kernel's pass 1: 128 samples is shorter than a frame at
# every oversampling of the scenes but 1 (76 samples)
FT_TILES = (128, 384, 1024, 8192)


@pytest.mark.parametrize("tile", FT_TILES)
@pytest.mark.parametrize("scene", list(FT_SCENES))
def test_chain_fastrak_equals_the_serial_walk(scene, tile):
    """Events, counts and the whole state bit for bit over two chained
    calls, whatever the tile; with the sync held high every sample is a
    candidate."""
    gen = np.random.default_rng(len(scene) + tile)
    metric, sync = FT_SCENES[scene](gen)
    os_ = int(scene.split("os ")[1]) if "os" in scene else 2
    rows, total = metric.shape
    n = total // 2
    thr = np.ones(rows, np.float32)
    st_m = st_p = ft_initial_state(rows)
    passed = 0
    for c in range(2):
        m = np.ascontiguousarray(metric[:, c * n:(c + 1) * n])
        y = np.ascontiguousarray(sync[:, c * n:(c + 1) * n])
        st_m, st_p, cand, frames, cp = _same_as_plain(m, y, st_m, st_p, thr,
                                                      os_, tile)
        passed += int(cp.sum())
        if scene == "sync held high":
            assert list(cand) == [n] * rows
            # a frame of 12 bits at most every 11 * os + 1 samples
            assert frames.min() >= n // (75 * os_ + 1)
        else:
            assert (frames <= cand).all()
    assert passed > 0 or scene == "sync held high"


@pytest.mark.parametrize("cut", [5, 80, 200, 290])
def test_chain_fastrak_frame_open_across_calls(cut):
    """A passing frame cut by the call's end ``cut`` samples after its fire
    (in its sync word, type, ID or CRC at oversampling 4): the chain's last
    frame is open, the state carried out is mid-frame, and the next call
    walks it to its end and emits it, bit for bit the plain version."""
    os_, n = 4, 2000
    gen = np.random.default_rng(cut)
    metric = np.full((1, 2 * n), -1.0, np.float32)
    sync = np.zeros((1, 2 * n), np.float32)
    ids = chip_smoke.FT_IDS
    for p, ident in ((300, ids[0]), (n - cut, ids[0]), (n + 700, ids[1])):
        wave = np.repeat(np.array(chip_smoke.fastrak_bits(ident), np.float32)
                         * 2 - 1, os_)
        metric[0, p:p + wave.size] = wave
        sync[0, p] = 5.0
    metric += 0.2 * gen.standard_normal(metric.shape).astype(np.float32)
    thr = np.ones(1, np.float32)
    st_m = st_p = ft_initial_state(1)
    counts = []
    for c in range(2):
        st_m, st_p, cand, frames, cp = _same_as_plain(
            metric[:, c * n:(c + 1) * n].copy(),
            sync[:, c * n:(c + 1) * n].copy(), st_m, st_p, thr, os_, 256)
        counts.append(int(cp[0]))
        if c == 0:
            assert st_m["state"][0] != ftm.SEARCH
            assert list(frames) == [2]
    assert counts == [1, 2]
    assert st_m["last_id_count"][0] == 1
