"""The chunk-parallel speculative walks of the lockout peak FSM and of the
FasTrak decoder, as numpy models, == their serial walks
(``ops/detect.peak_fsm_plain``, ``ops/misc.fastrak_fsm_plain``) bit for
bit. This module imports no JAX: the card tests take the models from it.

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
# The kernel cuts each row into chunks, walks every chunk but the first
# from a SEARCH guess after a warm-up, checks the guesses in order on the
# fields live in the guess's state, walks the misses again, carries each
# group of fields from the last chunk that wrote it, and patches the
# passing frames' repeat counts from the chunks before.
# ---------------------------------------------------------------------------

# the groups of fields (indices into FT_FIELDS) a state holds live, by the
# group's bit: the fire's fields, crc_bits, payload_len, the ID
GROUPS = ((1, 2, 3, 4, 7), (6,), (8,), (9,))
LIVE = (0, 1, 3, 7, 15)   # by state: SEARCH, SYNC, TYPE, DECODE, CRC


def agrees(g: list, s: list) -> bool:
    """The kernel's check: state and crc_buf, and each group live in the
    guess's state, equal."""
    if g[0] != s[0] or g[5] != s[5]:
        return False
    return all(g[i] == s[i] for grp, idx in enumerate(GROUPS)
               if LIVE[g[0]] >> grp & 1 for i in idx)


def speculative_fastrak(metric, sync, state, thr, os_, chunk, warm):
    """The kernel's scheme over rows [B, n] (numpy): (events, counts, the
    new state as a dict of numpy [B], repaired chunks per row)."""
    rows, n = metric.shape
    events = np.zeros((rows, ftm.MAX_EVENTS, 3), np.float32)
    n_ev = np.zeros(rows, np.int32)
    st = {k: np.array(v, np.int64, copy=True) for k, v in state.items()}
    repairs = np.zeros(rows, np.int64)
    for r in range(rows):
        bit = (metric[r] >= 0).astype(int)
        hit = sync[r] >= thr[r]

        def walk(s, i0, i1, on_emit=None):
            mask = 0
            for i in range(i0, i1):
                if ftm.ft_step(s, int(bit[i]), bool(hit[i]), os_) and on_emit:
                    on_emit(s[9])
                mask |= LIVE[s[0]]
            return mask

        recs = []   # speculate
        for c0 in range(0, n, chunk):
            if c0 == 0:
                s = ftm.ft_state_list(st, r)[:10]
            else:
                s = [0] * 10
                walk(s, max(c0 - warm, 0), c0)
            guess, frames = list(s), []
            mask = LIVE[guess[0]] | walk(s, c0, min(c0 + chunk, n),
                                         frames.append)
            recs.append((c0, guess, list(s), mask, frames))
        # check, carry, patch; repair the misses
        true = ftm.ft_state_list(st, r)
        S, carry = true[:10], dict(id=true[10], count=true[11], total=0)

        def put(ident, count):
            ftm.ft_emit(events[r], carry["total"], ident, count)
            carry["total"] += 1

        for c0, guess, end, mask, frames in recs:
            if c0 == 0 or agrees(guess, S):
                S[0], S[5] = end[0], end[5]
                for grp, idx in enumerate(GROUPS):
                    if mask >> grp & 1:
                        for i in idx:
                            S[i] = end[i]
                if frames:
                    add = carry["count"] if frames[0] == carry["id"] else 0
                    lead, local, last = True, 0, None
                    for ident in frames:
                        local = local + 1 if ident == last else 1
                        lead = lead and ident == frames[0]
                        put(ident, ftm._i32(local + add) if lead else local)
                        last = ident
                    carry["count"] = ftm._i32(local + add) if lead else local
                    carry["id"] = last
            else:
                repairs[r] += 1

                def true_emit(ident):
                    carry["count"] = (ftm._i32(carry["count"] + 1)
                                      if ident == carry["id"] else 1)
                    carry["id"] = ident
                    put(ident, carry["count"])
                walk(S, c0, min(c0 + chunk, n), true_emit)
        n_ev[r] = min(carry["total"], ftm.MAX_EVENTS)
        for k, v in zip(ftm.FT_FIELDS, S + [carry["id"], carry["count"]]):
            st[k][r] = v
    return events, n_ev, st, repairs


def _ft_plain(metric, sync, st, thr, os_):
    ev, c, new = ftm.fastrak_fsm_plain(
        torch.from_numpy(metric), torch.from_numpy(sync),
        {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()},
        torch.from_numpy(thr), os_)
    return ev.numpy(), c.numpy(), {k: v.numpy().astype(np.int64)
                                   for k, v in new.items()}


def ft_initial_state(rows):
    return {k: np.zeros(rows, np.int64) for k in ftm.FT_FIELDS}


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


@pytest.mark.parametrize("chunk,warm", [(32, 0), (64, 64), (200, 700),
                                        (1024, 1280)])
@pytest.mark.parametrize("scene", list(FT_SCENES))
def test_speculative_fastrak_equals_the_serial_walk(scene, chunk, warm):
    """Events, counts and the whole state bit for bit over two chained
    calls, whatever the chunk and warm-up."""
    gen = np.random.default_rng(len(scene) + chunk)
    metric, sync = FT_SCENES[scene](gen)
    os_ = int(scene.split("os ")[1]) if "os" in scene else 2
    rows, total = metric.shape
    n = total // 2
    thr = np.ones(rows, np.float32)
    st_m = st_p = ft_initial_state(rows)
    for c in range(2):
        m = np.ascontiguousarray(metric[:, c * n:(c + 1) * n])
        y = np.ascontiguousarray(sync[:, c * n:(c + 1) * n])
        em, cm, st_m, rep = speculative_fastrak(m, y, st_m, thr, os_, chunk,
                                                warm)
        ep, cp, st_p = _ft_plain(m, y, st_p, thr, os_)
        np.testing.assert_array_equal(em.view(np.int32), ep.view(np.int32))
        np.testing.assert_array_equal(cm, cp)
        for k in ftm.FT_FIELDS:
            np.testing.assert_array_equal(st_m[k], st_p[k], k)
        if scene == "sync held high" and warm <= 64:
            # nearly every guess fires out of step with the truth
            assert rep.sum() >= 0.8 * rows * (-(-n // chunk) - 1)
    assert cp.sum() > 0 or scene == "sync held high"
