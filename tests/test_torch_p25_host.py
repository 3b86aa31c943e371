"""The port's copies of the host-side P25 modules (``ops/p25_fec.py``,
``ops/p25_ldu.py``, ``models/p25_voice.py``, ``utils/des.py``,
``viz/traffic.py``) pass the JAX package's own tests.

Each test below repeats one of ``tests/test_p25_fec.py``,
``test_p25_ldu.py``, ``test_p25_voice.py``, ``test_p25_wire_voice.py``
and the DES and traffic tests of ``test_p25.py`` on the port's copies,
with the same parametrisations and seeds; the frame sync in front of
the voice decoders is the port's ``P25FrameSync`` on the CPU, whose
event tensors the decoders take as they are. The cross tests hold the
copies to the JAX modules: codewords bit-equal, and frames built by one
package parsed and decrypted by the other. Everything here is exact
integer work: no tolerance.
"""

import numpy as np
import pytest
import torch

from grbaz_tpu.models import p25_voice as jv
from grbaz_tpu.ops import p25_fec as jfec
from grbaz_tpu.ops import p25_ldu as jldu
from grbaz_tpu_torch.core.stream import Stream, StreamMeta, decode_i32
from grbaz_tpu_torch.models.p25_voice import (ALGID_CLEAR, ALGID_DES_OFB,
                                              LDU_DIBITS, WIRE_LDU_DIBITS,
                                              P25VoiceDecoder,
                                              P25WireVoiceDecoder,
                                              StubVocoder,
                                              convert_key_string, make_ldu,
                                              make_wire_ldu)
from grbaz_tpu_torch.ops import p25_fec as tfec
from grbaz_tpu_torch.ops import p25_ldu as tldu
from grbaz_tpu_torch.ops.p25 import P25FrameSync, make_frame
from grbaz_tpu_torch.ops.p25_fec import (golay23_decode, golay23_encode,
                                         hamming10_decode, hamming10_encode,
                                         hamming15_decode, hamming15_encode,
                                         lsd16_check, lsd16_encode,
                                         rs_decode, rs_encode)
from grbaz_tpu_torch.ops.p25_ldu import (DUID_LDU1, DUID_LDU2, LDU_BITS,
                                         N_STATUS, PAYLOAD_BITS,
                                         STATUS_EVERY, build_ldu, es_decode,
                                         es_encode, insert_status, lc_decode,
                                         lc_encode, parse_ldu, strip_status,
                                         vc_decode, vc_encode)

KEY = 0x0123456789ABCDEF
KEY_STR = "0123456789abcdef"
MI = 0xDEADBEEF01020304
WIRE_MI = 0xDE_ADBEEF01020304AB   # 72-bit wire MI
NAC = 0x293


def corrupt(code, positions):
    c = code.copy()
    for p in positions:
        c[p] ^= 1
    return c


def run_framesync(dibits, block=512):
    """The port's frame sync (max_errors 0) on the CPU over ``dibits`` in
    full blocks: [(block dibits, event tensor, event count tensor)]."""
    sync = P25FrameSync(max_errors=0, device="cpu")
    st, pr = sync.init_state(), sync.init_params()
    meta = StreamMeta.start(4800.0, device="cpu")
    d = np.concatenate([dibits, np.zeros((-len(dibits)) % block, np.uint8)])
    out = []
    for i in range(0, len(d), block):
        x = torch.from_numpy(d[i:i + block])
        st, (ev,) = sync.apply(st, pr, Stream.full(x, meta=meta))
        out.append((x, ev.data, ev.count))
    return out


def decode_all(dec, dibits):
    frames = []
    for dib, ev, n in run_framesync(dibits):
        frames.extend(dec.feed(dib, ev, n))
    return frames


# ---------------------------------------------------------------------------
# test_p25_fec.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nerr", [0, 1, 2, 3])
def test_golay23_corrects(nerr):
    rng = np.random.default_rng(nerr)
    for _ in range(30):
        info = (rng.random(12) < 0.5).astype(np.uint8)
        cw = golay23_encode(info)
        assert len(cw) == 23
        pos = rng.choice(23, size=nerr, replace=False)
        got, n = golay23_decode(corrupt(cw, pos))
        assert n == nerr
        np.testing.assert_array_equal(got, info)


def test_golay23_distance():
    rng = np.random.default_rng(0)
    cws = [golay23_encode((rng.random(12) < 0.5).astype(np.uint8))
           for _ in range(40)]
    for i in range(len(cws)):
        for j in range(i + 1, len(cws)):
            d = int(np.sum(cws[i] ^ cws[j]))
            assert d == 0 or d >= 7


@pytest.mark.parametrize("nerr", [0, 1])
def test_hamming15_corrects(nerr):
    rng = np.random.default_rng(nerr)
    for _ in range(30):
        info = (rng.random(11) < 0.5).astype(np.uint8)
        cw = hamming15_encode(info)
        pos = rng.choice(15, size=nerr, replace=False)
        got, n = hamming15_decode(corrupt(cw, pos))
        assert n == nerr
        np.testing.assert_array_equal(got, info)


@pytest.mark.parametrize("nerr", [0, 1])
def test_hamming10_corrects(nerr):
    rng = np.random.default_rng(10 + nerr)
    for _ in range(30):
        info = (rng.random(6) < 0.5).astype(np.uint8)
        cw = hamming10_encode(info)
        pos = rng.choice(10, size=nerr, replace=False)
        got, n = hamming10_decode(corrupt(cw, pos))
        assert n == nerr
        np.testing.assert_array_equal(got, info)


@pytest.mark.parametrize("k,nparity", [(12, 12), (16, 8)])
def test_rs_roundtrip_and_correction(k, nparity):
    rng = np.random.default_rng(k)
    t = nparity // 2
    for trial in range(20):
        data = rng.integers(0, 64, size=k).astype(np.uint8)
        cw = rs_encode(data, nparity)
        assert len(cw) == 24
        np.testing.assert_array_equal(cw[:k], data)
        nerr = int(rng.integers(0, t + 1))
        pos = rng.choice(24, size=nerr, replace=False)
        bad = cw.copy()
        for p in pos:
            bad[p] ^= int(rng.integers(1, 64))
        got, n = rs_decode(bad, nparity)
        assert n == nerr, f"trial {trial}: corrected {n} != {nerr}"
        np.testing.assert_array_equal(got, data)


def test_rs_detects_overload():
    rng = np.random.default_rng(99)
    data = rng.integers(0, 64, size=16).astype(np.uint8)
    cw = rs_encode(data, 8)
    bad = cw.copy()
    for p in rng.choice(24, size=7, replace=False):
        bad[p] ^= int(rng.integers(1, 64))
    got, n = rs_decode(bad, 8)
    assert n != 0


def test_lsd16():
    rng = np.random.default_rng(3)
    info = (rng.random(8) < 0.5).astype(np.uint8)
    cw = lsd16_encode(info)
    assert lsd16_check(cw)
    bad = cw.copy()
    bad[5] ^= 1
    assert not lsd16_check(bad)


def test_bch_nid():
    from grbaz_tpu_torch.ops.p25_fec import (_BCH_NID_G, bch_6416_check,
                                             bch_6416_encode)
    assert _BCH_NID_G.bit_length() - 1 == 47
    rng = np.random.default_rng(7)
    info = (rng.random(16) < 0.5).astype(np.uint8)
    cw = bch_6416_encode(info)
    assert cw.shape == (64,)
    assert np.array_equal(cw[:16], info)
    assert bch_6416_check(cw)
    for s in (1, 17, 44):
        assert bch_6416_check(np.concatenate([np.roll(cw[:63], s), [0]]))
    for p in (0, 15, 16, 62):
        bad = cw.copy()
        bad[p] ^= 1
        assert not bch_6416_check(bad)
    for i in range(16):
        e = np.zeros(16, np.uint8)
        e[i] = 1
        assert int(bch_6416_encode(e)[:63].sum()) >= 23


def test_wire_ldu_nid_parity():
    from grbaz_tpu_torch.ops.p25_fec import bch_6416_check
    from grbaz_tpu_torch.ops.p25_ldu import FS_BITS, NID_BITS
    rng = np.random.default_rng(11)
    voice = (rng.random((9, 88)) < 0.5).astype(np.uint8)
    dibits = make_wire_ldu(0x293, 0x5, voice)
    bits = np.stack([(dibits >> 1) & 1, dibits & 1], axis=1).reshape(-1)
    payload, _status = strip_status(bits.astype(np.uint8))
    assert bch_6416_check(payload[FS_BITS:FS_BITS + NID_BITS])


# ---------------------------------------------------------------------------
# test_p25_ldu.py
# ---------------------------------------------------------------------------

def test_geometry():
    assert PAYLOAD_BITS == 1680
    assert N_STATUS == 24
    assert LDU_BITS == 1728
    assert tldu.LDU_DIBITS == 864
    assert PAYLOAD_BITS == 48 + 64 + 9 * 144 + 6 * 40 + 32


def test_status_symbol_positions():
    payload = np.arange(PAYLOAD_BITS, dtype=np.int64) % 2
    framed = insert_status(payload.astype(np.uint8), status=0b11)
    assert framed.size == LDU_BITS
    for i in range(N_STATUS):
        base = i * (STATUS_EVERY + 2)
        assert framed[base + STATUS_EVERY] == 1
        assert framed[base + STATUS_EVERY + 1] == 1
    back, status = strip_status(framed)
    np.testing.assert_array_equal(back, payload.astype(np.uint8))
    assert all(s == 0b11 for s in status)


def test_voice_codeword_roundtrip_and_correction(rng):
    for _ in range(10):
        u = (rng.random(88) < 0.5).astype(np.uint8)
        cw = vc_encode(u)
        assert cw.size == 144
        got, n, ok = vc_decode(cw)
        assert ok and n == 0
        np.testing.assert_array_equal(got, u)
        bad = cw.copy()
        p = int(rng.integers(0, 141))
        bad[p:p + 3] ^= 1
        got, n, ok = vc_decode(bad)
        if ok:
            np.testing.assert_array_equal(got[:81], u[:81])


def test_lc_word_roundtrip(rng):
    lc = (rng.random(72) < 0.5).astype(np.uint8)
    w = lc_encode(lc)
    assert w.size == 240
    got, ok = lc_decode(w)
    assert ok
    np.testing.assert_array_equal(got, lc)
    bad = w.copy()
    bad[13] ^= 1
    bad[205] ^= 1
    got, ok = lc_decode(bad)
    assert ok
    np.testing.assert_array_equal(got, lc)


def test_es_word_roundtrip():
    mi, algid, kid = 0x1122334455667788 & ((1 << 72) - 1), 0x81, 0xBEEF
    w = es_encode(mi, algid, kid)
    got_mi, got_alg, got_kid, ok = es_decode(w)
    assert ok and got_mi == mi and got_alg == algid and got_kid == kid


@pytest.mark.parametrize("duid", [DUID_LDU1, DUID_LDU2])
def test_full_ldu_roundtrip(rng, duid):
    voice = (rng.random((9, 88)) < 0.5).astype(np.uint8)
    nid = (rng.random(64) < 0.5).astype(np.uint8)
    lc = (rng.random(72) < 0.5).astype(np.uint8)
    lsd = (rng.random(16) < 0.5).astype(np.uint8)
    frame = build_ldu(duid, nid, voice, lc72=lc, mi=0xABCDE, algid=0x81,
                      kid=0x1234, lsd16=lsd)
    assert frame.size == LDU_BITS
    out = parse_ldu(frame, duid)
    assert out.ok and out.corrected == 0
    np.testing.assert_array_equal(out.voice, voice)
    np.testing.assert_array_equal(out.nid_bits, nid)
    np.testing.assert_array_equal(out.lsd, lsd)
    if duid == DUID_LDU1:
        np.testing.assert_array_equal(out.lc, lc)
    else:
        assert (out.mi, out.algid, out.kid) == (0xABCDE, 0x81, 0x1234)


def test_ldu_under_bit_errors(rng):
    voice = (rng.random((9, 88)) < 0.5).astype(np.uint8)
    nid = np.zeros(64, np.uint8)
    frame = build_ldu(DUID_LDU2, nid, voice, mi=42, algid=0x80, kid=7)
    bad = frame.copy()
    for p in rng.choice(LDU_BITS, size=5, replace=False):
        bad[p] ^= 1
    out = parse_ldu(bad, DUID_LDU2)
    np.testing.assert_array_equal(out.voice, voice)
    assert (out.mi, out.algid, out.kid) == (42, 0x80, 7)
    assert out.corrected >= 0


# ---------------------------------------------------------------------------
# test_p25_voice.py
# ---------------------------------------------------------------------------

def test_encrypted_ldu_roundtrip():
    rng = np.random.default_rng(42)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    ldu = make_ldu(NAC, 0xA, voice, mi=MI, algid=ALGID_DES_OFB,
                   kid=0x12, key=KEY)
    assert len(ldu) == LDU_DIBITS
    stream = np.concatenate([rng.integers(0, 4, 100).astype(np.uint8),
                             ldu, rng.integers(0, 4, 64).astype(np.uint8)])
    frames = decode_all(P25VoiceDecoder(key=KEY_STR), stream)
    assert len(frames) == 9
    for i, f in enumerate(frames):
        assert f.nac == NAC and f.duid == 0xA and f.index == i
        assert f.decrypted and f.algid == ALGID_DES_OFB and f.kid == 0x12
        np.testing.assert_array_equal(f.bits, voice[i])


def test_key_map_selects_by_kid_and_wrong_key_fails():
    rng = np.random.default_rng(1)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    ldu = make_ldu(NAC, 0x5, voice, mi=MI, algid=ALGID_DES_OFB,
                   kid=0x77, key=KEY)
    stream = np.concatenate([np.zeros(40, np.uint8), ldu])
    frames = decode_all(P25VoiceDecoder(
        key_map={0x77: KEY_STR, 0x10: "0000000000000000"}), stream)
    assert len(frames) == 9
    np.testing.assert_array_equal(frames[0].bits, voice[0])
    frames = decode_all(P25VoiceDecoder(key="00000000deadbeef"), stream)
    assert frames and not np.array_equal(frames[0].bits, voice[0])


def test_clear_ldu_passthrough_and_vocoder_stub():
    rng = np.random.default_rng(2)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    ldu = make_ldu(NAC, 0x5, voice, algid=ALGID_CLEAR)
    frames = decode_all(P25VoiceDecoder(),
                        np.concatenate([np.zeros(16, np.uint8), ldu]))
    assert len(frames) == 9
    for i, f in enumerate(frames):
        assert not f.decrypted
        np.testing.assert_array_equal(f.bits, voice[i])
    audio = StubVocoder().decode(frames[0])
    assert audio.shape == (160,) and audio.dtype == np.float32


def test_key_string_conversion_parity():
    assert convert_key_string(None) is None
    assert convert_key_string(123) is None
    assert convert_key_string("") is None
    assert convert_key_string("abc") is None
    assert convert_key_string("zz") is None
    assert convert_key_string("0a1B") == [0x0A, 0x1B]
    dec = P25VoiceDecoder()
    assert not dec.set_key("abc")
    assert not dec.set_key_map({})
    assert not dec.set_key_map({1: "abc"})
    assert dec.set_key_map({1: "ff", 2: "abc"})


# ---------------------------------------------------------------------------
# test_p25_wire_voice.py
# ---------------------------------------------------------------------------

def _stream_with(ldu, rng):
    return np.concatenate([rng.integers(0, 4, 101).astype(np.uint8),
                           ldu, rng.integers(0, 4, 64).astype(np.uint8)])


def test_encrypted_wire_ldu_roundtrip():
    rng = np.random.default_rng(7)
    voice = rng.integers(0, 2, (9, 88)).astype(np.uint8)
    ldu = make_wire_ldu(NAC, 0xA, voice, mi=WIRE_MI, algid=ALGID_DES_OFB,
                        kid=0x12, key=KEY)
    assert len(ldu) == WIRE_LDU_DIBITS == 864
    frames = decode_all(P25WireVoiceDecoder(key=KEY_STR),
                        _stream_with(ldu, rng))
    assert len(frames) == 9
    for i, f in enumerate(frames):
        assert f.nac == NAC and f.duid == 0xA and f.index == i
        assert f.decrypted and f.algid == ALGID_DES_OFB and f.kid == 0x12
        np.testing.assert_array_equal(f.bits, voice[i])


def test_wrong_key_garbles():
    rng = np.random.default_rng(8)
    voice = rng.integers(0, 2, (9, 88)).astype(np.uint8)
    ldu = make_wire_ldu(NAC, 0xA, voice, mi=WIRE_MI, algid=ALGID_DES_OFB,
                        kid=0x12, key=KEY)
    frames = decode_all(P25WireVoiceDecoder(key="00000000000000ff"),
                        _stream_with(ldu, rng))
    assert len(frames) == 9
    assert sum(int(np.any(f.bits != voice[i]))
               for i, f in enumerate(frames)) == 9


def test_wire_ldu_survives_channel_errors():
    rng = np.random.default_rng(9)
    voice = rng.integers(0, 2, (9, 88)).astype(np.uint8)
    ldu = make_wire_ldu(NAC, 0xA, voice, mi=WIRE_MI, algid=ALGID_DES_OFB,
                        kid=0x12, key=KEY)
    bits = np.stack([(ldu >> 1) & 1, ldu & 1], axis=1).reshape(-1)
    for p in (300, 601, 907, 1203, 1499):
        bits[p] ^= 1
    ldu_bad = (bits.reshape(-1, 2)[:, 0] * 2
               + bits.reshape(-1, 2)[:, 1]).astype(np.uint8)
    frames = decode_all(P25WireVoiceDecoder(key=KEY_STR),
                        _stream_with(ldu_bad, rng))
    assert len(frames) == 9
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f.bits, voice[i])


def test_clear_wire_ldu1_with_lc():
    rng = np.random.default_rng(10)
    voice = rng.integers(0, 2, (9, 88)).astype(np.uint8)
    lc = rng.integers(0, 2, 72).astype(np.uint8)
    ldu = make_wire_ldu(NAC, 0x5, voice, algid=ALGID_CLEAR, lc72=lc)
    frames = decode_all(P25WireVoiceDecoder(), _stream_with(ldu, rng))
    assert len(frames) == 9
    for i, f in enumerate(frames):
        assert f.duid == 0x5 and not f.decrypted
        np.testing.assert_array_equal(f.bits, voice[i])


# ---------------------------------------------------------------------------
# test_p25.py: DES and the traffic pane
# ---------------------------------------------------------------------------

def test_des_fips_vector():
    from grbaz_tpu_torch.utils.des import des_encrypt_block, key_schedule
    rk = key_schedule(0x133457799BBCDFF1)
    assert des_encrypt_block(0x0123456789ABCDEF, rk) == 0x85E813540F0AB405


def test_des_ofb_roundtrip():
    from grbaz_tpu_torch.utils.des import ofb_crypt
    key, iv = 0x0123456789ABCDEF, 0x1234567890ABCDEF
    msg = bytes(range(23))
    ct = ofb_crypt(key, iv, msg)
    assert ct != msg
    assert ofb_crypt(key, iv, ct) == msg


def test_traffic_pane_from_frame_events():
    from grbaz_tpu_torch.viz.traffic import (TrafficPane, duid_name,
                                             frame_sync_events_to_attrs)
    rng = np.random.default_rng(3)
    dib = np.concatenate([
        rng.integers(0, 4, 30).astype(np.uint8),
        make_frame(nac=0x293, duid=0x5, payload_dibits=8, rng=rng),
        make_frame(nac=0x293, duid=0xA, payload_dibits=8, rng=rng),
    ])
    (_, ev, n), = run_framesync(dib, block=len(dib))
    rows = ev[:int(n)].numpy()
    assert len(rows) == 2
    seen = []
    pane = TrafficPane(on_update=lambda f: seen.append(f["duid"]))
    for attrs in frame_sync_events_to_attrs(rows[:, 1], rows[:, 2]):
        pane.update(attrs)
    snap = pane.snapshot()
    assert snap["nac"] == "0x293" and snap["duid"] == "LDU2"
    assert seen == ["LDU1", "LDU2"]
    assert duid_name(0x5) == "LDU1"
    pane.update({"tgid": 101, "bogus": 1})
    assert pane.snapshot()["tgid"] == "101"
    assert pane.snapshot()["nac"] == "0x293"
    assert len(pane.to_rows()) == 3
    pane.clear()
    assert all(v == "" for v in pane.snapshot().values())


# ---------------------------------------------------------------------------
# the copies against the JAX modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_codewords_equal_jax(seed):
    """Every encoder of the copy gives the JAX module's codeword, and
    every decoder its result on the same corrupted word."""
    rng = np.random.default_rng(100 + seed)
    for enc, dec, k, n, errs in (
            ("golay23", "golay23", 12, 23, 3), ("hamming15", "hamming15",
                                                11, 15, 1),
            ("hamming10", "hamming10", 6, 10, 1)):
        info = rng.integers(0, 2, k).astype(np.uint8)
        a = getattr(tfec, enc + "_encode")(info)
        np.testing.assert_array_equal(a, getattr(jfec, enc + "_encode")(info))
        bad = corrupt(a, rng.choice(n, size=errs, replace=False))
        ta, tn = getattr(tfec, dec + "_decode")(bad)
        ja, jn = getattr(jfec, dec + "_decode")(bad)
        np.testing.assert_array_equal(ta, ja)
        assert tn == jn
    for nparity, k in ((12, 12), (8, 16)):
        data = rng.integers(0, 64, k).astype(np.uint8)
        cw = tfec.rs_encode(data, nparity)
        np.testing.assert_array_equal(cw, jfec.rs_encode(data, nparity))
        bad = cw.copy()
        bad[rng.choice(24, size=nparity // 2 + 1, replace=False)] ^= 5
        (tg, tn), (jg, jn) = (tfec.rs_decode(bad, nparity),
                              jfec.rs_decode(bad, nparity))
        np.testing.assert_array_equal(tg, jg)
        assert tn == jn
    info16 = rng.integers(0, 2, 16).astype(np.uint8)
    np.testing.assert_array_equal(tfec.bch_6416_encode(info16),
                                  jfec.bch_6416_encode(info16))
    u = rng.integers(0, 2, 88).astype(np.uint8)
    np.testing.assert_array_equal(tldu.vc_encode(u), jldu.vc_encode(u))
    np.testing.assert_array_equal(tldu._VC_PERM, jldu._VC_PERM)


@pytest.mark.parametrize("duid,algid", [(DUID_LDU1, ALGID_CLEAR),
                                        (DUID_LDU2, ALGID_CLEAR),
                                        (DUID_LDU2, ALGID_DES_OFB)])
def test_wire_ldu_across_packages(duid, algid):
    """A wire LDU built by the port is the JAX package's dibit for dibit,
    and each package's decoder recovers the other's plaintext."""
    rng = np.random.default_rng(duid + algid)
    voice = rng.integers(0, 2, (9, 88)).astype(np.uint8)
    lc = rng.integers(0, 2, 72).astype(np.uint8)
    kw = dict(mi=WIRE_MI, algid=algid, kid=0x12, lc72=lc,
              key=KEY if algid == ALGID_DES_OFB else None)
    t_ldu = make_wire_ldu(NAC, duid, voice, **kw)
    np.testing.assert_array_equal(t_ldu, jv.make_wire_ldu(NAC, duid, voice,
                                                          **kw))
    stream = _stream_with(t_ldu, rng)
    t_frames = decode_all(P25WireVoiceDecoder(key=KEY_STR), stream)
    j_dec = jv.P25WireVoiceDecoder(key=KEY_STR)
    j_frames = []
    for dib, ev, n in run_framesync(stream):
        j_frames.extend(j_dec.feed(dib.numpy(), ev.numpy(), int(n)))
    assert len(t_frames) == len(j_frames) == 9
    for i, (t, j) in enumerate(zip(t_frames, j_frames)):
        np.testing.assert_array_equal(t.bits, voice[i])
        np.testing.assert_array_equal(j.bits, voice[i])
        assert (t.nac, t.duid, t.algid, t.kid, t.decrypted) == \
            (j.nac, j.duid, j.algid, j.kid, j.decrypted)


def test_container_ldu_across_packages():
    """The r3 container LDU: the JAX package builds, the port decrypts;
    the port builds, the JAX package decrypts."""
    rng = np.random.default_rng(5)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    kw = dict(mi=MI, algid=ALGID_DES_OFB, kid=0x12, key=KEY)
    j_ldu = jv.make_ldu(NAC, 0xA, voice, **kw)
    t_ldu = make_ldu(NAC, 0xA, voice, **kw)
    np.testing.assert_array_equal(t_ldu, j_ldu)
    pad = np.zeros(40, np.uint8)
    frames = decode_all(P25VoiceDecoder(key=KEY_STR),
                        np.concatenate([pad, j_ldu]))
    assert [f.index for f in frames] == list(range(9))
    j_dec = jv.P25VoiceDecoder(key=KEY_STR)
    j_frames = []
    for dib, ev, n in run_framesync(np.concatenate([pad, t_ldu])):
        j_frames.extend(j_dec.feed(dib.numpy(), ev.numpy(), int(n)))
    for i in range(9):
        np.testing.assert_array_equal(frames[i].bits, voice[i])
        np.testing.assert_array_equal(j_frames[i].bits, voice[i])
    # the events carry the sync index as an int32 bit pattern
    (_, ev, n), = run_framesync(np.concatenate([pad, t_ldu]), block=1024)
    assert int(n) == 1 and int(decode_i32(ev[0, 0].numpy())) == 40
