"""P25 Phase 1 LDU1/LDU2 wire framing (TIA-102.BAAA structure; a copy of
``grbaz_tpu/ops/p25_ldu.py``, ``_VC_PERM`` included).

The reference's op25 glue (python/baz_op25.py) defers the air-interface
voice framing to the op25 OOT, which is not in its tree; this module
supplies it natively. What is implemented to the standard's structure:

* **LDU geometry**: 1728 bits / 864 dibits per LDU = FS(48) + NID(64) +
  9 voice codewords (144 each) + 240 bits of LC (LDU1) or ES (LDU2)
  interspersed as 6x40-bit segments after VC2..VC7 + 32-bit low-speed
  data after VC8, with a status symbol (dibit) inserted after every
  70 transmitted bits (24 per LDU: 1680 payload + 48 status = 1728).
* **LC/ES coding**: LDU1 carries 72 bits of Link Control through
  RS(24,12,13) over GF(64); LDU2 carries the 96-bit Encryption Sync
  word (MI 72 + ALGID 8 + KID 16) through RS(24,16,9); each of the 24
  hexbits is then Hamming(10,6) protected -> 240 bits.
* **Voice codewords**: 88 info bits as u0..u7; u0..u3 Golay(23,12),
  u4..u6 Hamming(15,11), u7 raw (7 bits); the 114 bits after c0 are
  whitened by the PN sequence seeded from u0
  (``seed = u0 << 4; seed = (173*seed + 13849) mod 2^16`` per bit — the
  IMBE pseudo-random sequence).
* **LSD**: two (16,8) shortened-cyclic words.

One caveat is documented rather than hidden: the intra-codeword bit
interleave uses a regular 8-row column-major spreading defined HERE
(``_VC_PERM``), not the IMBE annex's published table (unavailable in
this offline environment) — frames produced and consumed by this
module round-trip and get the interleave's burst-error protection, but
bit-true interop with third-party IMBE gear would need that table
swapped in (one 144-entry constant).

Encryption: ALGID 0x81 DES-OFB keystream application lives in
models/p25_voice.py (utils/des.py); this module only carries the ES
fields.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from grbaz_tpu_torch.ops.p25_fec import (golay23_decode, golay23_encode,
                                         hamming10_decode, hamming10_encode,
                                         hamming15_decode, hamming15_encode,
                                         lsd16_check, lsd16_encode,
                                         rs_decode, rs_encode)

DUID_LDU1 = 0x5
DUID_LDU2 = 0xA

FS_BITS = 48
NID_BITS = 64
VC_BITS = 144
LC_SEG_BITS = 40
LSD_BITS = 32
PAYLOAD_BITS = FS_BITS + NID_BITS + 9 * VC_BITS + 6 * LC_SEG_BITS \
    + LSD_BITS                      # 1680
STATUS_EVERY = 70                   # one status dibit per 70 payload bits
N_STATUS = PAYLOAD_BITS // STATUS_EVERY      # 24
LDU_BITS = PAYLOAD_BITS + 2 * N_STATUS       # 1728
LDU_DIBITS = LDU_BITS // 2                   # 864

# outbound status symbol: 0b01 = "inbound channel busy" talk-around
# default the reference's infrastructure emits between subscribers
STATUS_SYMBOL = 0b01

# intra-codeword interleave (see module docstring caveat): adjacent
# transmitted bits sit 24 apart in the un-interleaved frame, so a
# channel burst of up to 3 bits always lands in 3 DIFFERENT block
# codewords (every constituent code is <= 23 bits long)
_VC_PERM = np.arange(VC_BITS).reshape(6, 24).T.reshape(-1)
_VC_INV = np.argsort(_VC_PERM)

# frame sync, 48 bits (TIA-102 FS pattern 0x5575F5FF77FF)
FS_PATTERN = 0x5575F5FF77FF


def _int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _bits_to_int(bits) -> int:
    v = 0
    for b in np.asarray(bits, np.uint8):
        v = (v << 1) | int(b)
    return v


def _pn_bits(u0: int, n: int) -> np.ndarray:
    """IMBE pseudo-random whitening sequence seeded from u0."""
    seed = (int(u0) << 4) & 0xFFFF
    out = np.zeros(n, np.uint8)
    for i in range(n):
        seed = (173 * seed + 13849) & 0xFFFF
        out[i] = seed >> 15
    return out


# ---------------------------------------------------------------------------
# voice codeword (144 bits <-> 88 info bits)
# ---------------------------------------------------------------------------

def vc_encode(u: np.ndarray) -> np.ndarray:
    """88 info bits (u0[12] u1[12] u2[12] u3[12] u4[11] u5[11] u6[11]
    u7[7]) -> 144-bit protected + whitened + interleaved codeword."""
    u = np.asarray(u, np.uint8)
    assert u.shape == (88,)
    u0, u1, u2, u3 = u[0:12], u[12:24], u[24:36], u[36:48]
    u4, u5, u6 = u[48:59], u[59:70], u[70:81]
    u7 = u[81:88]
    c0 = golay23_encode(u0)
    rest = np.concatenate([golay23_encode(u1), golay23_encode(u2),
                           golay23_encode(u3), hamming15_encode(u4),
                           hamming15_encode(u5), hamming15_encode(u6)])
    rest = rest ^ _pn_bits(_bits_to_int(u0), rest.size)   # 114 bits
    flat = np.concatenate([c0, rest, u7])                  # 144
    return flat[_VC_PERM]


def vc_decode(code: np.ndarray) -> tuple:
    """144-bit codeword -> (88 info bits, total corrected, ok)."""
    flat = np.asarray(code, np.uint8)[_VC_INV]
    c0, rest, u7 = flat[:23], flat[23:137], flat[137:144]
    u0, n0 = golay23_decode(c0)
    rest = rest ^ _pn_bits(_bits_to_int(u0), rest.size)
    parts = []
    total = max(n0, 0)
    ok = n0 >= 0
    off = 0
    for dec, width in ((golay23_decode, 23),) * 3 + \
            ((hamming15_decode, 15),) * 3:
        bits, n = dec(rest[off:off + width])
        off += width
        parts.append(bits)
        ok &= n >= 0
        total += max(n, 0)
    info = np.concatenate([u0] + parts + [u7])
    return info, total, ok


# ---------------------------------------------------------------------------
# LC / ES words (240 bits <-> 72/96 info bits)
# ---------------------------------------------------------------------------

def lc_encode(lc72: np.ndarray) -> np.ndarray:
    """72-bit Link Control -> RS(24,12) -> 24x Hamming(10,6) = 240 b."""
    hexbits = np.asarray(lc72, np.uint8).reshape(12, 6)
    hb = np.array([_bits_to_int(h) for h in hexbits], np.uint8)
    coded = rs_encode(hb, 12)
    return np.concatenate([hamming10_encode(_int_to_bits(int(h), 6))
                           for h in coded])


def lc_decode(bits240: np.ndarray) -> tuple:
    """240 bits -> (72-bit LC, ok)."""
    hb = np.zeros(24, np.uint8)
    ok = True
    for i in range(24):
        six, n = hamming10_decode(
            np.asarray(bits240[i * 10:(i + 1) * 10], np.uint8))
        ok &= n >= 0
        hb[i] = _bits_to_int(six)
    data, n = rs_decode(hb, 12)
    ok &= n >= 0
    out = np.concatenate([_int_to_bits(int(h), 6) for h in data])
    return out, ok


def es_encode(mi: int, algid: int, kid: int) -> np.ndarray:
    """96-bit Encryption Sync -> RS(24,16) -> 24x Hamming(10,6)."""
    bits = np.concatenate([_int_to_bits(mi, 72), _int_to_bits(algid, 8),
                           _int_to_bits(kid, 16)])
    hexbits = bits.reshape(16, 6)
    hb = np.array([_bits_to_int(h) for h in hexbits], np.uint8)
    coded = rs_encode(hb, 8)
    return np.concatenate([hamming10_encode(_int_to_bits(int(h), 6))
                           for h in coded])


def es_decode(bits240: np.ndarray) -> tuple:
    """240 bits -> (mi, algid, kid, ok)."""
    hb = np.zeros(24, np.uint8)
    ok = True
    for i in range(24):
        six, n = hamming10_decode(
            np.asarray(bits240[i * 10:(i + 1) * 10], np.uint8))
        ok &= n >= 0
        hb[i] = _bits_to_int(six)
    data, n = rs_decode(hb, 8)
    ok &= n >= 0
    bits = np.concatenate([_int_to_bits(int(h), 6) for h in data])
    return (_bits_to_int(bits[:72]), _bits_to_int(bits[72:80]),
            _bits_to_int(bits[80:96]), ok)


# ---------------------------------------------------------------------------
# NID (the existing ops/p25.py BCH NID is reused through make_frame on
# the TX side; RX extracts NAC/DUID upstream via P25FrameSync)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# LDU assembly / disassembly
# ---------------------------------------------------------------------------

def _payload_layout():
    """(name, n_bits) sequence of the 1680 payload bits."""
    layout = [("fs", FS_BITS), ("nid", NID_BITS), ("vc0", VC_BITS),
              ("vc1", VC_BITS)]
    for i in range(6):
        layout.append((f"lc{i}", LC_SEG_BITS))
        layout.append((f"vc{i + 2}", VC_BITS))
    layout.append(("lsd", LSD_BITS))
    layout.append(("vc8", VC_BITS))
    return layout


def insert_status(payload: np.ndarray,
                  status: int = STATUS_SYMBOL) -> np.ndarray:
    """1680 payload bits -> 1728 with a status dibit per 70 bits."""
    out = []
    s = _int_to_bits(status, 2)
    for i in range(N_STATUS):
        out.append(payload[i * STATUS_EVERY:(i + 1) * STATUS_EVERY])
        out.append(s)
    return np.concatenate(out)


def strip_status(frame: np.ndarray) -> tuple:
    """1728 bits -> (1680 payload bits, [24] status dibit values)."""
    payload, status = [], []
    for i in range(N_STATUS):
        seg = frame[i * (STATUS_EVERY + 2):(i + 1) * (STATUS_EVERY + 2)]
        payload.append(seg[:STATUS_EVERY])
        status.append(_bits_to_int(seg[STATUS_EVERY:]))
    return np.concatenate(payload), np.asarray(status, np.int64)


@dataclasses.dataclass
class LDUFields:
    duid: int
    nid_bits: np.ndarray            # 64 raw NID bits (decoded upstream)
    voice: np.ndarray               # [9, 88] info bits
    corrected: int                  # FEC corrections across the frame
    ok: bool
    lc: Optional[np.ndarray] = None         # LDU1: 72 bits
    mi: Optional[int] = None                # LDU2
    algid: Optional[int] = None
    kid: Optional[int] = None
    lsd: Optional[np.ndarray] = None        # 16 data bits
    status: Optional[np.ndarray] = None     # [24] status symbols


def build_ldu(duid: int, nid_bits: np.ndarray, voice_info: np.ndarray, *,
              lc72: Optional[np.ndarray] = None, mi: int = 0,
              algid: int = 0x80, kid: int = 0,
              lsd16: Optional[np.ndarray] = None,
              status: int = STATUS_SYMBOL) -> np.ndarray:
    """Assemble one 1728-bit LDU.

    ``voice_info`` is [9, 88] info bits (already encrypted when the ES
    says so); ``nid_bits`` the 64 NID bits from ops/p25.make_frame's
    coder. LDU1 takes ``lc72``; LDU2 takes (mi, algid, kid).
    """
    voice_info = np.asarray(voice_info, np.uint8).reshape(9, 88)
    if duid == DUID_LDU1:
        word = lc_encode(lc72 if lc72 is not None
                         else np.zeros(72, np.uint8))
    elif duid == DUID_LDU2:
        word = es_encode(mi, algid, kid)
    else:
        raise ValueError("duid must be LDU1 (0x5) or LDU2 (0xA)")
    lsd_bits = np.asarray(lsd16 if lsd16 is not None
                          else np.zeros(16, np.uint8), np.uint8)
    lsd = np.concatenate([lsd16_encode(lsd_bits[:8]),
                          lsd16_encode(lsd_bits[8:])])
    parts = {"fs": _int_to_bits(FS_PATTERN, FS_BITS),
             "nid": np.asarray(nid_bits, np.uint8),
             "lsd": lsd}
    for i in range(9):
        parts[f"vc{i}"] = vc_encode(voice_info[i])
    for i in range(6):
        parts[f"lc{i}"] = word[i * LC_SEG_BITS:(i + 1) * LC_SEG_BITS]
    payload = np.concatenate([parts[name]
                              for name, _n in _payload_layout()])
    assert payload.size == PAYLOAD_BITS
    return insert_status(payload, status)


def parse_ldu(frame: np.ndarray, duid: int) -> LDUFields:
    """Disassemble one 1728-bit LDU (FS/NID decoded upstream — the
    framework's P25FrameSync supplies NAC/DUID; duid selects LC vs ES
    interpretation)."""
    payload, status = strip_status(np.asarray(frame, np.uint8))
    fields = {}
    off = 0
    for name, n in _payload_layout():
        fields[name] = payload[off:off + n]
        off += n
    voice = np.zeros((9, 88), np.uint8)
    corrected = 0
    ok = True
    for i in range(9):
        info, n, vok = vc_decode(fields[f"vc{i}"])
        voice[i] = info
        corrected += n
        ok &= vok
    word = np.concatenate([fields[f"lc{i}"] for i in range(6)])
    out = LDUFields(duid=duid, nid_bits=fields["nid"], voice=voice,
                    corrected=corrected, ok=ok, status=status)
    if duid == DUID_LDU1:
        out.lc, lok = lc_decode(word)
        out.ok &= lok
    else:
        out.mi, out.algid, out.kid, eok = es_decode(word)
        out.ok &= eok
    lsd_ok = lsd16_check(fields["lsd"][:16]) \
        and lsd16_check(fields["lsd"][16:])
    out.lsd = np.concatenate([fields["lsd"][:8], fields["lsd"][16:24]])
    out.ok &= lsd_ok
    return out
