"""P25 Phase 1 block codes: Golay(23,12), Hamming(15,11), Hamming(10,6),
shortened Reed-Solomon over GF(64), and the (16,8) LSD cyclic code (a
copy of ``grbaz_tpu/ops/p25_fec.py``: numpy only, so the port imports it
without JAX).

These are the TIA-102.BAAA FEC primitives the LDU voice frames are
built from. The reference defers them to the op25 OOT (not present in
its tree — the reference's patch/op25/ is build glue only); this
framework implements them from the public standard's math. Everything
is numpy bit-vector based: the codes run at voice-frame rates (tens of
frames/s), squarely host-side work, mirroring where the reference's
op25 glue ran them.

Conventions: bit vectors are uint8 arrays, MSB-first within a field.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# binary cyclic-code helpers
# ---------------------------------------------------------------------------


def _poly_mod_bits(dividend: int, divisor: int, nbits: int) -> int:
    """GF(2) polynomial remainder of dividend (degree < nbits+deg) by
    divisor."""
    deg = divisor.bit_length() - 1
    for shift in range(nbits - 1, -1, -1):
        if dividend & (1 << (shift + deg)):
            dividend ^= divisor << shift
    return dividend


def _bits_to_int(bits: np.ndarray) -> int:
    v = 0
    for b in np.asarray(bits, np.uint8):
        v = (v << 1) | int(b)
    return v


def _int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


# ---------------------------------------------------------------------------
# Golay (23,12,7) — IMBE u0..u3 protection
# g(x) = x^11+x^10+x^6+x^5+x^4+x^2+1 (0xC75), the standard generator
# ---------------------------------------------------------------------------

_GOLAY_G = 0xC75


def golay23_encode(info: np.ndarray) -> np.ndarray:
    """12 info bits -> 23-bit systematic codeword [info | parity11]."""
    d = _bits_to_int(info)
    parity = _poly_mod_bits(d << 11, _GOLAY_G, 12)
    return np.concatenate([_int_to_bits(d, 12), _int_to_bits(parity, 11)])


def _golay_syndrome_table():
    """syndrome -> error pattern (23-bit int) for weight <= 3 errors."""
    table = {}
    for w_bits in _error_patterns(23, 3):
        cw = w_bits
        d = cw >> 11
        syn = _poly_mod_bits(d << 11, _GOLAY_G, 12) ^ (cw & 0x7FF)
        table[syn] = w_bits
    return table


def _error_patterns(n: int, max_w: int):
    """All bit patterns of weight <= max_w over n bits (incl. zero)."""
    yield 0
    idx = list(range(n))
    for i in idx:
        yield 1 << i
    for i in idx:
        for j in idx[i + 1:]:
            yield (1 << i) | (1 << j)
    if max_w >= 3:
        for i in idx:
            for j in idx[i + 1:]:
                for k in idx[j + 1:]:
                    yield (1 << i) | (1 << j) | (1 << k)


_GOLAY_SYN = None


def golay23_decode(code: np.ndarray) -> tuple:
    """23-bit codeword -> (12 info bits, n_corrected). Corrects <= 3
    errors (the code's full capability)."""
    global _GOLAY_SYN
    if _GOLAY_SYN is None:
        _GOLAY_SYN = _golay_syndrome_table()
    cw = _bits_to_int(code)
    d = cw >> 11
    syn = _poly_mod_bits(d << 11, _GOLAY_G, 12) ^ (cw & 0x7FF)
    err = _GOLAY_SYN.get(syn)
    if err is None:
        # uncorrectable: return the systematic part as-is
        return _int_to_bits(d, 12), -1
    fixed = cw ^ err
    return _int_to_bits(fixed >> 11, 12), bin(err).count("1")


# ---------------------------------------------------------------------------
# Hamming (15,11,3) — IMBE u4..u6 protection
# g(x) = x^4 + x + 1
# ---------------------------------------------------------------------------

_HAM15_G = 0x13


def hamming15_encode(info: np.ndarray) -> np.ndarray:
    d = _bits_to_int(info)
    parity = _poly_mod_bits(d << 4, _HAM15_G, 11)
    return np.concatenate([_int_to_bits(d, 11), _int_to_bits(parity, 4)])


def hamming15_decode(code: np.ndarray) -> tuple:
    cw = _bits_to_int(code)
    d = cw >> 4
    syn = _poly_mod_bits(d << 4, _HAM15_G, 11) ^ (cw & 0xF)
    if syn == 0:
        return _int_to_bits(d, 11), 0
    # single-error: find the bit whose column matches the syndrome
    for i in range(15):
        e = 1 << i
        es = _poly_mod_bits((e >> 4) << 4, _HAM15_G, 11) ^ (e & 0xF)
        if es == syn:
            fixed = cw ^ e
            return _int_to_bits(fixed >> 4, 11), 1
    return _int_to_bits(d, 11), -1


# ---------------------------------------------------------------------------
# Hamming (10,6,3) — LC/ES hexbit protection
# g(x) = x^4 + x^3 + 1
# ---------------------------------------------------------------------------

_HAM10_G = 0x19


def hamming10_encode(info: np.ndarray) -> np.ndarray:
    d = _bits_to_int(info)
    parity = _poly_mod_bits(d << 4, _HAM10_G, 6)
    return np.concatenate([_int_to_bits(d, 6), _int_to_bits(parity, 4)])


def hamming10_decode(code: np.ndarray) -> tuple:
    cw = _bits_to_int(code)
    d = cw >> 4
    syn = _poly_mod_bits(d << 4, _HAM10_G, 6) ^ (cw & 0xF)
    if syn == 0:
        return _int_to_bits(d, 6), 0
    for i in range(10):
        e = 1 << i
        es = _poly_mod_bits((e >> 4) << 4, _HAM10_G, 6) ^ (e & 0xF)
        if es == syn:
            fixed = cw ^ e
            return _int_to_bits(fixed >> 4, 6), 1
    return _int_to_bits(d, 6), -1


# ---------------------------------------------------------------------------
# GF(64) arithmetic + shortened Reed-Solomon (24,12) / (24,16)
# primitive polynomial x^6 + x + 1 (0x43)
# ---------------------------------------------------------------------------

_GF_EXP = np.zeros(128, np.int32)
_GF_LOG = np.zeros(64, np.int32)


def _init_gf64():
    x = 1
    for i in range(63):
        _GF_EXP[i] = x
        _GF_LOG[x] = i
        x <<= 1
        if x & 0x40:
            x ^= 0x43
    for i in range(63, 128):
        _GF_EXP[i] = _GF_EXP[i - 63]


_init_gf64()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[(_GF_LOG[a] + _GF_LOG[b]) % 63])


def gf_inv(a: int) -> int:
    return int(_GF_EXP[(63 - _GF_LOG[a]) % 63])


def _rs_generator(nroots: int) -> list:
    """g(x) = prod (x - alpha^i), i = 1..nroots; returned low->high."""
    g = [1]
    for i in range(1, nroots + 1):
        root = int(_GF_EXP[i])
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= gf_mul(c, root)
            ng[j + 1] ^= c
        g = ng
    return g


def rs_encode(hexbits: np.ndarray, nparity: int) -> np.ndarray:
    """Systematic RS over GF(64): k data hexbits -> k + nparity.

    (24,12) uses nparity=12, (24,16) uses nparity=8 — both shortened
    from (63, 63-nparity)."""
    g = _rs_generator(nparity)
    data = [int(h) for h in hexbits]
    rem = [0] * nparity
    for d in data:
        coef = d ^ rem[-1]
        rem = [0] + rem[:-1]
        if coef:
            for j in range(nparity):
                rem[j] ^= gf_mul(coef, g[j])
    parity = rem[::-1]
    return np.array(data + parity, np.uint8)


def _rs_syndromes(code: list, nparity: int) -> list:
    out = []
    for i in range(1, nparity + 1):
        x = int(_GF_EXP[i])
        acc = 0
        for c in code:
            acc = gf_mul(acc, x) ^ int(c)
        out.append(acc)
    return out


def _gf_solve(a: list, b: list):
    """Solve A x = b over GF(64) by Gaussian elimination; None if
    singular. A is a list of rows."""
    n = len(b)
    m = [row[:] + [bv] for row, bv in zip(a, b)]
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col]), None)
        if piv is None:
            return None
        m[col], m[piv] = m[piv], m[col]
        inv = gf_inv(m[col][col])
        m[col] = [gf_mul(v, inv) for v in m[col]]
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [v ^ gf_mul(f, w) for v, w in zip(m[r], m[col])]
    return [m[r][n] for r in range(n)]


def rs_decode(code: np.ndarray, nparity: int) -> tuple:
    """Peterson-Gorenstein-Zierler decode (exact for t <= nparity/2).

    Returns (data, n_corrected); n_corrected = -1 if uncorrectable
    (data returned as received). PGZ solves the locator as a linear
    system — at t <= 6 this is a handful of GF(64) eliminations, and
    sidesteps the index bookkeeping of Berlekamp-Massey.
    """
    n = len(code)
    k = n - nparity
    code = [int(c) for c in code]
    syn = _rs_syndromes(code, nparity)
    if not any(syn):
        return np.array(code[:k], np.uint8), 0
    t_max = nparity // 2
    for v in range(t_max, 0, -1):
        # [S_{i+j}]_{i,j=0..v-1} * [l_v..l_1]^T = [S_{v}..S_{2v-1}]
        a = [[syn[i + j] for j in range(v)] for i in range(v)]
        b = [syn[v + i] for i in range(v)]
        sol = _gf_solve(a, b)
        if sol is None:
            continue
        # sigma(x) = 1 + l_1 x + ... + l_v x^v, sol = [l_v, ..., l_1]
        lam = [1] + sol[::-1]
        # Chien over the shortened positions: error at p (from left)
        # has locator X_p = alpha^{n-1-p}; p is an error iff
        # sigma(X_p^{-1}) == 0
        err_pos = []
        for p in range(n):
            xinv_log = (63 - (n - 1 - p)) % 63
            acc = 0
            for j, c in enumerate(lam):
                if c:
                    acc ^= int(_GF_EXP[(_GF_LOG[c] + xinv_log * j) % 63])
            if acc == 0:
                err_pos.append(p)
        if len(err_pos) != v:
            continue
        # magnitudes from the syndrome Vandermonde system:
        # sum_k e_k X_k^j = S_j, j = 1..v
        xs = [(n - 1 - p) % 63 for p in err_pos]  # log X_k
        a2 = [[int(_GF_EXP[(x * j) % 63]) for x in xs]
              for j in range(1, v + 1)]
        b2 = [syn[j - 1] for j in range(1, v + 1)]
        mags = _gf_solve(a2, b2)
        if mags is None or any(m == 0 for m in mags):
            continue
        fixed = code[:]
        for p, m in zip(err_pos, mags):
            fixed[p] ^= m
        if not any(_rs_syndromes(fixed, nparity)):
            return np.array(fixed[:k], np.uint8), v
    return np.array(code[:k], np.uint8), -1


# ---------------------------------------------------------------------------
# (16,8) shortened cyclic code for the low-speed data word
# g(x) = x^8 + x^5 + x^4 + x^3 + 1 (0x139, the standard LSD generator)
# ---------------------------------------------------------------------------

_LSD_G = 0x139


def lsd16_encode(info: np.ndarray) -> np.ndarray:
    d = _bits_to_int(info)
    parity = _poly_mod_bits(d << 8, _LSD_G, 8)
    return np.concatenate([_int_to_bits(d, 8), _int_to_bits(parity, 8)])


def lsd16_check(code: np.ndarray) -> bool:
    cw = _bits_to_int(code)
    return _poly_mod_bits((cw >> 8) << 8, _LSD_G, 8) == (cw & 0xFF)


# ---------------------------------------------------------------------------
# (63,16,23) BCH — the NID (NAC + DUID) protection
#
# Derived from first principles rather than a quoted constant: the
# narrow-sense binary BCH code of length 63 and designed distance 23
# (t=11) over GF(2^6) with the same primitive polynomial x^6+x+1 the
# RS section uses. g(x) = lcm of the minimal polynomials of
# alpha^1..alpha^22; degree 47. The on-air NID is this codeword plus a
# trailing 64th bit (transmitted 0 here, ignored on receive).
# ---------------------------------------------------------------------------


def _bch_nid_generator() -> int:
    """Compute the (63,16) BCH generator polynomial (bit i = x^i)."""
    covered = set()
    g = 1
    for b in range(1, 23):
        if b in covered:
            continue
        coset = []
        e = b
        while e not in coset:
            coset.append(e)
            e = (2 * e) % 63
        covered.update(coset)
        # minimal polynomial of alpha^b: prod (x + alpha^e) over the coset
        m = [1]
        for e in coset:
            root = int(_GF_EXP[e % 63])
            nm = [0] * (len(m) + 1)
            for j, c in enumerate(m):
                nm[j + 1] ^= c
                nm[j] ^= gf_mul(c, root)
            m = nm
        mi = 0
        for j, c in enumerate(m):
            assert c in (0, 1), "minimal polynomial must be binary"
            mi |= c << j
        ng = 0
        t, sh = mi, 0
        while t:
            if t & 1:
                ng ^= g << sh
            t >>= 1
            sh += 1
        g = ng
    assert g.bit_length() - 1 == 47
    return g


_BCH_NID_G = _bch_nid_generator()


def bch_6416_encode(info16: np.ndarray) -> np.ndarray:
    """16 NID info bits (NAC12 | DUID4) -> 64-bit on-air NID:
    systematic [info16 | parity47 | 0]."""
    d = _bits_to_int(info16)
    parity = _poly_mod_bits(d << 47, _BCH_NID_G, 16)
    return np.concatenate([_int_to_bits(d, 16), _int_to_bits(parity, 47),
                           np.zeros(1, np.uint8)])


def bch_6416_check(code64: np.ndarray) -> bool:
    """True when the first 63 bits form a valid (63,16) BCH codeword
    (the trailing 64th bit is not checked)."""
    cw = _bits_to_int(np.asarray(code64, np.uint8)[:63])
    return _poly_mod_bits((cw >> 47) << 47, _BCH_NID_G, 16) \
        == (cw & ((1 << 47) - 1))
