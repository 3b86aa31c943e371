"""FEC blocks: LFSR scrambling, puncturing, BER estimation, Viterbi,
the GLFSR source (port of ``grbaz_tpu/ops/fec.py``).

* :class:`AdditiveScrambler` XORs against a host-precomputed LFSR
  pattern; :class:`Puncture` / :class:`Depuncture` are cumsum
  compactions and gathers, as in the JAX package.
* :func:`viterbi_decode` (soft-decision, rate 1/2, 2^(K-1) states) runs
  on the CUDA kernel ``csrc/viterbi.cu`` on the card and on
  :func:`viterbi_plain`, a torch loop over time of the vectorised
  add-compare-select, on the CPU; both are bit-equal to the JAX scan,
  path metrics included.
* :class:`PNBERv`, which the JAX package walks as a per-sample scan, is
  block-parallel: its register before each step is a window of the last
  ``degree`` received bits, its error flags are elementwise, and its
  running BER is the one-pole recurrence ``iir.onepole_scan``.
* :class:`GLFSRSource`, also a scan there, is linear over GF(2): output
  bit i is the parity of ``row_i & reg0`` and the next register is
  ``A^block_size reg0``, with the rows and ``A^block_size`` computed once
  on the host; bit-equal by construction.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream, StreamMeta
from grbaz_tpu_torch.ops.decode import _compact
from grbaz_tpu_torch.ops.iir import onepole_scan


# ---------------------------------------------------------------------------
# LFSR utilities (host side, exact integer math)
# ---------------------------------------------------------------------------

def lfsr_bits(mask: int, seed: int, reg_len: int, n: int) -> np.ndarray:
    """Galois-style LFSR bit stream (GR lfsr convention:
    out = reg & 1; newbit = popcount(reg & mask) % 2;
    reg = (reg >> 1) | (newbit << (reg_len - 1)))."""
    reg = int(seed)
    out = np.empty(n, np.uint8)
    for i in range(n):
        out[i] = reg & 1
        newbit = bin(reg & mask).count("1") % 2
        reg = (reg >> 1) | (newbit << (reg_len - 1))
    return out


def _parity(v: torch.Tensor) -> torch.Tensor:
    """Parity of each uint32 value (int64-held): the XOR fold."""
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


class AdditiveScrambler(Block):
    """Additive (synchronous) scrambler (baz_additive_scrambler_bb): XOR
    each byte with ``bits_per_byte`` LFSR bits, the LFSR reset every
    ``count`` bytes (0 = never). The pattern is precomputed on the host;
    descrambling is the same block."""

    MAX_PRECOMPUTE = 1 << 22  # bits

    def __init__(self, mask: int = 0x8A, seed: int = 0x7F, reg_len: int = 7,
                 count: int = 0, bits_per_byte: int = 1, name=None,
                 device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.count = int(count)
        bpb = int(bits_per_byte)
        if count > 0:
            nbits = count * bpb
        else:
            # without resets the byte pattern repeats after at most
            # `period` bytes (bit period 2^reg_len - 1)
            nbits = ((1 << reg_len) - 1) * bpb
        if nbits > self.MAX_PRECOMPUTE:
            raise NotImplementedError(
                "LFSR period too long to precompute; use a shorter register")
        bits = lfsr_bits(mask, seed, reg_len, nbits)
        weights = (1 << np.arange(bpb)).astype(np.uint8)
        self.pattern = (bits.reshape(-1, bpb) * weights).sum(1) \
            .astype(np.uint8)
        self.period = len(self.pattern)  # bytes until repeat/reset
        self._pattern = torch.from_numpy(self.pattern).to(self.device)

    def init_state(self):
        return dict(offset=scalar(0, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        idx = (state["offset"] + torch.arange(n, dtype=torch.int32,
                                              device=x.data.device)) \
            % self.period
        y = x.data.to(torch.uint8) ^ self._pattern[idx.long()]
        new_off = (state["offset"] + x.count) % self.period
        return dict(offset=new_off), (x.like(y, count=x.count),)


# ---------------------------------------------------------------------------
# puncturing (baz_puncture_bb / baz_depuncture_ff)
# ---------------------------------------------------------------------------

class Puncture(Block):
    """Drop the samples where the puncture matrix is 0 (the matrix is a
    runtime param)."""

    def __init__(self, matrix: Sequence[int], name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.p = len(matrix)
        self.matrix0 = np.asarray(matrix, np.int32)

    def init_state(self):
        return dict(phase=scalar(0, torch.int32, self.device))

    def init_params(self):
        return dict(matrix=torch.from_numpy(self.matrix0).to(self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        idx = (state["phase"] + torch.arange(n, dtype=torch.int32,
                                             device=x.data.device)) % self.p
        keep = (params["matrix"][idx.long()] != 0) & x.valid_mask()
        out, count = _compact(x.data, keep)
        new_phase = (state["phase"] + x.count) % self.p
        return dict(phase=new_phase), (Stream(out, count, x.meta),)


class Depuncture(Block):
    """Insert erasures (``zero_value``) where the matrix is 0. The output
    is len(matrix) / sum(matrix) times the input rate (statically
    bounded)."""

    def __init__(self, matrix: Sequence[int], zero_value: float = 0.0,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.matrix0 = np.asarray(matrix, np.int32)
        self.p = len(matrix)
        self.k = int(self.matrix0.sum())
        self.zero = float(zero_value)

    def init_state(self):
        return dict(phase=scalar(0, torch.int32, self.device))

    def init_params(self):
        return dict(matrix=torch.from_numpy(self.matrix0).to(self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        dev = x.data.device
        cap = int(np.ceil(n * self.p / self.k)) + self.p
        slots = torch.arange(cap, dtype=torch.int32, device=dev)
        opos = (state["phase"] + slots) % self.p
        is_data = params["matrix"][opos.long()] != 0
        src = torch.cumsum(is_data.to(torch.int32), 0) - 1  # input per slot
        valid = src < x.count
        gathered = x.data[src.clamp(0, n - 1).long()]
        zero = torch.zeros((), dtype=x.data.dtype, device=dev) + self.zero
        out = torch.where(is_data & valid, gathered, zero)
        # stop at the last slot whose data source exists
        count = (is_data & valid).sum(dtype=torch.int32) \
            + (~is_data & valid).sum(dtype=torch.int32)
        new_phase = (state["phase"] + count) % self.p
        out = torch.where(slots < count, out, torch.zeros_like(out))
        return dict(phase=new_phase), (Stream(out, count, x.meta),)


# ---------------------------------------------------------------------------
# BER estimator vs PN reference
# ---------------------------------------------------------------------------

class PNBERv(Block):
    """Self-synchronizing BER tester against an LFSR PN sequence.

    The register is fed with the *received* bits, so it re-syncs within
    ``degree`` bits of a slip; each error then shows ~weight(mask) + 1
    times. Outputs a running BER (EWMA) per sample.

    Block-parallel form of the JAX package's scan: the register before
    sample i holds the ``degree`` bits before it (the carried register's
    bits, then the block's), so the prediction is an XOR of shifted slices;
    the BER is the one-pole ``(1 - alpha) * ber + alpha * err`` from the
    first sample with ``warm >= degree``, held at its carried value
    before it. Bits, register and warm count are exact; the BER agrees
    with the serial recurrence to float32 rounding."""

    def __init__(self, degree: int = 7, mask: int = 0x60, alpha: float = 1e-3,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.degree = int(degree)
        self.mask = int(mask)
        self.alpha = float(alpha)

    def init_state(self):
        d = self.device
        return dict(reg=scalar(0, torch.int64, d),
                    warm=scalar(0, torch.int32, d),
                    ber=scalar(0.0, torch.float32, d))

    def apply(self, state, params, x: Stream):
        deg = self.degree
        n = x.data.shape[0]
        dev = x.data.device
        b = (x.data != 0).to(torch.int64)
        shifts = torch.arange(deg - 1, -1, -1, device=dev)
        hist = torch.cat([(state["reg"] >> shifts) & 1, b])  # oldest first
        # register bit p before sample i is hist[i + deg - 1 - p]
        pred = torch.zeros(n, dtype=torch.int64, device=dev)
        for p in range(deg):
            if (self.mask >> p) & 1:
                pred = pred ^ hist[deg - 1 - p:deg - 1 - p + n]
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        # samples before i0 are still warming up (warm counts every step)
        i0 = torch.clamp(deg - state["warm"].to(torch.int64), 0, n)
        a = np.float32(self.alpha)
        err = ((pred != b) & (idx >= i0)).to(torch.float32)
        # the recurrence from sample i0 on, moved to the front and back
        src = torch.clamp(idx + i0, max=n - 1)
        on = onepole_scan(err[src] * a, float(np.float32(1.0 - self.alpha)),
                          state["ber"])
        back = torch.clamp(idx - i0, min=0)
        ber = torch.where(idx >= i0, on[back], state["ber"])
        reg = (hist[n:] << shifts).sum()
        new = dict(reg=reg, warm=state["warm"] + n, ber=ber[-1])
        return new, (x.like(ber, count=x.count),)


# ---------------------------------------------------------------------------
# Viterbi decoder (rate 1/2, constraint length K)
# ---------------------------------------------------------------------------

def _build_trellis(k: int, polys):
    """Precompute (prev_states[ns,2], prev_bits, branch_out[ns,2,2])."""
    ns = 1 << (k - 1)
    next_state = np.zeros((ns, 2), np.int32)
    outs = np.zeros((ns, 2, 2), np.int8)
    for s in range(ns):
        for b in (0, 1):
            reg = (b << (k - 1)) | s          # newest bit at MSB
            next_state[s, b] = reg >> 1
            for j, p in enumerate(polys):
                outs[s, b, j] = bin(reg & p).count("1") % 2
    # invert: predecessors of each state
    prev = np.zeros((ns, 2), np.int32)
    prev_bit = np.zeros((ns, 2), np.int32)
    prev_out = np.zeros((ns, 2, 2), np.int8)
    fill = np.zeros(ns, np.int32)
    for s in range(ns):
        for b in (0, 1):
            t = next_state[s, b]
            prev[t, fill[t]] = s
            prev_bit[t, fill[t]] = b
            prev_out[t, fill[t]] = outs[s, b]
            fill[t] += 1
    assert (fill == 2).all()
    return prev, prev_bit, prev_out


def expected_outputs(k: int, polys) -> np.ndarray:
    """[ns, 2, 2] float32 +-1: the coded pair each (state, predecessor)
    branch expects, the trellis the decoders take as an argument."""
    return _build_trellis(k, polys)[2].astype(np.float32) * 2.0 - 1.0


def conv_encode(bits: np.ndarray, k: int = 7,
                polys=(0o171, 0o133)) -> np.ndarray:
    """Host-side rate-1/2 convolutional encoder matching viterbi_decode's
    trellis convention (newest bit at the register MSB). Returns [T, 2]."""
    s = 0
    out = np.zeros((len(bits), 2), np.int8)
    for i, b in enumerate(np.asarray(bits).astype(int)):
        reg = (b << (k - 1)) | s
        for j, p in enumerate(polys):
            out[i, j] = bin(reg & p).count("1") % 2
        s = reg >> 1
    return out


def viterbi_plain(metrics: torch.Tensor, exp: torch.Tensor):
    """Soft-decision Viterbi over ``metrics`` [T, 2] float32 with the
    trellis ``exp`` [ns, 2, 2] (:func:`expected_outputs`). Returns (bits
    [T] uint8, final path metrics [ns] float32) on ``metrics``'s device.

    The JAX scan's arithmetic on the CPU: branch metrics ``e0*r0 + e1*r1``
    (exact products, one rounding), candidates ``pm[pred] + bm``, the
    second predecessor only where strictly greater (``argmax`` takes the
    first of equal maxima), every step normalised by its max; traceback
    from the first best final state. State t's predecessors are
    ``2t mod ns`` and ``2t + 1 mod ns``, and its bit is its MSB."""
    r = metrics.detach().to("cpu", torch.float32)
    e = exp.detach().to("cpu", torch.float32)
    ns = e.shape[0]
    t_len = r.shape[0]
    st = torch.arange(ns)
    prev = torch.stack([(2 * st) % ns, (2 * st + 1) % ns], 1).reshape(-1)
    bm = (e[None, :, :, 0] * r[:, None, None, 0]
          + e[None, :, :, 1] * r[:, None, None, 1])          # [T, ns, 2]
    pm = torch.full((ns,), -1e9, dtype=torch.float32)
    pm[0] = 0.0
    choices = torch.empty(t_len, ns, dtype=torch.bool)
    for t in range(t_len):
        cand = pm[prev].reshape(ns, 2) + bm[t]
        c = cand[:, 1] > cand[:, 0]
        new = torch.where(c, cand[:, 1], cand[:, 0])
        pm = new - new.max()
        choices[t] = c
    ch = choices.numpy()
    bits = np.zeros(t_len, np.uint8)
    s = int(torch.argmax(pm)) if t_len else 0
    half, msb = ns // 2, ns.bit_length() - 2
    for t in range(t_len - 1, -1, -1):
        bits[t] = s >> msb
        s = 2 * (s % half) + int(ch[t, s])
    return torch.from_numpy(bits).to(metrics.device), pm.to(metrics.device)


def viterbi_decode(metrics: torch.Tensor, k: int = 7,
                   polys=(0o171, 0o133)) -> torch.Tensor:
    """Soft-decision Viterbi, rate 1/2: ``metrics`` [T, 2] float (positive
    ~ coded bit 1) -> [T] decoded bits (uint8). The kernel for metrics on
    the card, :func:`viterbi_plain` on the CPU."""
    from grbaz_tpu_torch.ops.cuda.viterbi import viterbi
    exp = torch.from_numpy(expected_outputs(k, polys)).to(metrics.device)
    return viterbi(metrics.to(torch.float32), exp)[0]


class ViterbiDecoder(Block):
    """Streaming Viterbi with block-overlap state continuation: each
    block is decoded with the last ``overlap`` soft pairs of the stream in
    front of it (the traceback's warm-up) and the whole padded block
    decoded, as in the JAX package, so its output matches the JAX block
    block by block. With ``overlap=0`` the reference's slices
    ``bits[0:]`` and ``ext[-0:]`` carry the whole extended block: the
    tail grows by a block every step, and the n-th block emits n blocks'
    bits. The port does the same."""

    def __init__(self, k: int = 7, polys=(0o171, 0o133), overlap: int = 96,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.k = int(k)
        self.polys = tuple(polys)
        self.overlap = int(overlap)
        self._exp = torch.from_numpy(expected_outputs(self.k, self.polys)) \
            .to(self.device)

    def init_state(self):
        return dict(tail=torch.zeros(self.overlap, 2, dtype=torch.float32,
                                     device=self.device),
                    warm=scalar(0, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        from grbaz_tpu_torch.ops.cuda.viterbi import viterbi
        # x.data: [N, 2] soft pairs
        ext = torch.cat([state["tail"], x.data.to(torch.float32)])
        bits = viterbi(ext, self._exp)[0]
        new_state = dict(tail=ext[-self.overlap:],
                         warm=torch.clamp(state["warm"] + 1, max=1000))
        return new_state, (x.like(bits[self.overlap:], count=x.count),)


# ---------------------------------------------------------------------------
# GLFSR source
# ---------------------------------------------------------------------------

def _apply_cols(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The GF(2) map with columns ``cols`` [32] (uint32 images of the unit
    vectors) applied to each uint32 of ``v``."""
    out = np.zeros_like(v)
    for j in range(32):
        out ^= np.where((v >> np.uint64(j)) & 1, cols[j], 0).astype(v.dtype)
    return out


def _row_times(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Row vectors ``rows`` (uint32 each) times the matrix with columns
    ``cols``: bit j of each result is the parity of ``row & cols[j]``."""
    out = np.zeros_like(rows)
    for j in range(32):
        v = rows & cols[j]
        for s in (16, 8, 4, 2, 1):
            v = v ^ (v >> np.uint64(s))
        out |= (v & 1) << np.uint64(j)
    return out


class GLFSRSource(Block):
    """GLFSR bit source (gr glfsr_source_b), the stimulus of the reference
    tutorial's BER flowgraph: ``block_size`` LFSR bits a step (uint8 0/1,
    or float32 +-1 with ``bipolar``). Conventions: 'gr' = right-shift
    Galois (the glfsr masks), 'pn' = left-shift Fibonacci with XOR-fold
    parity (the one :class:`PNBERv` self-syncs to).

    Both updates are linear maps A of the register over GF(2). Output bit
    i is bit 0 of ``A^i reg0`` ('gr') or the parity of ``mask & A^i reg0``
    ('pn'): the parity of ``row_i & reg0`` for host-precomputed rows
    (built by doubling: ``rows[m:2m] = rows[:m] A^m``). The next register
    is ``A^block_size reg0``, 32 rows more of the same product. A step is
    one masked AND, a parity fold and a sum on the device."""

    n_in = 0

    def __init__(self, degree: int, block_size: int, *, mask: int = 0,
                 seed: int = 1, bipolar: bool = False,
                 convention: str = "gr", name=None, device="cuda"):
        super().__init__(name)
        if not (1 <= degree <= 32):
            raise ValueError("degree must be in [1, 32]")
        if convention not in ("gr", "pn"):
            raise ValueError("convention must be 'gr' or 'pn'")
        self.device = resolve_device(device)
        self.degree = int(degree)
        self.mask = int(mask) if mask else _default_poly(self.degree)
        self.seed = int(seed) or 1
        self.block_size = int(block_size)
        self.bipolar = bool(bipolar)
        self.convention = convention
        rows, step = self._tables()
        # the output rows, then the rows of A^block_size (bit j of the new
        # register is the parity of its row j & reg)
        self._rows = torch.from_numpy(
            np.concatenate([rows, step]).astype(np.int64)).to(self.device)
        self._weights = (torch.ones(32, dtype=torch.int64) <<
                         torch.arange(32)).to(self.device)

    def _tables(self):
        u = np.uint64
        full = u((1 << 32) - 1)
        mask = u(self.mask & 0xFFFFFFFF)
        regmask = u((1 << self.degree) - 1)
        unit = (np.ones(32, np.uint64) << np.arange(32, dtype=np.uint64))
        if self.convention == "gr":
            cols = ((unit >> u(1)) ^ np.where(unit & u(1), mask, u(0))) & full
            row0 = u(1)
        else:
            par = np.array([bin(int(v) & int(mask)).count("1") & 1
                            for v in unit], np.uint64)
            cols = ((unit << u(1)) | par) & regmask
            row0 = mask
        rows = np.array([row0], np.uint64)
        power = cols                     # columns of A^len(rows)
        while len(rows) < self.block_size:
            rows = np.concatenate([rows, _row_times(rows, power)])
            power = _apply_cols(power, power)
        rows = rows[:self.block_size]
        # A^block_size by squaring
        result = unit.copy()             # identity
        base, e = cols, self.block_size
        while e:
            if e & 1:
                result = _apply_cols(base, result)
            base = _apply_cols(base, base)
            e >>= 1
        # row j of A^block_size: bit i is bit j of column i
        step = np.array([sum(((int(result[i]) >> j) & 1) << i
                             for i in range(32)) for j in range(32)],
                        np.uint64)
        return rows, step

    def init_state(self):
        return dict(reg=scalar(self.seed & U32_MASK, torch.int64, self.device))

    def apply(self, state, params):
        par = _parity(self._rows & state["reg"])
        bits = par[:self.block_size].to(torch.uint8)
        reg = (par[self.block_size:] * self._weights).sum()
        data = bits.to(torch.float32) * 2.0 - 1.0 if self.bipolar else bits
        out = Stream(data=data,
                     count=scalar(self.block_size, torch.int32, self.device),
                     meta=StreamMeta.start(1.0, device=self.device))
        return dict(reg=reg), (out,)


def _default_poly(degree: int) -> int:
    """Primitive polynomial masks by degree (GR glfsr table values for
    the common degrees; maximal-length sequences)."""
    table = {1: 0x1, 2: 0x3, 3: 0x5, 4: 0x9, 5: 0x12, 6: 0x21, 7: 0x41,
             8: 0x8E, 9: 0x108, 10: 0x204, 11: 0x402, 12: 0x829,
             13: 0x100D, 14: 0x2015, 15: 0x4001, 16: 0x8016,
             17: 0x10004, 18: 0x20013, 19: 0x40013, 20: 0x80004,
             21: 0x100002, 22: 0x200001, 23: 0x400010, 24: 0x80000D,
             25: 0x1000004, 26: 0x2000023, 27: 0x4000013, 28: 0x8000004,
             29: 0x10000002, 30: 0x20000029, 31: 0x40000004,
             32: 0x80000057}
    return table[degree]
