"""Closed-loop FEC parameter search, auto_fec (port of
``grbaz_tpu/models/auto_fec.py``).

Received QPSK-ish symbols have an unknown constellation rotation,
conjugation, code-bit pair order and pair alignment; a host controller
steps through the transform space while watching a decision-directed BER
(re-encode the decoded bits, compare with the hard slice) and locks when
it drops below a threshold. The transform, the Viterbi decoder (the
kernel ``csrc/viterbi.cu`` on the card) and the BER are one function of
the transform's values, so the controller retunes without rebuilding
anything; the controller reads the BER back once a block.
:class:`AutoFECBlock` is the same search as a streaming Block on the
served path: the search state stays on the card, and each block's BER
sets the next block's transform with no host read.

Search order as ``auto_fec_xform.next``: rotation (x4) -> conjugation
(x2) -> viterbi_delay (x2) -> viterbi_swap (x2); :class:`FECSearch` is the
search's one definition.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core import trace
from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.cuda.auto_fec import fec_ber, fec_pairs, fec_search
from grbaz_tpu_torch.ops.fec import ViterbiDecoder, _parity, expected_outputs

_ROTATIONS = np.array([1.0, 1.0j, -1.0, -1.0j], np.complex64)


def reencode(bits: torch.Tensor, k: int, polys) -> torch.Tensor:
    """The rate-1/2 encoder over decoded ``bits`` [N] from the zero state:
    [N, 2] int64 code bits. The encoder's register at step i holds bits
    i - k + 1 .. i (the newest at its MSB), so each output is the parity
    of a window of k bits against a polynomial."""
    b = bits.to(torch.int64)
    padded = torch.cat([torch.zeros(k - 1, dtype=torch.int64,
                                    device=b.device), b])
    windows = padded.unfold(0, k, 1)                 # [N, k], oldest first
    reg = (windows << torch.arange(k, device=b.device)).sum(1)
    return torch.stack([_parity(reg & int(p)) for p in polys], 1)


def fec_eval(symbols: torch.Tensor, rotation: int, conjugate: bool,
             vit_delay: bool, vit_swap: bool, k: int = 7,
             polys=(0o171, 0o133)):
    """Apply the transform, decode, and estimate the BER.

    ``symbols``: [N] complex64 QPSK symbols carrying (bit0, bit1) in the
    signs of (real, imag). Returns (bits [N] uint8, ber 0-d float32 on
    the symbols' device): the decoded bits, and the share of the hard
    slice's code bits that the re-encoded bits contradict, over all but
    the last 16 pairs (their traceback is shallow). The share is the count
    times the float32 reciprocal of the pairs' code bits, as XLA compiles
    the JAX package's jitted division by that constant."""
    from grbaz_tpu_torch.ops.cuda.viterbi import viterbi
    dev = symbols.device
    s = torch.conj(symbols) if conjugate else symbols
    s = s * torch.tensor(_ROTATIONS[int(rotation)], device=dev)
    # symbol -> soft code-bit pair
    soft = torch.stack([s.real, s.imag], 1)          # [N, 2]
    if vit_swap:
        soft = soft.flip(1)
    if vit_delay:   # realign the pair boundary by one code bit
        flat = soft.reshape(-1)
        soft = torch.cat([flat[1:], flat[:1]]).reshape(-1, 2)
    exp = torch.from_numpy(expected_outputs(k, polys)).to(dev)
    bits = viterbi(soft.contiguous(), exp)[0]
    hard = (soft > 0).to(torch.int64)
    n_eval = bits.shape[0] - 16
    errs = (reencode(bits, k, polys)[:n_eval] - hard[:n_eval]).abs().sum()
    ber = errs.to(torch.float32) * float(np.float32(1) /
                                         np.float32(2 * n_eval))
    return bits, ber


# transform index t, AutoFEC's odometer: bits 0-1 the rotation, bit 2 the
# conjugation, bit 3 the pair delay, bit 4 the swap
N_TRANSFORMS = 32


def transform_fields(t: int):
    """(rotation, conjugate, vit_delay, vit_swap) of transform ``t``."""
    return t & 3, bool(t & 4), bool(t & 8), bool(t & 16)


class FECSearch:
    """The search over the 32 transforms, one function of (state, BER)
    that :class:`AutoFEC` (on the host) and :class:`AutoFECBlock` (on the
    card) both call.

    The state is one int32: bits 0-4 the transform index, bit 5 the lock
    flag, bits 6 and up the settle count (blocks in a row below the
    threshold). The rule (:meth:`rule`), the reference controller's:
    searching, a BER below ``threshold`` adds one to the count and locks
    when it reaches ``settle``, any other zeroes the count and steps the
    transform (rotation fastest, then conjugation, pair delay, swap);
    locked, a BER above ``4 threshold + 0.2`` unlocks and zeroes the
    count, the transform kept.

    The BER, a float32, is compared in float64 with the two levels as
    Python floats, as the controller compares ``float(ber)`` (a NaN is
    neither below nor above). :meth:`step` reads the next state from a
    table of the rule, indexed by the state and the two comparisons: no
    branch and no host read."""

    def __init__(self, threshold: float = 0.05, settle: int = 2,
                 device="cpu"):
        self.threshold = float(threshold)
        self.unlock = 4 * self.threshold + 0.2
        self.settle = int(settle)
        if not 0 <= self.settle < 1 << 10:  # the table holds every count
            raise ValueError(f"settle must lie in [0, 1024), not {settle}")
        self.max_good = max(self.settle, 1)
        self.n_states = (self.max_good + 1) << 6
        rows = [self.pack(*self.rule(*self.unpack(s), low, high))
                for s in range(self.n_states)
                for high in (False, True) for low in (False, True)]
        self.table = torch.tensor(rows, dtype=torch.int32,
                                  device=resolve_device(device))

    @staticmethod
    def pack(t: int, locked: bool, good: int) -> int:
        return t | int(locked) << 5 | good << 6

    @staticmethod
    def unpack(s: int):
        """(transform, locked, settle count) of state ``s``."""
        return s & 31, bool(s >> 5 & 1), s >> 6

    def rule(self, t: int, locked: bool, good: int, low: bool, high: bool):
        """The next (transform, locked, count) after a block whose BER was
        below the threshold (``low``) or above the unlock level
        (``high``)."""
        if not locked:
            if low:
                good = min(good + 1, self.max_good)
                return t, good >= self.settle, good
            return (t + 1) % N_TRANSFORMS, False, 0
        if high:
            return t, False, 0
        return t, True, good

    def step(self, state: torch.Tensor, ber: torch.Tensor) -> torch.Tensor:
        """The state [1] int32 after a block of BER ``ber`` (one float32),
        both on the table's device: one launch on the card
        (``csrc/auto_fec.cu``), :func:`~grbaz_tpu_torch.ops.fec.
        fec_search_plain` on the CPU."""
        return fec_search(self.table, state, ber, self.threshold, self.unlock)


class AutoFEC:
    """Host controller over :func:`fec_eval`.

    Feed symbol blocks with :meth:`feed`; the controller steps the
    transform space (the reference's order) until the BER stays below
    ``threshold`` for ``settle`` consecutive blocks, then locks, and
    unlocks when it rises above ``4 * threshold + 0.2``
    (:class:`FECSearch`, run on the host). Outputs decoded bits and (ber,
    locked) per block."""

    def __init__(self, threshold: float = 0.05, settle: int = 2,
                 k: int = 7, polys=(0o171, 0o133), device="cuda"):
        self.device = resolve_device(device)
        self.search = FECSearch(threshold, settle)
        self.threshold = self.search.threshold
        self.settle = self.search.settle
        self.k = int(k)
        self.polys = tuple(polys)
        self.state = 0  # FECSearch's state: transform 0, searching
        self.last_ber = 1.0
        self.steps = 0

    @property
    def transform(self) -> int:
        return FECSearch.unpack(self.state)[0]

    @property
    def rotation(self) -> int:
        return transform_fields(self.transform)[0]

    @property
    def conjugate(self) -> bool:
        return transform_fields(self.transform)[1]

    @property
    def vit_delay(self) -> bool:
        return transform_fields(self.transform)[2]

    @property
    def vit_swap(self) -> bool:
        return transform_fields(self.transform)[3]

    @property
    def locked(self) -> bool:
        return FECSearch.unpack(self.state)[1]

    def feed(self, symbols):
        """Process one block of symbols (numpy or a tensor): returns (bits
        [N] uint8 on the controller's device, ber, locked)."""
        sym = torch.as_tensor(symbols).to(self.device, torch.complex64)
        bits, ber = fec_eval(sym, *transform_fields(self.transform), self.k,
                             self.polys)
        ber = ber.cpu()
        t = self.transform
        self.state = int(self.search.step(
            torch.tensor([self.state], dtype=torch.int32), ber))
        self.steps += self.transform != t
        self.last_ber = float(ber)
        return bits, self.last_ber, self.locked


class AutoFECBlock(Block):
    """auto_fec on the served path: :class:`AutoFEC`'s transform, decode,
    BER and search as one streaming Block, the search state on the card.

    The input is complex64 QPSK symbols, one a sample, the code bits in
    the signs of (real, imag); blocks are taken whole. A block emits:

    * ``pm``: the decode's final path metrics, [2^(K-1)] float32;
    * ``bits``: N uint8, one a symbol;
    * ``ber``: [1] float32, the share of the block's hard-sliced code bits,
      all but the last 16 pairs, that the re-encoded bits contradict: the
      count times the float32 reciprocal, as :func:`fec_eval`;
    * ``state``: [1] int32, the :class:`FECSearch` state after the block.
      Block j's BER sets block j+1's transform.

    On a stream. The state carries the last ``overlap + 1`` raw symbols,
    and block j's soft pairs are the current transform applied to [carry,
    block], so a retune re-transforms the carried tail. A symbol gives the
    pair (real, imag) after the conjugation and rotation, swapped with the
    swap. The pair delay moves the pairing back by one code bit: pair i
    is the second code bit of symbol i - 1 and the first of symbol i, so
    the pairs of block j depend on the symbols up to its end alone
    (:func:`fec_eval`, which holds one block, takes the next symbol's
    first bit instead and wraps round the block's end). The last ``overlap
    + N`` pairs are decoded from state 0, the first ``overlap`` the
    warm-up (:class:`~grbaz_tpu_torch.ops.fec.ViterbiDecoder`'s), and the
    block's N bits emitted. The BER re-encodes the decoded bits from the
    warm-up's on, so the encoder's register at the block's start holds
    the bits before it.

    On the card the transform, the BER and the search are one launch each
    (``csrc/auto_fec.cu``, ``ops/cuda/auto_fec.py``) beside the decoder's;
    on the CPU their plain twins (``ops/fec.py``) run, bit-equal.

    While tracing records, ``fec.transform``, ``fec.decode`` (``n``: the
    pairs decoded, the warm-up's included), ``fec.check`` (the
    re-encoding and the BER) and ``fec.search`` nest in the graph's
    ``block.<name>``; none reads the card."""

    n_in, n_out = 1, 4

    def __init__(self, threshold: float = 0.05, settle: int = 2, k: int = 7,
                 polys=(0o171, 0o133), overlap: int = 96, name=None,
                 device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.k, self.polys, self.overlap = int(k), tuple(polys), int(overlap)
        if self.overlap < self.k - 1:
            raise ValueError(f"overlap {overlap} holds less than the "
                             f"encoder's {self.k - 1} bits of history")
        self.decoder = ViterbiDecoder(self.k, self.polys, self.overlap,
                                      device=self.device)
        self.search = FECSearch(threshold, settle, self.device)
        # each transform as a pick from the window (re, im) of symbols
        # m - 1 and m, and signs: the soft pair of symbol m, read by the
        # state's transform, state & 31 (ops/fec.py fec_pairs_plain)
        pick, sign = [], []
        for t in range(N_TRANSFORMS):
            rot, conj, vit_delay, vit_swap = transform_fields(t)
            pair = [(0, 1.0), (1, -1.0 if conj else 1.0)]
            for _ in range(rot):  # times 1j: (x, y) -> (-y, x)
                pair = [(pair[1][0], -pair[1][1]), pair[0]]
            if vit_swap:
                pair = pair[::-1]
            # delayed: symbol m-1's second code bit, then symbol m's first
            pair = [pair[1], (2 + pair[0][0], pair[0][1])] if vit_delay \
                else [(2 + c, g) for c, g in pair]
            pick.append([c for c, _ in pair])
            sign.append([g for _, g in pair])
        dev = self.device
        self._pick = torch.tensor(pick, dtype=torch.int64, device=dev)
        self._sign = torch.tensor(sign, dtype=torch.float32, device=dev)
        self._n_pm = scalar(1 << (self.k - 1), torch.int32, dev)
        self._one = scalar(1, torch.int32, dev)

    def init_state(self):
        return dict(carry=torch.zeros(self.overlap + 1, dtype=torch.complex64,
                                      device=self.device),
                    search=torch.zeros(1, dtype=torch.int32,
                                       device=self.device))

    def apply(self, state, params, x: Stream):
        traced = trace.on()
        ov, s = self.overlap, state["search"]
        span = trace.begin("fec.transform") if traced else None
        data = x.data.to(torch.complex64).contiguous()
        ext = fec_pairs(state["carry"], data, s, self._pick, self._sign)
        if traced:
            trace.end(span)
            span = trace.begin("fec.decode")
        bits, pm = self.decoder.decode(ext)
        if traced:
            trace.end(span, ext.shape[0])
            span = trace.begin("fec.check")
        ber = fec_ber(bits, ext, ov, self.k, self.polys)
        if traced:
            trace.end(span)
            span = trace.begin("fec.search")
        s_next = self.search.step(s, ber)
        if traced:
            trace.end(span)
        carry = data[-(ov + 1):] if data.shape[0] > ov else \
            torch.cat([state["carry"], data])[-(ov + 1):]
        return dict(carry=carry, search=s_next), (
            Stream(pm, self._n_pm, x.meta), x.like(bits[ov:], count=x.count),
            Stream(ber, self._one, x.meta), Stream(s_next, self._one, x.meta))
