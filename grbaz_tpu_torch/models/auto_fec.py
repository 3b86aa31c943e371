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

Search order as ``auto_fec_xform.next``: rotation (x4) -> conjugation
(x2) -> viterbi_delay (x2) -> viterbi_swap (x2).
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.device import resolve_device
from grbaz_tpu_torch.ops.fec import _parity, expected_outputs

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


class AutoFEC:
    """Host controller over :func:`fec_eval`.

    Feed symbol blocks with :meth:`feed`; the controller steps the
    transform space (the reference's order) until the BER stays below
    ``threshold`` for ``settle`` consecutive blocks, then locks, and
    unlocks when it rises above ``4 * threshold + 0.2``. Outputs decoded
    bits and (ber, locked) per block."""

    def __init__(self, threshold: float = 0.05, settle: int = 2,
                 k: int = 7, polys=(0o171, 0o133), device="cuda"):
        self.device = resolve_device(device)
        self.threshold = float(threshold)
        self.settle = int(settle)
        self.k = int(k)
        self.polys = tuple(polys)
        # transform state
        self.rotation = 0
        self.conjugate = False
        self.vit_delay = False
        self.vit_swap = False
        self.locked = False
        self._good = 0
        self.last_ber = 1.0
        self.steps = 0

    def _advance(self):
        """Step the search space in the reference's order
        (rotation fastest, then conjugation, then delays)."""
        self.rotation = (self.rotation + 1) % 4
        if self.rotation != 0:
            return
        self.conjugate = not self.conjugate
        if self.conjugate:
            return
        self.vit_delay = not self.vit_delay
        if self.vit_delay:
            return
        self.vit_swap = not self.vit_swap

    def feed(self, symbols):
        """Process one block of symbols (numpy or a tensor): returns (bits
        [N] uint8 on the controller's device, ber, locked)."""
        sym = torch.as_tensor(symbols).to(self.device, torch.complex64)
        bits, ber = fec_eval(sym, self.rotation, self.conjugate,
                             self.vit_delay, self.vit_swap, self.k,
                             self.polys)
        ber = float(ber)
        self.last_ber = ber
        if not self.locked:
            if ber < self.threshold:
                self._good += 1
                if self._good >= self.settle:
                    self.locked = True
            else:
                self._good = 0
                self._advance()
                self.steps += 1
        elif ber > 4 * self.threshold + 0.2:
            # lost lock (the reference re-enters search on bad BER)
            self.locked = False
            self._good = 0
        return bits, ber, self.locked
