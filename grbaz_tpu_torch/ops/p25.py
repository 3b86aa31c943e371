"""APCO P25 Phase-1 frame synchronization and NID extraction (port of
``grbaz_tpu/ops/p25.py``).

:class:`P25FrameSync` consumes the dibit stream of
:class:`~grbaz_tpu_torch.ops.fsk4.FSK4Demod` and emits frame events
carrying the NID fields (NAC, DUID).

P25 CAI constants (public TIA-102 air interface):

* 48-bit frame sync word ``0x5575F5FF77FF`` = 24 dibits;
* NID: 64 bits after the FS — 12-bit NAC + 4-bit DUID protected by
  BCH(63,16) + 1 parity bit. The info bits lead (systematic code), so
  hard extraction reads NAC/DUID directly.

Detection is block-parallel: the dibit stream, after a carried 55-dibit
tail (so that a sync across a block boundary is found exactly once), is
viewed as 56-dibit sliding windows by one ``unfold``; the sync
correlation, the NID fields and the event compaction are tensor ops with
no read back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream, bits_to_f32
from grbaz_tpu_torch.ops.burst import _event_pack

FRAME_SYNC = 0x5575F5FF77FF  # 48-bit C4FM frame sync
FS_DIBITS = np.array([(FRAME_SYNC >> (46 - 2 * i)) & 0x3 for i in range(24)],
                     np.uint8)
NID_DIBITS = 32          # 64 NID bits
SPAN = 24 + NID_DIBITS   # dibits covered by one detection window

DUID_NAMES = {
    0x0: "HDU", 0x3: "TDU", 0x5: "LDU1", 0x7: "TSBK", 0xA: "LDU2",
    0xC: "PDU", 0xF: "TDU_LC",
}

# NAC = the first six NID dibits, most significant first
_NAC_WEIGHTS = [4 ** (5 - i) for i in range(6)]


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 ``v`` wrapped to int32, as the JAX package's int32 add."""
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


class P25FrameSync(Block):
    """dibits (uint8) -> frame events [sym_idx, nac, duid, fs_errors].

    ``max_errors`` dibit mismatches are tolerated in the 24-dibit sync
    correlation. ``sym_idx`` rides as the bit pattern of an int32 (decode
    with ``core.stream.decode_i32``); the counter is int32 and wraps
    after 2^31 dibits, as the JAX block's does.
    """

    MAX_EVENTS = 64

    def __init__(self, max_errors: int = 1, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.max_errors = int(max_errors)
        self.fs = torch.from_numpy(FS_DIBITS).to(self.device)
        self.nac_w = torch.tensor(_NAC_WEIGHTS, dtype=torch.int32,
                                  device=self.device)

    def init_state(self):
        return dict(tail=torch.zeros(SPAN - 1, dtype=torch.uint8,
                                     device=self.device),
                    tail_len=scalar(0, torch.int32, self.device),
                    global_sym=scalar(0, torch.int32, self.device))

    def init_params(self):
        return dict(max_errors=scalar(self.max_errors, torch.int32,
                                      self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        dev = x.data.device
        hist = SPAN - 1
        # valid data is a contiguous region ending at hist + count: the
        # tail's tail_len valid dibits are its suffix
        buf = torch.cat([state["tail"], x.data.to(torch.uint8)])
        windows = buf.unfold(0, SPAN, 1)                  # [n, SPAN] view
        p = torch.arange(n, dtype=torch.int32, device=dev)
        pos_valid = (p >= hist - state["tail_len"]) \
            & (p + SPAN <= hist + x.count)
        errors = (windows[:, :24] != self.fs).sum(dim=1, dtype=torch.int32)
        hit = (errors <= params["max_errors"]) & pos_valid

        nid = windows[:, 24:32].to(torch.int32)
        nac = (nid[:, :6] * self.nac_w).sum(dim=1, dtype=torch.int32)
        duid = nid[:, 6] * 4 + nid[:, 7]

        # buf[i] holds global dibit (global_sym - hist + i), mod 2^32
        sym_idx = state["global_sym"].to(torch.int64) - hist \
            + p.to(torch.int64)
        rows = torch.stack([bits_to_f32(sym_idx), nac.to(torch.float32),
                            duid.to(torch.float32),
                            errors.to(torch.float32)], dim=1)
        ev, n_ev = _event_pack(hit, rows, self.MAX_EVENTS)

        # carry: the hist buffer positions before the valid end
        start = torch.clamp(x.count, 0, n).to(torch.int64)
        tail = buf.index_select(0, start + torch.arange(hist, device=dev))
        tail_len = torch.clamp(state["tail_len"] + x.count,
                               max=hist).to(torch.int32)
        new_state = dict(tail=tail, tail_len=tail_len,
                         global_sym=_wrap_i32(state["global_sym"].to(
                             torch.int64) + x.count.to(torch.int64)))
        return new_state, (Stream(data=ev, count=n_ev, meta=x.meta),)


def make_frame(nac: int, duid: int, payload_dibits: int = 0,
               rng=None) -> np.ndarray:
    """Test helper: FS + NID (+ random payload) as a dibit array.

    The BCH parity region is filled with zeros (hard extraction only
    reads the systematic info bits).
    """
    bits = [(nac >> (11 - i)) & 1 for i in range(12)]
    bits += [(duid >> (3 - i)) & 1 for i in range(4)]
    bits += [0] * 48
    nid = np.array([bits[2 * i] * 2 + bits[2 * i + 1] for i in range(32)],
                   np.uint8)
    parts = [FS_DIBITS, nid]
    if payload_dibits:
        rng = rng or np.random.default_rng(0)
        parts.append(rng.integers(0, 4, payload_dibits).astype(np.uint8))
    return np.concatenate(parts)
