"""Sample-block stream datatypes (port of ``grbaz_tpu/core/stream.py``).

A *stream* is a fixed-shape tensor block plus explicit metadata:

* ``data``  — ``[N]`` or ``[N, vlen]`` tensor (complex64 / float32 ...);
* ``count`` — int32 0-d device tensor: number of *valid* leading samples
  (<= N). Rate-changing blocks write fewer than N samples; downstream
  blocks and the host executor mask on ``count``. It stays on the
  device, so no block reads it back to the host;
* ``meta``  — :class:`StreamMeta`: the absolute sample index as two
  uint32 limbs (int64 tensors masked to 32 bits, see ``core.device``),
  the time epoch and BorIP-compatible fault flags.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar


class stream_flags:
    """Stream fault/epoch flags, wire-compatible with the BorIP UDP
    header flag byte (hardware / network / buffer overruns, empty
    payload, stream start/end)."""

    NONE = 0x00
    HARDWARE_OVERRUN = 0x01
    NETWORK_OVERRUN = 0x02
    BUFFER_OVERRUN = 0x04
    EMPTY_PAYLOAD = 0x08
    STREAM_START = 0x10
    STREAM_END = 0x20


def limbs_add(lo: torch.Tensor, hi: torch.Tensor, delta: torch.Tensor):
    """Exact 64-bit add of a uint32 ``delta`` to a (lo, hi) limb pair.

    The low sum wraps mod 2^32, so a carry happened iff the wrapped sum
    is less than the addend.
    """
    delta = delta.to(torch.int64) & U32_MASK
    new_lo = (lo + delta) & U32_MASK
    carry = (new_lo < delta).to(torch.int64)
    return new_lo, (hi + carry) & U32_MASK


def limbs_add_i32(lo: torch.Tensor, hi: torch.Tensor, delta: torch.Tensor):
    """Exact 64-bit add of a SIGNED int32 ``delta`` to uint32 limbs: the
    high limb takes the carry of the low add plus the sign extension
    (all ones for a negative delta). Broadcasts elementwise."""
    d32 = delta.to(torch.int32).to(torch.int64)
    du = d32 & U32_MASK
    new_lo = (lo + du) & U32_MASK
    carry = (new_lo < du).to(torch.int64)
    sign_ext = torch.where(d32 < 0, U32_MASK, 0)
    return new_lo, (hi + carry + sign_ext) & U32_MASK


@dataclasses.dataclass
class StreamMeta:
    """Per-block stream metadata: absolute time of the first sample is
    ``epoch_sec + epoch_frac + abs_index / sample_rate`` with ``abs_index``
    the exact 64-bit counter held as (``abs_lo``, ``abs_hi``)."""

    abs_lo: torch.Tensor      # uint32 in int64 — low limb of abs index
    abs_hi: torch.Tensor      # uint32 in int64 — high limb
    epoch_sec: torch.Tensor   # int32
    epoch_frac: torch.Tensor  # float32
    flags: torch.Tensor       # uint32 in int64 — stream_flags bitmask
    seq: torch.Tensor         # uint32 in int64 — sequence counter
    sample_rate: float = 1.0

    @staticmethod
    def start(sample_rate: float, *, epoch_sec: int = 0,
              epoch_frac: float = 0.0, abs_index: int = 0,
              device="cuda") -> "StreamMeta":
        device = resolve_device(device)
        n = int(abs_index)
        return StreamMeta(
            abs_lo=scalar(n & U32_MASK, torch.int64, device),
            abs_hi=scalar((n >> 32) & U32_MASK, torch.int64, device),
            epoch_sec=scalar(epoch_sec, torch.int32, device),
            epoch_frac=scalar(epoch_frac, torch.float32, device),
            flags=scalar(stream_flags.NONE, torch.int64, device),
            seq=scalar(0, torch.int64, device),
            sample_rate=float(sample_rate),
        )

    def advanced(self, nsamples, *, rate_scale: float = 1.0) -> "StreamMeta":
        """Meta of the next block (``nsamples`` consumed); ``rate_scale``
        re-bases the rate for rate-changing blocks."""
        if not isinstance(nsamples, torch.Tensor):
            nsamples = scalar(int(nsamples), torch.int64, self.abs_lo.device)
        lo, hi = limbs_add(self.abs_lo, self.abs_hi, nsamples)
        return dataclasses.replace(
            self, abs_lo=lo, abs_hi=hi, seq=(self.seq + 1) & U32_MASK,
            sample_rate=self.sample_rate * rate_scale)

    def with_rate(self, sample_rate: float) -> "StreamMeta":
        return dataclasses.replace(self, sample_rate=float(sample_rate))


@dataclasses.dataclass
class Stream:
    """A block of samples with a validity count and metadata."""

    data: torch.Tensor
    count: torch.Tensor  # int32 0-d, number of valid samples
    meta: StreamMeta

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def full(data: torch.Tensor, meta: Optional[StreamMeta] = None,
             sample_rate: float = 1.0) -> "Stream":
        """Wrap a tensor as a fully valid stream block."""
        if meta is None:
            meta = StreamMeta.start(sample_rate, device=data.device)
        return Stream(data=data,
                      count=scalar(data.shape[0], torch.int32, data.device),
                      meta=meta)

    def valid_mask(self) -> torch.Tensor:
        """Boolean [N] mask of valid samples."""
        n = self.data.shape[0]
        return torch.arange(n, dtype=torch.int32,
                            device=self.data.device) < self.count

    def like(self, data: torch.Tensor, count=None, *,
             rate_scale: float = 1.0) -> "Stream":
        """New stream with the same meta lineage (possibly rate-scaled)."""
        meta = self.meta
        if rate_scale != 1.0:
            meta = meta.with_rate(meta.sample_rate * rate_scale)
        if count is None:
            count = scalar(data.shape[0], torch.int32, data.device)
        elif not isinstance(count, torch.Tensor):
            count = scalar(int(count), torch.int32, data.device)
        return Stream(data=data, count=count.to(torch.int32), meta=meta)
