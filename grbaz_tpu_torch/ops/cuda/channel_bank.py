"""The channel bank's channelizer: CUDA kernel (``csrc/channel_bank.cu``)
and its plain PyTorch version.

Computes, for C slots over one shared block ``x`` in one launch, what
``parallel/channel_bank.py: DynamicChannelBank`` computes per slot (the
JAX package's ``grbaz_tpu/parallel/channel_bank.py: apply``): every
sample rotated by the slot's LO ``exp(j*2pi*u32(phase0[c] +
i*lo_inc[c])/2^32)``, appended to the slot's ROTATED tail, low-pass
filtered with the real ``h_rev_pad`` and decimated; the frame's last
``tpad-1`` samples are the slot's new tail. The tail is taken and given
back exactly as the bank carries it, so the bank's state moves between
the kernel and plain arms and to the JAX package unchanged, across a
retune too (the old tail stays rotated under the old increment, as in
the JAX package).

The kernel computes the body as one 3xTF32 tensor-core product over the
block staged once for all slots, the head outputs (which reach into each
slot's tail) in rotate-then-filter form (``csrc/channel_bank.cu``). The
plain version is the JAX package's per-slot form. ``phase0`` and
``lo_inc`` are int64 tensors ``[C]`` holding uint32 values; the kernel
reads them from device memory, so a launch never waits for the card.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.fir import fir_decimate_frame

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "channel_bank": [_P, _P, _I64, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
MAX_GROUPS = 65535  # csrc/channel_bank.cu: grid rows of 16 slots


def _lib():
    return build.library("channel_bank", _SIGNATURES)


def channel_bank_plain(x, tail, h_rev_pad, decim, phase0, lo_inc):
    """``frames = cat(tail, x * lo)`` slot by slot, then
    ``fir_decimate_frame``; the new tail is the frames' last ``tpad-1``
    samples."""
    n, hist = x.shape[0], tail.shape[1]
    i = torch.arange(n, dtype=torch.int64, device=x.device)
    frames = torch.cat([tail, x * exact.lo_at(phase0[:, None],
                                              lo_inc[:, None], i)], dim=1)
    y = torch.stack([fir_decimate_frame(f, h_rev_pad, decim)
                     for f in frames])
    return y, frames[:, frames.shape[1] - hist:]


def channel_bank_kernel(x, tail, h_rev_pad, decim, phase0, lo_inc):
    dev = x.device
    if not x.is_cuda:
        raise ValueError("channel_bank_kernel needs CUDA tensors")
    tpad = h_rev_pad.shape[0]
    if x.dim() != 1 or tail.dim() != 2 or tail.shape[1] != tpad - 1:
        raise ValueError(f"x must be [n] and tail [slots, {tpad - 1}]")
    slots = tail.shape[0]
    if not 1 <= slots <= 16 * MAX_GROUPS:
        raise ValueError(f"{slots} slots; the kernel takes 1 to "
                         f"{16 * MAX_GROUPS}")
    if decim < 1 or tpad % decim:
        raise ValueError("taps must be padded to a multiple of decim")
    for name, t in (("x", x), ("tail", tail)):
        if t.dtype != torch.complex64:
            raise TypeError(f"{name} must be complex64, not {t.dtype}")
    if h_rev_pad.dtype != torch.float32:
        raise TypeError("taps must be float32")
    for name, t in (("phase0", phase0), ("lo_inc", lo_inc)):
        if t.dtype != torch.int64 or t.shape != (slots,):
            raise TypeError(f"{name} must be an int64 tensor of shape "
                            f"({slots},) (uint32 values)")
    for name, t in (("tail", tail), ("taps", h_rev_pad),
                    ("phase0", phase0), ("lo_inc", lo_inc)):
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, not {t.device}")
    x, tail, h = x.contiguous(), tail.contiguous(), h_rev_pad.contiguous()
    phase0, lo_inc = phase0.contiguous(), lo_inc.contiguous()
    n = x.shape[0]
    n_out = n // decim
    y = torch.empty(slots, n_out, dtype=torch.complex64, device=dev)
    new_tail = torch.empty_like(tail)
    err = _lib().channel_bank(
        x.data_ptr(), tail.data_ptr(), n, h.data_ptr(), phase0.data_ptr(),
        lo_inc.data_ptr(), y.data_ptr(), new_tail.data_ptr(), n_out, tpad,
        decim, slots, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "channel_bank")
    channel_bank.launches += 1
    return y, new_tail


def channel_bank(x, tail, h_rev_pad, decim, phase0, lo_inc):
    """``(y [C, len(x)//decim], new_tail [C, tpad-1])``, both rotated, of
    C channels over block ``x``: slot c has the rotated ``tail[c]``, the
    phase ``phase0[c]`` at ``x[0]`` and the increment ``lo_inc[c]``. The
    kernel, one launch for all slots, on the card; the plain version for
    CPU tensors."""
    if x.is_cuda:
        return channel_bank_kernel(x, tail, h_rev_pad, decim, phase0, lo_inc)
    return channel_bank_plain(x, tail, h_rev_pad, decim, phase0, lo_inc)


channel_bank.launches = 0
