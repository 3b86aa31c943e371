"""Frequency-translating decimating FIR: CUDA kernel
(``csrc/xlating_fir.cu``) and its plain PyTorch twins.

Replaces two TPU kernels of ``grbaz_tpu/ops/pallas/wbfm_frontend.py``:

* ``xlating_fir_block_pallas_xal`` -> :func:`xlating_fir_block`: a new
  block ``x`` plus the carried UNROTATED ``tail`` (``tail[1:]`` is the
  filter history). Every sample is rotated by
  ``exp(j*2pi*u32(phase0 + i*lo_inc)/2^32)`` with ``i`` counted from
  ``x[0]`` (negative over the history), then filtered with the real
  ``h_rev_pad`` and decimated. The output is ROTATED.
* ``xlating_fir_frame_pallas_rtf`` -> :func:`xlating_fir_frame_rtf`: the
  same over ``frame = concat(tail[1:], x)``; a second entry point of the
  same CUDA kernel.

The kernel computes the factored form: B2's rotated complex taps over
the raw samples, then one LO rotation per output (``csrc/xlating_fir.cu``);
the plain twins stay rotate-then-filter, the independent reference it is
held to. ``phase0`` and ``lo_inc`` are 0-d int64 tensors holding uint32
values; the kernel reads them from device memory, so a launch never
waits for the card.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.core.device import U32_MASK
from grbaz_tpu_torch.ops import exact, fir
from grbaz_tpu_torch.ops.cuda import build, tiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_G = tiling.Geometry
_SIGNATURES = {
    "xlating_fir_block": [_P, _P, _I64, _P, _P, _P, _P, _I, _I, _I, _G, _P],
    "xlating_fir_frame_rtf": [_P, _I64, _P, _P, _P, _P, _I, _I, _I, _G, _P],
}


def _lib():
    return build.library("xlating_fir", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain twins: oscillator + rotate + fir_decimate_tail_block
# ---------------------------------------------------------------------------

def xlating_fir_block_plain(x, tail, h_rev_pad, decim, phase0, lo_inc):
    tpad = h_rev_pad.shape[0]
    lo, _ = exact.oscillator(x.shape[0], phase0, lo_inc)
    lo_t, _ = exact.oscillator(tpad, (phase0 - tpad * lo_inc) & U32_MASK,
                               lo_inc)
    return fir.fir_decimate_tail_block(tail * lo_t, x * lo, h_rev_pad, decim)


def xlating_fir_frame_rtf_plain(frame, h_rev_pad, decim, phase0, lo_inc):
    tpad = h_rev_pad.shape[0]
    ph_f0 = (phase0 - (tpad - 1) * lo_inc) & U32_MASK
    lo, _ = exact.oscillator(frame.shape[0], ph_f0, lo_inc)
    return fir.fir_decimate_frame(frame * lo, h_rev_pad, decim)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_common(h_rev_pad, decim, phase0, lo_inc, dev):
    if h_rev_pad.shape[0] % decim:
        raise ValueError("taps must be padded to a multiple of decim")
    if h_rev_pad.dtype != torch.float32:
        raise TypeError("taps must be float32")
    for name, t in (("taps", h_rev_pad), ("phase0", phase0),
                    ("lo_inc", lo_inc)):
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, not {t.device}")
    for name, t in (("phase0", phase0), ("lo_inc", lo_inc)):
        if t.dtype != torch.int64 or t.numel() != 1:
            raise TypeError(f"{name} must be a 0-d int64 tensor "
                            "(uint32 value)")


def _c64(t, name):
    if t.dtype != torch.complex64:
        raise TypeError(f"{name} must be complex64, not {t.dtype}")
    return t.contiguous()


def xlating_fir_block_kernel(x, tail, h_rev_pad, decim, phase0, lo_inc):
    if not x.is_cuda:
        raise ValueError("xlating_fir_block_kernel needs CUDA tensors")
    _check_common(h_rev_pad, decim, phase0, lo_inc, x.device)
    tpad = h_rev_pad.shape[0]
    if tail.shape != (tpad,) or tail.device != x.device:
        raise ValueError(f"tail must be [{tpad}] on {x.device}")
    x, tail = _c64(x, "x"), _c64(tail, "tail")
    h = h_rev_pad.contiguous()
    n = x.shape[0]
    n_out = n // decim
    y = torch.empty(n_out, dtype=torch.complex64, device=x.device)
    err = _lib().xlating_fir_block(
        x.data_ptr(), tail.data_ptr(), n, h.data_ptr(), phase0.data_ptr(),
        lo_inc.data_ptr(), y.data_ptr(), n_out, tpad, decim,
        tiling.for_tensor(x, n_out, tpad, decim, 8),  # complex taps
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "xlating_fir_block")
    xlating_fir_block.launches += 1
    return y


def xlating_fir_frame_rtf_kernel(frame, h_rev_pad, decim, phase0, lo_inc):
    if not frame.is_cuda:
        raise ValueError("xlating_fir_frame_rtf_kernel needs CUDA tensors")
    _check_common(h_rev_pad, decim, phase0, lo_inc, frame.device)
    tpad = h_rev_pad.shape[0]
    frame = _c64(frame, "frame")
    h = h_rev_pad.contiguous()
    n = frame.shape[0] - (tpad - 1)
    if n < 0:
        raise ValueError(f"frame shorter than the {tpad - 1}-sample history")
    n_out = n // decim
    y = torch.empty(n_out, dtype=torch.complex64, device=frame.device)
    err = _lib().xlating_fir_frame_rtf(
        frame.data_ptr(), n, h.data_ptr(), phase0.data_ptr(),
        lo_inc.data_ptr(), y.data_ptr(), n_out, tpad, decim,
        tiling.for_tensor(frame, n_out, tpad, decim, 8),  # complex taps
        torch.cuda.current_stream(frame.device).cuda_stream)
    build.check(err, "xlating_fir_frame_rtf")
    xlating_fir_frame_rtf.launches += 1
    return y


# ---------------------------------------------------------------------------
# wrappers: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------

def xlating_fir_block(x, tail, h_rev_pad, decim, phase0, lo_inc):
    """Rotated channel outputs ``[len(x)//decim]`` of new block ``x`` with
    the carried unrotated ``tail``; ``phase0`` is the phase of ``x[0]``."""
    if x.is_cuda:
        return xlating_fir_block_kernel(x, tail, h_rev_pad, decim, phase0,
                                        lo_inc)
    return xlating_fir_block_plain(x, tail, h_rev_pad, decim, phase0, lo_inc)


def xlating_fir_frame_rtf(frame, h_rev_pad, decim, phase0, lo_inc):
    """Rotated channel outputs over ``frame = concat(tail[1:], x)``;
    ``phase0`` is the phase of the first new sample ``frame[tpad-1]``."""
    if frame.is_cuda:
        return xlating_fir_frame_rtf_kernel(frame, h_rev_pad, decim, phase0,
                                            lo_inc)
    return xlating_fir_frame_rtf_plain(frame, h_rev_pad, decim, phase0,
                                       lo_inc)


xlating_fir_block.launches = 0
xlating_fir_frame_rtf.launches = 0
