"""Rotated-taps frequency-translating decimating FIR: CUDA kernel
(``csrc/xlating_fir_ctaps.cu``) and its plain PyTorch twins.

Replaces ``xlating_fir_frame_pallas`` of
``grbaz_tpu/ops/pallas/wbfm_frontend.py``: complex taps
``g = rotated_taps(h_rev_pad, lo_inc)`` over raw samples,
``yf[k] = sum_t g[t] * frame[k*decim + t]``, output UNROTATED. Two entry
points of the one kernel:

* :func:`xlating_fir_ctaps_block`: a new block ``x`` plus the carried
  raw ``tail`` (``tail[1:]`` is the history), read in place -- what
  ``WBFMFrontend`` launches;
* :func:`xlating_fir_ctaps_frame`: over ``frame = concat(tail[1:], x)``,
  the JAX kernel's signature.

The kernel is the polyphase core (``csrc/polyphase_fir.cuh``) with
rotated taps and a plain store, launched with the geometry that
``tiling`` picks for complex samples and complex taps.

``lo_inc`` is a 0-d int64 tensor holding a uint32 value; the kernel
builds the taps from it in device memory, so a launch never waits for
the card.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build, tiling
from grbaz_tpu_torch.ops.fir import fir_decimate_frame_ctaps
from grbaz_tpu_torch.ops.wbfm_frontend import rotated_taps

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_G = tiling.Geometry
_SIGNATURES = {
    "xlating_fir_ctaps_block": [_P, _P, _I64, _P, _P, _P, _I, _I, _I, _G, _P],
    "xlating_fir_ctaps_frame": [_P, _I64, _P, _P, _P, _I, _I, _I, _G, _P],
}


def _lib():
    return build.library("xlating_fir_ctaps", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain twins: rotated_taps + the complex-tap polyphase product
# ---------------------------------------------------------------------------

def xlating_fir_ctaps_frame_plain(frame, h_rev_pad, decim, lo_inc):
    return fir_decimate_frame_ctaps(frame, rotated_taps(h_rev_pad, lo_inc),
                                    decim)


def xlating_fir_ctaps_block_plain(x, tail, h_rev_pad, decim, lo_inc):
    return xlating_fir_ctaps_frame_plain(torch.cat([tail[1:], x]), h_rev_pad,
                                         decim, lo_inc)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(t, name, dev, dtype, shape=None):
    if t.device != dev:
        raise ValueError(f"{name} must lie on {dev}, not {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, not "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _taps_and_inc(h_rev_pad, decim, lo_inc, dev):
    if decim < 1 or h_rev_pad.shape[0] % decim:
        raise ValueError("taps must be padded to a multiple of decim")
    h = _check(h_rev_pad, "taps", dev, torch.float32)
    inc = _check(lo_inc, "lo_inc", dev, torch.int64, ())
    return h, inc


def xlating_fir_ctaps_block_kernel(x, tail, h_rev_pad, decim, lo_inc):
    if not x.is_cuda:
        raise ValueError("xlating_fir_ctaps_block_kernel needs CUDA tensors")
    h, inc = _taps_and_inc(h_rev_pad, decim, lo_inc, x.device)
    tpad = h.shape[0]
    x = _check(x, "x", x.device, torch.complex64)
    tail = _check(tail, "tail", x.device, torch.complex64, (tpad,))
    n = x.shape[0]
    n_out = n // decim
    y = torch.empty(n_out, dtype=torch.complex64, device=x.device)
    err = _lib().xlating_fir_ctaps_block(
        x.data_ptr(), tail.data_ptr(), n, h.data_ptr(), inc.data_ptr(),
        y.data_ptr(), n_out, tpad, decim,
        tiling.for_tensor(x, n_out, tpad, decim, 8),  # complex taps
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "xlating_fir_ctaps_block")
    xlating_fir_ctaps_block.launches += 1
    return y


def xlating_fir_ctaps_frame_kernel(frame, h_rev_pad, decim, lo_inc):
    if not frame.is_cuda:
        raise ValueError("xlating_fir_ctaps_frame_kernel needs CUDA tensors")
    h, inc = _taps_and_inc(h_rev_pad, decim, lo_inc, frame.device)
    tpad = h.shape[0]
    frame = _check(frame, "frame", frame.device, torch.complex64)
    n = frame.shape[0] - (tpad - 1)
    if n < 0:
        raise ValueError(f"frame shorter than the {tpad - 1}-sample history")
    n_out = n // decim
    y = torch.empty(n_out, dtype=torch.complex64, device=frame.device)
    err = _lib().xlating_fir_ctaps_frame(
        frame.data_ptr(), n, h.data_ptr(), inc.data_ptr(), y.data_ptr(),
        n_out, tpad, decim,
        tiling.for_tensor(frame, n_out, tpad, decim, 8),  # complex taps
        torch.cuda.current_stream(frame.device).cuda_stream)
    build.check(err, "xlating_fir_ctaps_frame")
    xlating_fir_ctaps_frame.launches += 1
    return y


# ---------------------------------------------------------------------------
# wrappers: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------

def xlating_fir_ctaps_block(x, tail, h_rev_pad, decim, lo_inc):
    """Unrotated channel outputs ``[len(x)//decim]`` of new block ``x``
    with the carried raw ``tail``."""
    if x.is_cuda:
        return xlating_fir_ctaps_block_kernel(x, tail, h_rev_pad, decim,
                                              lo_inc)
    return xlating_fir_ctaps_block_plain(x, tail, h_rev_pad, decim, lo_inc)


def xlating_fir_ctaps_frame(frame, h_rev_pad, decim, lo_inc):
    """Unrotated channel outputs over ``frame`` (tpad-1 raw history, then
    the new samples)."""
    if frame.is_cuda:
        return xlating_fir_ctaps_frame_kernel(frame, h_rev_pad, decim, lo_inc)
    return xlating_fir_ctaps_frame_plain(frame, h_rev_pad, decim, lo_inc)


xlating_fir_ctaps_block.launches = 0
xlating_fir_ctaps_frame.launches = 0
