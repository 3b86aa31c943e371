"""Decimating FIR: CUDA kernel (``csrc/fir_decimate.cu``) and its plain
PyTorch twins.

Replaces ``grbaz_tpu/ops/pallas/fir_kernel.py: fir_decimate_frame_pallas``:
``y[k] = sum_t h_rev_pad[t] * frame[k*decim + t]`` over a float32 or
complex64 frame with ``tpad-1`` leading history. Two entry points of the
one kernel:

* :func:`fir_decimate_frame`: over the frame, the JAX kernel's signature;
* :func:`fir_decimate_block`: a new block ``x`` plus the carried
  ``tail`` (``tail[1:]`` is the history), read in place -- what
  ``FIRDecimator`` launches, with no concatenation.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops import fir
from grbaz_tpu_torch.ops.cuda import build, tiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_G = tiling.Geometry
_FRAME = [_P, _I64, _P, _P, _I, _I, _I, _G, _P]
_BLOCK = [_P, _P, _I64, _P, _P, _I, _I, _I, _G, _P]
_SIGNATURES = {"fir_decimate_f32": _FRAME, "fir_decimate_c64": _FRAME,
               "fir_decimate_block_f32": _BLOCK,
               "fir_decimate_block_c64": _BLOCK}


def _lib():
    return build.library("fir_decimate", _SIGNATURES)


# the plain versions: the polyphase product of grbaz_tpu_torch.ops.fir
fir_decimate_frame_plain = fir.fir_decimate_frame
fir_decimate_block_plain = fir.fir_decimate_tail_block


def _check(frame, h_rev_pad, decim):
    tpad = h_rev_pad.shape[0]
    if decim < 1 or tpad % decim:
        raise ValueError("taps must be padded to a multiple of decim")
    if frame.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"frame must be float32 or complex64, not {frame.dtype}")
    if not (frame.is_cuda and h_rev_pad.is_cuda
            and frame.device == h_rev_pad.device):
        raise ValueError("frame and taps must lie on one CUDA device")
    if h_rev_pad.dtype != torch.float32:
        raise TypeError("taps must be float32")
    return h_rev_pad.contiguous(), tpad


def fir_decimate_frame_kernel(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                              decim: int) -> torch.Tensor:
    """Launch the CUDA kernel. ``frame`` float32/complex64 on the card,
    ``h_rev_pad`` float32 of a length that is a multiple of ``decim``."""
    h, tpad = _check(frame, h_rev_pad, decim)
    frame = frame.contiguous()
    n_out = max(frame.shape[0] - (tpad - 1), 0) // decim
    y = torch.empty(n_out, dtype=frame.dtype, device=frame.device)
    lib = _lib()
    fn = lib.fir_decimate_c64 if frame.is_complex() else lib.fir_decimate_f32
    geo = tiling.for_tensor(frame, n_out, tpad, decim, 4)  # real taps
    err = fn(frame.data_ptr(), frame.shape[0], h.data_ptr(), y.data_ptr(),
             n_out, tpad, decim, geo,
             torch.cuda.current_stream(frame.device).cuda_stream)
    build.check(err, "fir_decimate_frame")
    fir_decimate_frame.launches += 1
    return y


def fir_decimate_block_kernel(x: torch.Tensor, tail: torch.Tensor,
                              h_rev_pad: torch.Tensor,
                              decim: int) -> torch.Tensor:
    """Launch the CUDA kernel on a new block ``x`` and the carried
    ``tail`` (``tpad`` samples of ``x``'s type on its card)."""
    h, tpad = _check(x, h_rev_pad, decim)
    if tuple(tail.shape) != (tpad,) or tail.dtype != x.dtype \
            or tail.device != x.device:
        raise ValueError(f"tail must be [{tpad}] {x.dtype} on {x.device}")
    x, tail = x.contiguous(), tail.contiguous()
    n = x.shape[0]
    n_out = n // decim
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    lib = _lib()
    fn = lib.fir_decimate_block_c64 if x.is_complex() \
        else lib.fir_decimate_block_f32
    geo = tiling.for_tensor(x, n_out, tpad, decim, 4)  # real taps
    err = fn(x.data_ptr(), tail.data_ptr(), n, h.data_ptr(), y.data_ptr(),
             n_out, tpad, decim, geo,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fir_decimate_block")
    fir_decimate_block.launches += 1
    return y


def fir_decimate_frame(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                       decim: int) -> torch.Tensor:
    """The kernel for a frame on the card, the plain version for one on
    the CPU."""
    if frame.is_cuda:
        return fir_decimate_frame_kernel(frame, h_rev_pad, decim)
    return fir_decimate_frame_plain(frame, h_rev_pad, decim)


def fir_decimate_block(x: torch.Tensor, tail: torch.Tensor,
                       h_rev_pad: torch.Tensor, decim: int) -> torch.Tensor:
    """``fir_decimate_frame(concat(tail[1:], x))``: the kernel's block
    entry point on the card, the plain version on the CPU."""
    if x.is_cuda:
        return fir_decimate_block_kernel(x, tail, h_rev_pad, decim)
    return fir_decimate_block_plain(tail, x, h_rev_pad, decim)


fir_decimate_frame.launches = 0
fir_decimate_block.launches = 0
