"""Decimating FIR over a frame: CUDA kernel (``csrc/fir_decimate.cu``)
and its plain PyTorch twin.

Replaces ``grbaz_tpu/ops/pallas/fir_kernel.py: fir_decimate_frame_pallas``:
``y[k] = sum_t h_rev_pad[t] * frame[k*decim + t]`` over a float32 or
complex64 frame with ``tpad-1`` leading history.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops import fir
from grbaz_tpu_torch.ops.cuda import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_SIGNATURES = {"fir_decimate_f32": _ARGTYPES, "fir_decimate_c64": _ARGTYPES}


def _lib():
    return build.library("fir_decimate", _SIGNATURES)


# the plain version: the polyphase product of grbaz_tpu_torch.ops.fir
fir_decimate_frame_plain = fir.fir_decimate_frame


def fir_decimate_frame_kernel(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                              decim: int) -> torch.Tensor:
    """Launch the CUDA kernel. ``frame`` float32/complex64 on the card,
    ``h_rev_pad`` float32 of a length that is a multiple of ``decim``."""
    tpad = h_rev_pad.shape[0]
    if tpad % decim:
        raise ValueError("taps must be padded to a multiple of decim")
    if frame.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"frame must be float32 or complex64, not {frame.dtype}")
    if not (frame.is_cuda and h_rev_pad.is_cuda
            and frame.device == h_rev_pad.device):
        raise ValueError("frame and taps must lie on one CUDA device")
    if h_rev_pad.dtype != torch.float32:
        raise TypeError("taps must be float32")
    frame = frame.contiguous()
    h = h_rev_pad.contiguous()
    n_out = max(frame.shape[0] - (tpad - 1), 0) // decim
    y = torch.empty(n_out, dtype=frame.dtype, device=frame.device)
    lib = _lib()
    fn = lib.fir_decimate_c64 if frame.is_complex() else lib.fir_decimate_f32
    err = fn(frame.data_ptr(), frame.shape[0], h.data_ptr(), y.data_ptr(),
             n_out, tpad, decim,
             torch.cuda.current_stream(frame.device).cuda_stream)
    build.check(err, "fir_decimate_frame")
    fir_decimate_frame.launches += 1
    return y


def fir_decimate_frame(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                       decim: int) -> torch.Tensor:
    """The kernel for a frame on the card, the plain version for one on
    the CPU."""
    if frame.is_cuda:
        return fir_decimate_frame_kernel(frame, h_rev_pad, decim)
    return fir_decimate_frame_plain(frame, h_rev_pad, decim)


fir_decimate_frame.launches = 0
