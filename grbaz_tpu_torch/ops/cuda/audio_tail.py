"""The WBFM audio tail: CUDA kernels (``csrc/audio_tail.cu``) and their
plain PyTorch twins.

Two entry points, one launch each, with no host sync:

* :func:`fractional_resample`: one step of ``FractionalResampler`` (the
  exact 32.32 positions, the phase bins, the 8-tap MMSE interpolation,
  the count, the next position and the new tail), reading the carried
  tail and the new block in place. Plain twin:
  :func:`.resampler.resample_step_plain`. Counts, positions and tails are
  equal; the outputs agree to float32 rounding (the 8-tap sums' order).
* :func:`fm_deemphasis`: ``FMDeemphasis`` over one count-prefix block
  (the feed-forward, the one-pole recurrence, the held tail and both
  states). Plain twin: :func:`.demod.deemphasis_plain`, whose log-step
  scan sums in another order than the kernel's chunked serial scan.

Each takes the block's ``count`` and the carried state as device
tensors. On the card it launches the kernel, on the CPU it runs the plain
twin; ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.demod import deemphasis_plain
from grbaz_tpu_torch.ops.mmse import NTAPS
from grbaz_tpu_torch.ops.resampler import HIST, resample_step_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    "fractional_resample": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                            _P, _P, _P, _P, _P],
    "fm_deemphasis": [_P, _I, _P, _P, _P, _F, _F, _F, _P, _P, _P, _P],
}
# the largest block either kernel takes (int32 sample indices)
_MAX_N = 1 << 30


def _lib():
    return build.library("audio_tail", _SIGNATURES)


def _dense(t):
    # a launch for a strided view only: contiguous() is an op of its own
    return t if t.is_contiguous() else t.contiguous()


def _check(x, dtypes, want: dict):
    """``x`` [n] of one of ``dtypes`` on the card, and each of ``want``
    (name -> (tensor, dtype, shape)) on its card with that type and
    shape."""
    if x.dtype not in dtypes or x.dim() != 1:
        raise TypeError(f"x must be [n] of {dtypes}, not {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError("x must lie on a CUDA device")
    if not 1 <= x.shape[0] < _MAX_N:
        raise ValueError(f"a block of {x.shape[0]} samples is not taken")
    for name, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor) or t.device != x.device or \
                t.dtype != dtype or tuple(t.shape) != shape:
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"{name} must be {dtype} {shape} on "
                             f"{x.device}, not {got}")


def fractional_resample_kernel(x, tail, count, mu_int, mu_frac, inc_int,
                               inc_frac, capacity: int, taps_table):
    """Launch the resampler's kernel; every tensor on one card. ``x`` [n]
    float32 or complex64, ``tail`` [HIST] of its type, ``count``,
    ``mu_int`` and ``inc_int`` int32, ``mu_frac`` and ``inc_frac`` int64
    holding uint32 (0-d), ``taps_table`` [129, NTAPS] float32. Returns
    (y [capacity], n_out int32, new mu_int int32, new mu_frac int64, new
    tail)."""
    _check(x, (torch.float32, torch.complex64), {
        "tail": (tail, x.dtype, (HIST,)), "count": (count, torch.int32, ()),
        "mu_int": (mu_int, torch.int32, ()),
        "mu_frac": (mu_frac, torch.int64, ()),
        "inc_int": (inc_int, torch.int32, ()),
        "inc_frac": (inc_frac, torch.int64, ()),
        "taps_table": (taps_table, torch.float32, (129, NTAPS))})
    if not 1 <= capacity < 2 ** 31:
        raise ValueError(f"a capacity of {capacity} outputs is not taken")
    x, tail, taps_table = (_dense(t) for t in (x, tail, taps_table))
    dev = x.device
    y = torch.empty(capacity, dtype=x.dtype, device=dev)
    n_out = torch.empty((), dtype=torch.int32, device=dev)
    new_mu_int = torch.empty((), dtype=torch.int32, device=dev)
    new_mu_frac = torch.empty((), dtype=torch.int64, device=dev)
    new_tail = torch.empty(HIST, dtype=x.dtype, device=dev)
    err = _lib().fractional_resample(
        x.data_ptr(), tail.data_ptr(), int(x.is_complex()), x.shape[0],
        count.data_ptr(), mu_int.data_ptr(), mu_frac.data_ptr(),
        inc_int.data_ptr(), inc_frac.data_ptr(), taps_table.data_ptr(),
        int(capacity), y.data_ptr(), n_out.data_ptr(), new_mu_int.data_ptr(),
        new_mu_frac.data_ptr(), new_tail.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fractional_resample")
    fractional_resample.launches += 1
    return y, n_out, new_mu_int, new_mu_frac, new_tail


def fractional_resample(x, tail, count, mu_int, mu_frac, inc_int, inc_frac,
                        capacity: int, taps_table):
    """The kernel for ``x`` on the card, the plain step for ``x`` on the
    CPU."""
    if x.is_cuda:
        return fractional_resample_kernel(x, tail, count, mu_int, mu_frac,
                                          inc_int, inc_frac, capacity,
                                          taps_table)
    return resample_step_plain(x, tail, count, mu_int, mu_frac, inc_int,
                               inc_frac, capacity, taps_table)


def fm_deemphasis_kernel(x, count, y_prev, x_prev, b0: float, b1: float,
                         a: float):
    """Launch the deemphasis kernel; every tensor on one card. ``x`` [n]
    float32, ``count`` int32, ``y_prev`` and ``x_prev`` float32 (0-d);
    the coefficients are rounded to float32. Returns (y [n], new y_prev,
    new x_prev)."""
    _check(x, (torch.float32,), {
        "count": (count, torch.int32, ()),
        "y_prev": (y_prev, torch.float32, ()),
        "x_prev": (x_prev, torch.float32, ())})
    x = _dense(x)
    dev = x.device
    y = torch.empty(x.shape[0], dtype=torch.float32, device=dev)
    new_y_prev = torch.empty((), dtype=torch.float32, device=dev)
    new_x_prev = torch.empty((), dtype=torch.float32, device=dev)
    err = _lib().fm_deemphasis(
        x.data_ptr(), x.shape[0], count.data_ptr(), y_prev.data_ptr(),
        x_prev.data_ptr(), float(np.float32(b0)), float(np.float32(b1)),
        float(np.float32(a)), y.data_ptr(), new_y_prev.data_ptr(),
        new_x_prev.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fm_deemphasis")
    fm_deemphasis.launches += 1
    return y, new_y_prev, new_x_prev


def fm_deemphasis(x, count, y_prev, x_prev, b0: float, b1: float, a: float):
    """The kernel for ``x`` on the card, the plain version for ``x`` on
    the CPU."""
    if x.is_cuda:
        return fm_deemphasis_kernel(x, count, y_prev, x_prev, b0, b1, a)
    return deemphasis_plain(x, count, y_prev, x_prev, b0, b1, a)


fractional_resample.launches = 0
fm_deemphasis.launches = 0
