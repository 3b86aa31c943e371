"""The ratio-stream resampler's walk: CUDA kernel (``csrc/vrr_walk.cu``)
and its plain version.

Replaces the per-output ``lax.scan`` of ``VariableRatioResampler.apply``
(``grbaz_tpu/ops/resampler.py:315``). :func:`vrr_walk` takes one block of
the signal (float32 or complex64) and of the ratio stream with their
carried tails and the carried position, and returns (y [capacity], count
int32, new q int32, new mu int64 holding uint32, overran bool, new tail,
new ratio tail). On the card it launches the kernel: one thread walks the
exact 32.32 positions from a shared-memory table of the ratio stream's
steps while the block interpolates them; on the CPU it runs
:func:`.resampler.vrr_walk_plain`. Counts, positions and flags are equal;
the outputs agree to float32 rounding (the 8-tap sums' order).

:func:`chain_step_ns` is a benchmark hook, not part of the resampler's
interface: it times the walk's dependent step alone (the source's
``vrr_chain_probe``) for the chain bound that ``chip_smoke.py`` prints
beside the kernel's time. No block calls it.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.core.device import U32_MASK
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.mmse import NTAPS
from grbaz_tpu_torch.ops.resampler import HIST, vrr_walk_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {
    "vrr_walk": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                 _P],
    "vrr_chain_probe": [_I, _P, _P],
}


def _lib():
    return build.library("vrr_walk", _SIGNATURES)


def vrr_walk_kernel(x, tail, rr, rr_tail, q0, mu0, count, capacity: int,
                    taps_table):
    """Launch the CUDA kernel; every tensor on one card."""
    if x.dtype not in (torch.float32, torch.complex64) or x.dim() != 1:
        raise TypeError(f"x must be [n] float32 or complex64, not {x.dtype} "
                        f"{tuple(x.shape)}")
    n = x.shape[0]
    if not x.is_cuda:
        raise ValueError("x must lie on a CUDA device")
    if n < NTAPS or n >= 2 ** 30 or capacity < 1 or capacity >= 2 ** 31:
        raise ValueError(f"a block of {n} samples into {capacity} outputs "
                         "is not taken")
    want = {"tail": (tail, x.dtype, (HIST,)),
            "rr": (rr, torch.float32, (n,)),
            "rr_tail": (rr_tail, torch.float32, (HIST,)),
            "q0": (q0, torch.int32, ()), "mu0": (mu0, torch.int64, ()),
            "count": (count, torch.int32, ()),
            "taps_table": (taps_table, torch.float32, (129, NTAPS))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype or \
                tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {x.device}, "
                             f"not {t.dtype} {tuple(t.shape)} on {t.device}")
    x, tail, rr, rr_tail, taps_table = (
        t.contiguous() for t in (x, tail, rr, rr_tail, taps_table))
    y = torch.empty(capacity, dtype=x.dtype, device=x.device)
    out = torch.empty(4, dtype=torch.int32, device=x.device)
    new_tail = torch.empty_like(tail)
    new_rr_tail = torch.empty_like(rr_tail)
    err = _lib().vrr_walk(
        x.data_ptr(), tail.data_ptr(), int(x.is_complex()), rr.data_ptr(),
        rr_tail.data_ptr(), n, q0.data_ptr(), mu0.data_ptr(),
        count.data_ptr(), int(capacity), taps_table.data_ptr(), y.data_ptr(),
        out.data_ptr(), new_tail.data_ptr(), new_rr_tail.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "vrr_walk")
    vrr_walk.launches += 1
    return (y, out[0], out[1], out[2].to(torch.int64) & U32_MASK,
            out[3] != 0, new_tail, new_rr_tail)


def vrr_walk(x, tail, rr, rr_tail, q0, mu0, count, capacity: int,
             taps_table):
    """The kernel for ``x`` on the card, the plain version for ``x`` on
    the CPU."""
    if x.is_cuda:
        return vrr_walk_kernel(x, tail, rr, rr_tail, q0, mu0, count,
                               capacity, taps_table)
    return vrr_walk_plain(x, tail, rr, rr_tail, q0, mu0, count, capacity,
                          taps_table)


vrr_walk.launches = 0


def chain_step_ns(steps: int = 1 << 20) -> float:
    """(Benchmark hook.) ns of one dependent step of the walk (a 64-bit
    add of a shared-memory word read at the position it produced) on the
    current card, one thread over ``steps`` steps."""
    return build.chain_step_ns(_lib(), "vrr_chain_probe", steps)
