"""The lockout / look-ahead peak FSM: CUDA kernel (``csrc/peak_fsm.cu``)
and its plain version.

Replaces the per-sample ``lax.scan`` of ``PeakDetector._apply_scan``
(``grbaz_tpu/ops/detect.py:236``). :func:`peak_fsm` walks each row of
``x`` [B, n] as an independent stream, from the [B] state fields of
``PeakDetector`` (the JAX names and dtypes), and returns (marks [B, n]
float32, idx_diff [B, n] int32, the new state). On the card it launches
the kernel, a chunk-parallel speculative walk (chunks of ``chunk``
samples, each but a row's first walking from a guess ``warm`` samples
before it, checked in order and walked again where the guess missed);
on the CPU it runs :func:`.detect.peak_fsm_plain`. The result is the
same bits whatever ``chunk`` and ``warm`` are.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.detect import (FSM_F32, FSM_I32, fsm_constants,
                                        peak_fsm_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int


class Config(ctypes.Structure):
    """``PeakFsmConfig`` of ``csrc/peak_fsm.cu``, passed by value."""

    _fields_ = [("alpha", ctypes.c_float), ("beta", ctypes.c_float),
                ("keep", ctypes.c_float), ("min_diff", ctypes.c_float),
                ("min_len", _I), ("lockout", _I), ("look_ahead", _I)]


_SIGNATURES = {"peak_fsm": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, Config,
                            _I, _I, _P, _P, _P, _P, _P]}
# the launch's defaults: samples a chunk, warm-up samples before a guess
CHUNK = 256
WARM = 256
WALKERS = 32            # chunks of a block of the first pass
SMEM_LIMIT = 227 * 1024
# the int state block's rows: rising first, then the int32 fields
_INT_ROWS = ("rising",) + FSM_I32


def _lib():
    return build.library("peak_fsm", _SIGNATURES)


def tile_bytes(chunk: int, warm: int) -> int:
    """Shared memory of a first-pass block: its chunks, the warm-up and
    guess samples before them, and a pad word a chunk."""
    q = WALKERS * chunk + warm + 2
    return 4 * (q + q // chunk + 1)


def peak_fsm_kernel(x: torch.Tensor, state: dict, threshold: torch.Tensor, *,
                    min_diff: float, min_len: int, lockout: int, drop: float,
                    alpha: float, look_ahead: int, chunk: int = CHUNK,
                    warm: int = WARM):
    """Launch the CUDA kernel: ``x`` [B, n] float32 on the card, ``state``
    [B] tensors on it, ``threshold`` [B] or [1]. The count of chunks
    walked again, per row, is left on the card in
    ``peak_fsm.last_repairs`` (read it after the launch; no sync here)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be [B, n] float32, not {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError("x must lie on a CUDA device")
    rows, n = x.shape
    if n < 1 or n >= 2 ** 31 or rows < 1:
        raise ValueError(f"x of shape {tuple(x.shape)} is not walkable")
    if chunk < 2 or warm < 0 or tile_bytes(chunk, warm) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} and warm {warm} do not fit a block")
    for k, v in list(state.items()) + [("threshold", threshold)]:
        if v.device != x.device:
            raise ValueError(f"{k} must lie on {x.device}, not {v.device}")
    x = x.contiguous()
    thr = threshold.to(torch.float32).reshape(-1).expand(rows).contiguous()
    fin = torch.stack([state[k].reshape(rows).to(torch.float32)
                       for k in FSM_F32]).contiguous()
    iin = torch.stack([state[k].reshape(rows).to(torch.int32)
                       for k in _INT_ROWS]).contiguous()
    marks = torch.empty_like(x)
    idx_out = torch.empty(rows, n, dtype=torch.int32, device=x.device)
    fout, iout = torch.empty_like(fin), torch.empty_like(iin)
    k = -(-n // chunk)
    rec_f = torch.empty(8, rows * k, dtype=torch.float32, device=x.device)
    rec_i = torch.empty(10, rows * k, dtype=torch.int32, device=x.device)
    emits = torch.empty(rows * k, chunk // 2 + 1, 2, dtype=torch.int32,
                        device=x.device)
    repairs = torch.empty(rows, dtype=torch.int32, device=x.device)
    a, b, keep, md = fsm_constants(min_diff, drop, alpha)
    cfg = Config(float(a), float(b), float(keep), float(md), int(min_len),
                 int(lockout), int(look_ahead))
    err = _lib().peak_fsm(
        x.data_ptr(), n, rows, thr.data_ptr(), fin.data_ptr(), iin.data_ptr(),
        marks.data_ptr(), idx_out.data_ptr(), fout.data_ptr(),
        iout.data_ptr(), cfg, int(chunk), int(warm), rec_f.data_ptr(),
        rec_i.data_ptr(),
        emits.data_ptr(), repairs.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "peak_fsm")
    peak_fsm.launches += 1
    peak_fsm.last_repairs = repairs
    new = dict(zip(FSM_F32, fout))
    new.update(zip(FSM_I32, iout[1:]))
    new["rising"] = iout[0] != 0
    return marks, idx_out, new


def peak_fsm(x: torch.Tensor, state: dict, threshold: torch.Tensor,
             **config):
    """The kernel for ``x`` on the card, the plain version for ``x`` on
    the CPU (``config``: min_diff, min_len, lockout, drop, alpha,
    look_ahead; on the card also the kernel's chunk and warm)."""
    if x.is_cuda:
        return peak_fsm_kernel(x, state, threshold, **config)
    return peak_fsm_plain(x, state, threshold, **config)


peak_fsm.launches = 0
peak_fsm.last_repairs = None
