"""The FasTrak decoder FSM: CUDA kernel (``csrc/fastrak_fsm.cu``) and its
plain version.

Replaces the per-sample ``lax.scan`` of ``FastrakDecoder.apply``
(``grbaz_tpu/ops/misc.py:72``). :func:`fastrak_fsm` walks each row of
``metric`` and ``sync`` [B, n] as an independent stream, from the [B]
state fields of ``FastrakDecoder`` (:data:`.misc.FT_FIELDS`), and returns
(events [B, 32, 3] float32, event count [B] int32, the new state). On the
card it launches the kernel, a chunk-parallel speculative walk (chunks of
``chunk`` samples, each but a row's first walking from a SEARCH guess
``warm`` samples before it, checked in order and walked again where the
guess missed); on the CPU it runs :func:`.misc.fastrak_fsm_plain`. The
result is the same bits whatever ``chunk`` and ``warm`` are.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.core.device import U32_MASK
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.misc import (FT_FIELDS, FT_U32, MAX_EVENTS,
                                      fastrak_fsm_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {"fastrak_fsm": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                               _I, _P, _P, _P, _P, _P, _P]}
# the launch's defaults: samples a chunk, warm-up samples before a guess
# (two frames at oversampling 8 are 1216 samples)
CHUNK = 1024
WARM = 1280
MAX_CHUNK = 1 << 16
MAX_WARM = 1 << 20
REC = 32   # ints a chunk record


def _lib():
    return build.library("fastrak_fsm", _SIGNATURES)


def frame_cap(chunk: int) -> int:
    """Passing frames a chunk's record holds (they pass >= 76 samples
    apart at any oversampling)."""
    return chunk // 64 + 2


def fastrak_fsm_kernel(metric: torch.Tensor, sync: torch.Tensor,
                       state: dict, threshold: torch.Tensor,
                       oversampling: int, *, chunk: int = CHUNK,
                       warm: int = WARM):
    """Launch the CUDA kernel: ``metric`` and ``sync`` [B, n] float32 on
    the card, ``state`` [B] tensors on it, ``threshold`` [B] or [1]. The
    count of chunks walked again, per row, is left on the card in
    ``fastrak_fsm.last_repairs`` (no sync here)."""
    for name, t in (("metric", metric), ("sync", sync)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"{name} must be [B, n] float32, not {t.dtype} "
                            f"{tuple(t.shape)}")
        if not t.is_cuda:
            raise ValueError(f"{name} must lie on a CUDA device")
    if sync.shape != metric.shape:
        raise ValueError(f"sync {tuple(sync.shape)} and metric "
                         f"{tuple(metric.shape)} differ")
    rows, n = metric.shape
    if n < 1 or n >= 2 ** 31 or rows < 1 or rows >= 2 ** 16:
        raise ValueError(f"rows of shape {tuple(metric.shape)} are not "
                         "walkable")
    if not (32 <= chunk <= MAX_CHUNK) or chunk % 32 or \
            not 0 <= warm <= MAX_WARM or oversampling < 1:
        raise ValueError(f"chunk {chunk}, warm {warm} or oversampling "
                         f"{oversampling} not taken")
    for k, v in list(state.items()) + [("threshold", threshold)]:
        if v.device != metric.device:
            raise ValueError(f"{k} must lie on {metric.device}, not "
                             f"{v.device}")
    dev = metric.device
    metric, sync = metric.contiguous(), sync.contiguous()
    thr = threshold.to(torch.float32).reshape(-1).expand(rows).contiguous()
    # uint32 fields go in as their bits: int64 values above 2^31 wrap
    sin = torch.stack([state[k].reshape(rows).to(torch.int64).to(torch.int32)
                       for k in FT_FIELDS]).contiguous()
    events = torch.empty(rows, MAX_EVENTS, 3, dtype=torch.float32, device=dev)
    n_ev = torch.empty(rows, dtype=torch.int32, device=dev)
    sout = torch.empty_like(sin)
    k = -(-n // chunk)
    rec = torch.empty(rows * k, REC, dtype=torch.int32, device=dev)
    frames = torch.empty(rows * k, frame_cap(chunk), 3, dtype=torch.int32,
                         device=dev)
    late = torch.empty(rows * k * frame_cap(chunk), 3, dtype=torch.float32,
                       device=dev)
    totals = torch.empty(rows, dtype=torch.int32, device=dev)
    repairs = torch.empty(rows, dtype=torch.int32, device=dev)
    err = _lib().fastrak_fsm(
        metric.data_ptr(), sync.data_ptr(), n, rows, thr.data_ptr(),
        sin.data_ptr(), events.data_ptr(), n_ev.data_ptr(), sout.data_ptr(),
        int(oversampling), int(chunk), int(warm), rec.data_ptr(),
        frames.data_ptr(), late.data_ptr(), totals.data_ptr(),
        repairs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fastrak_fsm")
    fastrak_fsm.launches += 1
    fastrak_fsm.last_repairs = repairs
    new = {}
    for name, v in zip(FT_FIELDS, sout):
        new[name] = (v.to(torch.int64) & U32_MASK) if name in FT_U32 else v
    new["compute_crc"] = new["compute_crc"] != 0
    return events, n_ev, new


def fastrak_fsm(metric: torch.Tensor, sync: torch.Tensor, state: dict,
                threshold: torch.Tensor, oversampling: int, **launch):
    """The kernel for rows on the card, the plain version for rows on the
    CPU (``launch``: the kernel's chunk and warm)."""
    if metric.is_cuda:
        return fastrak_fsm_kernel(metric, sync, state, threshold,
                                  oversampling, **launch)
    return fastrak_fsm_plain(metric, sync, state, threshold, oversampling)


fastrak_fsm.launches = 0
fastrak_fsm.last_repairs = None
