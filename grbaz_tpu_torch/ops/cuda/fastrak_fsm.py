"""The FasTrak decoder FSM: CUDA kernel (``csrc/fastrak_fsm.cu``) and its
plain version.

Replaces the per-sample ``lax.scan`` of ``FastrakDecoder.apply``
(``grbaz_tpu/ops/misc.py:72``). :func:`fastrak_fsm` walks each row of
``metric`` and ``sync`` [B, n] as an independent stream, from the [B]
state fields of ``FastrakDecoder`` (:data:`.misc.FT_FIELDS`), and returns
(events [B, 32, 3] float32, event count [B] int32, the new state). On the
card it launches the kernel, a chain of candidate frames (every sync hit
works out the frame a fire there would walk, a tile of ``tile`` samples a
block; then one block a row follows the fires from frame end to the next
hit); on the CPU it runs :func:`.misc.fastrak_fsm_plain`. The result is the
same bits whatever ``tile`` is.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.misc import (FT_FIELDS, FT_U32, MAX_EVENTS,
                                      fastrak_fsm_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {"fastrak_fsm": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                               _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]}
# samples a pass-1 block of the launch works out the candidates of, by
# default and at most (a multiple of 128)
TILE = 8192
MAX_TILE = 1 << 14
# the state dtypes the kernel reads and writes in place, by their bytes
_BYTES = {torch.bool: 1, torch.int32: 4, torch.int64: 8}


def _lib():
    return build.library("fastrak_fsm", _SIGNATURES)


def scratch(rows: int, n: int, tile: int, dev):
    """The kernel's scratch for rows of ``n`` samples as one int32 buffer,
    and each part's offset in it (ints) by the C entry point's argument
    names: the candidates (two int32 each, first, so 8-byte aligned), hit
    words and the hits before each word in its tile, hits a tile and their
    prefix, each candidate's successor, the candidates and the chain's
    frames a row."""
    k = -(-n // tile)
    words = k * tile // 32
    sizes = dict(cand=rows * k * tile * 2, hw=rows * words,
                 wpre=rows * words, cnt=rows * k, tp=rows * (k + 1),
                 next=rows * k * tile, stats=2 * rows)
    offs, at = {}, 0
    for name, size in sizes.items():
        offs[name] = at
        at += size
    return torch.empty(at, dtype=torch.int32, device=dev), offs


def _fields(ts):
    """ctypes arrays of the twelve fields' pointers and element bytes."""
    return ((ctypes.c_void_p * 12)(*(t.data_ptr() for t in ts)),
            (ctypes.c_int * 12)(*(_BYTES[t.dtype] for t in ts)))


def _launch(lib, metric, sync, state, threshold, oversampling, tile,
            stream):
    """The launch on contiguous [B, n] rows: the state's fields read where
    they lie (bool, int32 or int64; others as int64) and the new state
    written into three buffers (int32 fields, the uint32 fields as int64,
    compute_crc as bool), so that no conversion runs on the card. Returns
    (events, counts, the new state, [2, B] candidates and chain frames)
    and raises on a CUDA error."""
    rows, n = metric.shape
    dev = metric.device
    thr = threshold.to(torch.float32).reshape(-1).contiguous()
    ins = []
    for k in FT_FIELDS:
        v = state[k].reshape(rows)
        ins.append((v if v.dtype in _BYTES else v.to(torch.int64))
                   .contiguous())
    wide = torch.empty(len(FT_U32), rows, dtype=torch.int64, device=dev)
    narrow = torch.empty(len(FT_FIELDS) - len(FT_U32) - 1, rows,
                         dtype=torch.int32, device=dev)
    flag = torch.empty(rows, dtype=torch.bool, device=dev)
    it_w, it_n = iter(wide), iter(narrow)
    new = {k: flag if k == "compute_crc" else
           next(it_w) if k in FT_U32 else next(it_n) for k in FT_FIELDS}
    events = torch.empty(rows, MAX_EVENTS, 3, dtype=torch.float32, device=dev)
    n_ev = torch.empty(rows, dtype=torch.int32, device=dev)
    buf, offs = scratch(rows, n, tile, dev)
    base = buf.data_ptr()
    in_p, in_b = _fields(ins)
    out_p, out_b = _fields([new[k] for k in FT_FIELDS])
    err = lib.fastrak_fsm(
        metric.data_ptr(), sync.data_ptr(), n, rows, thr.data_ptr(),
        int(thr.numel() > 1), in_p, in_b, events.data_ptr(),
        n_ev.data_ptr(), out_p, out_b, int(oversampling), int(tile),
        *(base + 4 * offs[k] for k in ("hw", "wpre", "cnt", "tp", "cand",
                                       "next", "stats")), stream)
    build.check(err, "fastrak_fsm")
    stats = buf[offs["stats"]:offs["stats"] + 2 * rows].view(2, rows)
    return events, n_ev, new, stats


def fastrak_fsm_kernel(metric: torch.Tensor, sync: torch.Tensor,
                       state: dict, threshold: torch.Tensor,
                       oversampling: int, *, tile: int = TILE):
    """Launch the CUDA kernel: ``metric`` and ``sync`` [B, n] float32 on
    the card, ``state`` [B] tensors on it, ``threshold`` [B] or [1]. The
    sync hits (the candidates) and the chain's frames, per row, are left on
    the card in ``fastrak_fsm.last_candidates`` and ``.last_frames`` (no
    sync here)."""
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
    if not 128 <= tile <= MAX_TILE or tile % 128 or oversampling < 1:
        raise ValueError(f"tile {tile} or oversampling {oversampling} not "
                         "taken")
    if threshold.numel() not in (1, rows):
        raise ValueError(f"threshold of {threshold.numel()} values for "
                         f"{rows} rows")
    for k, v in list(state.items()) + [("threshold", threshold)]:
        if v.device != metric.device:
            raise ValueError(f"{k} must lie on {metric.device}, not "
                             f"{v.device}")
    events, n_ev, new, stats = _launch(
        _lib(), metric.contiguous(), sync.contiguous(), state, threshold,
        oversampling, tile, torch.cuda.current_stream(metric.device)
        .cuda_stream)
    fastrak_fsm.launches += 1
    fastrak_fsm.last_candidates, fastrak_fsm.last_frames = stats
    return events, n_ev, new


def fastrak_fsm(metric: torch.Tensor, sync: torch.Tensor, state: dict,
                threshold: torch.Tensor, oversampling: int, **launch):
    """The kernel for rows on the card, the plain version for rows on the
    CPU (``launch``: the kernel's tile)."""
    if metric.is_cuda:
        return fastrak_fsm_kernel(metric, sync, state, threshold,
                                  oversampling, **launch)
    return fastrak_fsm_plain(metric, sync, state, threshold, oversampling)


fastrak_fsm.launches = 0
fastrak_fsm.last_candidates = None
fastrak_fsm.last_frames = None
