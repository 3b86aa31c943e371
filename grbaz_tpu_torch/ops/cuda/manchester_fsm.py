"""The Manchester decoder's FSM: CUDA kernel (``csrc/manchester_fsm.cu``)
and its plain version.

Replaces the per-sample ``lax.scan`` of ``ManchesterDecode.apply``
(``grbaz_tpu/ops/decode.py:104``). :func:`manchester_fsm` walks each row
of ``bits`` [B, n] as an independent stream from the [B] state fields of
:data:`.decode.MAN_FIELDS`, emitting only before each row's ``count``, and
returns (bits [B, n // 2 + 1] uint8, emitted [B] int32, the new state). On
the card it launches the kernel (one launch a call), a block a row walking
chunks of the row over the decoder's state classes and composing them;
on the CPU it runs :func:`.decode.manchester_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.decode import MAN_FIELDS, manchester_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
# the state's fields as the block keeps them, each passed by its pointer
DTYPES = dict(phase=torch.int32, prev=torch.int32, viol_hist=torch.int64,
              hist_len=torch.int32)


class _Fields(ctypes.Structure):
    _fields_ = [(k, _P) for k in MAN_FIELDS]

_SIGNATURES = {"manchester_fsm": [_P, _P, _I, _I, _I, _Fields, _P, _P,
                                  _Fields, _I, _I, _I, _I, _P],
               "manchester_chain_probe": [_I, _P, _P],
               "manchester_compose_probe": [_I, _P, _P]}
# chunks of 256 samples a segment (the source's kMaxSegChunks): a segment
# is staged, walked and composed at once
SEG_CHUNKS = 64
CHUNK = 256
HEAD = 64


def _lib():
    return build.library("manchester_fsm", _SIGNATURES)


def _launch(lib, bits, count, state, original, window, threshold, stream,
            seg_chunks=SEG_CHUNKS):
    """Prepare the arguments, call ``lib.manchester_fsm`` and unpack its
    outputs (tensors on ``bits``'s device; ``lib`` the card's library or
    a CPU rehearsal's, which passes fewer ``seg_chunks`` to cross
    segments at small n)."""
    rows, n = bits.shape
    dev = bits.device
    x = bits if bits.dtype == torch.uint8 else (bits != 0).to(torch.uint8)
    x = x.contiguous()
    cnt = count.to(torch.int32).reshape(-1).contiguous()
    # each field in place (a cast only if it is not the block's type)
    fin = {k: state[k].reshape(rows).to(DTYPES[k]).contiguous()
           for k in MAN_FIELDS}
    new = {k: torch.empty(rows, dtype=DTYPES[k], device=dev)
           for k in MAN_FIELDS}
    out = torch.empty(rows, n // 2 + 1, dtype=torch.uint8, device=dev)
    n_out = torch.empty(rows, dtype=torch.int32, device=dev)
    err = lib.manchester_fsm(
        x.data_ptr(), cnt.data_ptr(), int(cnt.numel() > 1), n, rows,
        _Fields(*(fin[k].data_ptr() for k in MAN_FIELDS)), out.data_ptr(),
        n_out.data_ptr(), _Fields(*(new[k].data_ptr() for k in MAN_FIELDS)),
        int(original), int(window), int(threshold), int(seg_chunks), stream)
    build.check(err, "manchester_fsm")
    return out, n_out, new


def manchester_fsm_kernel(bits: torch.Tensor, count: torch.Tensor,
                          state: dict, original: bool, window: int,
                          threshold: int):
    """Launch the CUDA kernel: ``bits`` [B, n] (any integer or bool type,
    nonzero = 1), ``count`` [B] or [1] int32 and ``state`` [B] tensors, all
    on one card."""
    if bits.dim() != 2 or bits.is_floating_point() or bits.is_complex():
        raise TypeError(f"bits must be [B, n] integers, not {bits.dtype} "
                        f"{tuple(bits.shape)}")
    if not bits.is_cuda:
        raise ValueError("bits must lie on a CUDA device")
    rows, n = bits.shape
    if n < 1 or n >= 2 ** 31 or rows < 1 or rows >= 2 ** 31:
        raise ValueError(f"rows of shape {tuple(bits.shape)} are not walkable")
    if not 1 <= window <= 31:
        raise ValueError(f"window {window} not in [1, 31]")
    if count.numel() not in (1, rows):
        raise ValueError(f"count must hold 1 or {rows} values, not "
                         f"{count.numel()}")
    for k, v in list(state.items()) + [("count", count)]:
        if v.device != bits.device:
            raise ValueError(f"{k} must lie on {bits.device}, not {v.device}")
    out = _launch(_lib(), bits, count, state, original, window, threshold,
                  torch.cuda.current_stream(bits.device).cuda_stream)
    manchester_fsm.launches += 1
    return out


def manchester_fsm(bits: torch.Tensor, count: torch.Tensor, state: dict,
                   original: bool, window: int, threshold: int):
    """The kernel for rows on the card, the plain version for rows on the
    CPU."""
    if bits.is_cuda:
        return manchester_fsm_kernel(bits, count, state, original, window,
                                     threshold)
    return manchester_plain(bits, count, state, original, window, threshold)


manchester_fsm.launches = 0


def chain_step_ns(steps: int = 1 << 20) -> float:
    """(Benchmark hook.) ns of a step of the pair FSM alone (the source's
    ``manchester_chain_probe``, its inputs from shared memory; the head's
    step) on one thread of the current card."""
    return build.chain_step_ns(_lib(), "manchester_chain_probe", steps)


def compose_step_ns(steps: int = 1 << 20) -> float:
    """(Benchmark hook.) ns of one dependent map lookup in shared memory
    (the source's ``manchester_compose_probe``; the composition's step, one
    a chunk) on one thread of the current card."""
    return build.chain_step_ns(_lib(), "manchester_compose_probe", steps)
