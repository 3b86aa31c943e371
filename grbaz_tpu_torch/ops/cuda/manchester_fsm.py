"""The Manchester decoder's FSM: CUDA kernel (``csrc/manchester_fsm.cu``)
and its plain version.

Replaces the per-sample ``lax.scan`` of ``ManchesterDecode.apply``
(``grbaz_tpu/ops/decode.py:104``). :func:`manchester_fsm` walks each row
of ``bits`` [B, n] as an independent stream from the [B] state fields of
:data:`.decode.MAN_FIELDS`, emitting only before each row's ``count``, and
returns (bits [B, n // 2 + 1] uint8, emitted [B] int32, the new state). On
the card it launches the kernel, one thread a row walking serially and
writing each emission at its own running count; on the CPU it runs
:func:`.decode.manchester_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.core.device import U32_MASK
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.decode import MAN_FIELDS, manchester_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {"manchester_fsm": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                                  _P],
               "manchester_chain_probe": [_I, _P, _P]}


def _lib():
    return build.library("manchester_fsm", _SIGNATURES)


def _launch(lib, bits, count, state, original, window, threshold, stream):
    """Prepare the arguments, call ``lib.manchester_fsm`` and unpack its
    outputs (tensors on ``bits``'s device; ``lib`` the card's library or
    a CPU rehearsal's)."""
    rows, n = bits.shape
    dev = bits.device
    x = bits if bits.dtype == torch.uint8 else (bits != 0).to(torch.uint8)
    x = x.contiguous()
    cnt = count.to(torch.int32).reshape(-1).expand(rows).contiguous()
    # uint32 fields go in as their bits: int64 values above 2^31 wrap
    sin = torch.stack([state[k].reshape(rows).to(torch.int64).to(torch.int32)
                       for k in MAN_FIELDS]).contiguous()
    out = torch.empty(rows, n // 2 + 1, dtype=torch.uint8, device=dev)
    n_out = torch.empty(rows, dtype=torch.int32, device=dev)
    sout = torch.empty_like(sin)
    err = lib.manchester_fsm(
        x.data_ptr(), cnt.data_ptr(), n, rows, sin.data_ptr(),
        out.data_ptr(), n_out.data_ptr(), sout.data_ptr(), int(original),
        int(window), int(threshold),
        stream)
    build.check(err, "manchester_fsm")
    new = {}
    for name, v in zip(MAN_FIELDS, sout):
        new[name] = (v.to(torch.int64) & U32_MASK) if name == "viol_hist" \
            else v
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
    ``manchester_chain_probe``, its inputs from shared memory) on one
    thread of the current card."""
    return build.chain_step_ns(_lib(), "manchester_chain_probe", steps)
