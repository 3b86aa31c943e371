"""The ACARS decoder's FSM: CUDA kernel (``csrc/acars_fsm.cu``) and its
plain version.

Replaces the per-sample ``lax.scan`` of ``ACARSDecoder.apply``
(``grbaz_tpu/ops/decode.py:204``). :func:`acars_fsm` walks each row of
``metrics`` [B, n] as an independent stream from the [B] state fields of
:data:`.decode.ACARS_FIELDS` and the [B, 252] packets being assembled,
and returns (packets [B, 4, 254] float32, packet count [B] int32, the new
state). On the card it launches the kernel (one launch a call), a block a
row staging the air bits, the preamble candidates and the running parity,
one warp walking from sync to sync, each packet decoded 32 bytes a round
up to its end, and the block writing the packets' rows; on the CPU it runs
:func:`.decode.acars_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.decode import (ACARS_FIELDS, ACARS_MAX_PACKET,
                                        ACARS_MAX_PKTS, acars_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
# the state's fields as the block keeps them, each passed by its pointer
DTYPES = dict(searching=torch.bool, shift=torch.int64, got_etx=torch.bool)


class _Fields(ctypes.Structure):
    _fields_ = [(k, _P) for k in ACARS_FIELDS]

_SIGNATURES = {"acars_fsm": [_P, _I, _I, _Fields, _P, _I, _I, _P, _P,
                              _Fields, _P, _P],
               "acars_packet_probe": [_I, _P, _P]}
# air bits a segment (the source's kMaxSeg): a segment is staged and walked
# at once
SEG = 1 << 14


def _lib():
    return build.library("acars_fsm", _SIGNATURES)


def _launch(lib, metrics, state, threshold, stream, seg=SEG):
    """Prepare the arguments, call ``lib.acars_fsm`` and unpack its
    outputs (tensors on ``metrics``'s device; ``lib`` the card's library or
    a CPU rehearsal's, which passes a shorter ``seg``, a multiple of 32, to
    cross segments at small n)."""
    rows, n = metrics.shape
    dev = metrics.device
    metrics = metrics.contiguous()
    # each field in place (a cast only if it is not the block's type)
    fin = {k: state[k].reshape(rows).to(DTYPES.get(k, torch.int32))
           .contiguous() for k in ACARS_FIELDS}
    new = {k: torch.empty(rows, dtype=DTYPES.get(k, torch.int32), device=dev)
           for k in ACARS_FIELDS}
    pkt_in = state["pkt"].to(torch.float32).contiguous()
    out = torch.empty(rows, ACARS_MAX_PKTS, 2 + ACARS_MAX_PACKET,
                      dtype=torch.float32, device=dev)
    n_pk = torch.empty(rows, dtype=torch.int32, device=dev)
    new["pkt"] = torch.empty_like(pkt_in)
    err = lib.acars_fsm(
        metrics.data_ptr(), n, rows,
        _Fields(*(fin[k].data_ptr() for k in ACARS_FIELDS)),
        pkt_in.data_ptr(), int(threshold), int(seg), out.data_ptr(),
        n_pk.data_ptr(), _Fields(*(new[k].data_ptr() for k in ACARS_FIELDS)),
        new["pkt"].data_ptr(), stream)
    build.check(err, "acars_fsm")
    return out, n_pk, new


def acars_fsm_kernel(metrics: torch.Tensor, state: dict, threshold: int):
    """Launch the CUDA kernel: ``metrics`` [B, n] float32 and ``state`` ([B]
    fields, ``pkt`` [B, 252]) on one card."""
    if metrics.dtype != torch.float32 or metrics.dim() != 2:
        raise TypeError(f"metrics must be [B, n] float32, not {metrics.dtype} "
                        f"{tuple(metrics.shape)}")
    if not metrics.is_cuda:
        raise ValueError("metrics must lie on a CUDA device")
    rows, n = metrics.shape
    if n < 1 or n >= 2 ** 31 or rows < 1 or rows >= 2 ** 31:
        raise ValueError(f"rows of shape {tuple(metrics.shape)} are not "
                         "walkable")
    for k, v in state.items():
        if v.device != metrics.device:
            raise ValueError(f"{k} must lie on {metrics.device}, not "
                             f"{v.device}")
    if tuple(state["pkt"].shape) != (rows, ACARS_MAX_PACKET):
        raise ValueError(f"pkt must be [{rows}, {ACARS_MAX_PACKET}], not "
                         f"{tuple(state['pkt'].shape)}")
    out = _launch(_lib(), metrics, state, threshold,
                  torch.cuda.current_stream(metrics.device).cuda_stream)
    acars_fsm.launches += 1
    return out


def acars_fsm(metrics: torch.Tensor, state: dict, threshold: int):
    """The kernel for rows on the card, the plain version for rows on the
    CPU."""
    if metrics.is_cuda:
        return acars_fsm_kernel(metrics, state, threshold)
    return acars_plain(metrics, state, threshold)


acars_fsm.launches = 0


def packet_ns(steps: int = 1 << 12) -> float:
    """(Benchmark hook.) ns of one packet of the walk's dependent work alone
    (the source's ``acars_packet_probe``: find the next candidate, decode
    the packet up to its end, list it; packets of the least length, 18
    bytes, one round of 32; its inputs from shared memory) on one warp of
    the current card."""
    return build.chain_step_ns(_lib(), "acars_packet_probe", steps)
