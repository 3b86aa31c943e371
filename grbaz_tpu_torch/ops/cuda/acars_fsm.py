"""The ACARS decoder's FSM: CUDA kernel (``csrc/acars_fsm.cu``) and its
plain version.

Replaces the per-sample ``lax.scan`` of ``ACARSDecoder.apply``
(``grbaz_tpu/ops/decode.py:204``). :func:`acars_fsm` walks each row of
``metrics`` [B, n] as an independent stream from the [B] state fields of
:data:`.decode.ACARS_FIELDS` and the [B, 252] packets being assembled,
and returns (packets [B, 4, 254] float32, packet count [B] int32, the new
state). On the card it launches the kernel, one thread a row walking
serially, each row's packet bytes written into its new state as they
complete; on the CPU it runs :func:`.decode.acars_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.core.device import U32_MASK
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.decode import (ACARS_FIELDS, ACARS_MAX_PACKET,
                                        ACARS_MAX_PKTS, acars_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {"acars_fsm": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P],
               "acars_chain_probe": [_I, _P, _P]}


def _lib():
    return build.library("acars_fsm", _SIGNATURES)


def _launch(lib, metrics, state, threshold, stream):
    """Prepare the arguments, call ``lib.acars_fsm`` and unpack its
    outputs (tensors on ``metrics``'s device; ``lib`` the card's library or
    a CPU rehearsal's)."""
    rows, n = metrics.shape
    dev = metrics.device
    metrics = metrics.contiguous()
    # uint32 fields go in as their bits: int64 values above 2^31 wrap
    sin = torch.stack([state[k].reshape(rows).to(torch.int64).to(torch.int32)
                       for k in ACARS_FIELDS]).contiguous()
    pkt_in = state["pkt"].to(torch.float32).contiguous()
    out = torch.empty(rows, ACARS_MAX_PKTS, 2 + ACARS_MAX_PACKET,
                      dtype=torch.float32, device=dev)
    n_pk = torch.empty(rows, dtype=torch.int32, device=dev)
    sout = torch.empty_like(sin)
    pkt_out = torch.empty_like(pkt_in)
    err = lib.acars_fsm(
        metrics.data_ptr(), n, rows, sin.data_ptr(), pkt_in.data_ptr(),
        int(threshold), out.data_ptr(), n_pk.data_ptr(), sout.data_ptr(),
        pkt_out.data_ptr(), stream)
    build.check(err, "acars_fsm")
    new = {}
    for name, v in zip(ACARS_FIELDS, sout):
        new[name] = (v.to(torch.int64) & U32_MASK) if name == "shift" else v
    new["searching"] = new["searching"] != 0
    new["got_etx"] = new["got_etx"] != 0
    new["pkt"] = pkt_out
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


def chain_step_ns(steps: int = 1 << 20) -> float:
    """(Benchmark hook.) ns of a searching step of the FSM alone (the source's
    ``acars_chain_probe``, its inputs from shared memory) on one thread
    of the current card."""
    return build.chain_step_ns(_lib(), "acars_chain_probe", steps)
