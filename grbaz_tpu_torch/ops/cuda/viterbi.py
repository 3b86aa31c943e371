"""The Viterbi decoder: CUDA kernel (``csrc/viterbi.cu``) and its plain
version.

Replaces the add-compare-select and traceback scans of ``viterbi_decode``
(``grbaz_tpu/ops/fec.py:244``, scans at ``:268`` and ``:276``).
:func:`viterbi` decodes ``metrics`` [T, 2] float32 soft pairs with the
trellis ``exp`` [ns, 2, 2] (``fec.expected_outputs``) and returns (bits
[T] uint8, final path metrics [ns] float32). On the card it launches the
kernel, one warp a stream: each lane holds ns / 32 states (or one, for
fewer than 32), predecessor metrics come by shuffles, every step is
normalised by the warp's max, the decisions go to a global buffer as
ballots, and one lane traces back from staged chunks of them. On the CPU
it runs :func:`.fec.viterbi_plain`. Bits and path metrics are bit-equal.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.fec import viterbi_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {"viterbi": [_P, _I, _P, _I, _P, _P, _P, _P],
               "viterbi_chain_probe": [_I, _P, _P]}
MIN_K, MAX_K = 3, 9   # 4 to 256 states: at most 8 a lane


def _lib():
    return build.library("viterbi", _SIGNATURES)


def _launch(lib, metrics, exp, stream):
    """Prepare the arguments, call ``lib.viterbi`` and unpack its
    outputs (tensors on ``metrics``'s device; ``lib`` the card's library or
    a CPU rehearsal's)."""
    t_len, ns = metrics.shape[0], exp.shape[0]
    dev = metrics.device
    metrics, exp = metrics.contiguous(), exp.contiguous()
    if metrics.data_ptr() % 8:     # the kernel reads float2 pairs
        metrics = metrics.clone()
    bits = torch.empty(t_len, dtype=torch.uint8, device=dev)
    pm = torch.empty(ns, dtype=torch.float32, device=dev)
    words = max(ns // 32, 1)
    decisions = torch.empty(t_len, words, dtype=torch.int32, device=dev)
    err = lib.viterbi(metrics.data_ptr(), t_len, exp.data_ptr(),
                      ns.bit_length(), bits.data_ptr(), pm.data_ptr(),
                      decisions.data_ptr(), stream)
    build.check(err, "viterbi")
    return bits, pm


def viterbi_kernel(metrics: torch.Tensor, exp: torch.Tensor):
    """Launch the CUDA kernel on ``metrics`` [T, 2] float32 and ``exp``
    [ns, 2, 2] float32 on one card."""
    if metrics.dtype != torch.float32 or metrics.dim() != 2 or \
            metrics.shape[1] != 2:
        raise TypeError(f"metrics must be [T, 2] float32, not {metrics.dtype} "
                        f"{tuple(metrics.shape)}")
    if not metrics.is_cuda:
        raise ValueError("metrics must lie on a CUDA device")
    ns = exp.shape[0]
    k = ns.bit_length()
    if ns != 1 << (k - 1) or not MIN_K <= k <= MAX_K:
        raise ValueError(f"constraint length {k} ({ns} states) not taken: "
                         f"the kernel takes K from {MIN_K} to {MAX_K}")
    if exp.dtype != torch.float32 or tuple(exp.shape) != (ns, 2, 2) or \
            exp.device != metrics.device:
        raise ValueError(f"exp must be [{ns}, 2, 2] float32 on "
                         f"{metrics.device}")
    t_len = metrics.shape[0]
    if t_len < 1 or t_len >= 2 ** 31 // max(ns, 32):
        raise ValueError(f"{t_len} steps not taken")
    out = _launch(_lib(), metrics, exp,
                  torch.cuda.current_stream(metrics.device).cuda_stream)
    viterbi.launches += 1
    return out


def viterbi(metrics: torch.Tensor, exp: torch.Tensor):
    """The kernel for metrics on the card, the plain version for metrics
    on the CPU."""
    if metrics.is_cuda:
        return viterbi_kernel(metrics, exp)
    return viterbi_plain(metrics, exp)


viterbi.launches = 0


def chain_step_ns(steps: int = 1 << 16) -> float:
    """(Benchmark hook.) ns of one add-compare-select step of the warp at
    K = 7 alone (the source's ``viterbi_chain_probe``: register-held
    metrics, no decisions stored) on the current card."""
    return build.chain_step_ns(_lib(), "viterbi_chain_probe", steps)
