"""The Viterbi decoder: CUDA kernel (``csrc/viterbi.cu``) and its plain
version.

Replaces the add-compare-select and traceback scans of ``viterbi_decode``
(``grbaz_tpu/ops/fec.py:244``, scans at ``:268`` and ``:276``).
:func:`viterbi` decodes ``metrics`` [T, 2] float32 soft pairs with the
trellis ``exp`` [ns, 2, 2] (``fec.expected_outputs``: every entry +-1, any
pair of polynomials, any K >= 2) and returns (bits [T] uint8, final path
metrics [ns] float32). On the card it launches the kernel: the forward
pass on one warp up to K = 9 (shuffles, one ``redux.sync`` max a step,
the decisions stored 32 steps at a time) or one block from K = 10 (the
metrics double-buffered in shared memory up to K = 15, in a global work
area beyond), then a traceback cut into chunks of :data:`TRACE_CHUNK`
steps: every chunk's map from end state to start state in parallel, the
maps composed from the best final state, every chunk's bits in parallel.
On the CPU it runs :func:`.fec.viterbi_plain`. Bits and path metrics are
bit-equal.
"""

from __future__ import annotations

import ctypes

import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.fec import viterbi_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_SIGNATURES = {"viterbi": [_P, _L, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
               "viterbi_chain_probe": [_I, _P, _P]}
MAX_K = 30             # 2^29 states: the kernel's state indices are int32
TRACE_CHUNK = 512      # steps a traceback chunk (a multiple of 32)
SMEM_STATES = 1 << 14  # the block form keeps its metrics in shared memory


def _lib():
    return build.library("viterbi", _SIGNATURES)


def scratch_bytes(t_len: int, ns: int, chunk: int = TRACE_CHUNK) -> int:
    """Device bytes of one decode's outputs and scratch: the decisions
    (T * ns / 8 bytes, whole groups of 32 steps, at least a word a
    step), the chunks' maps, the bits and path metrics, and the work area
    of more than 2^14 states."""
    words = max(ns // 32, 1)
    dec = -(-t_len // 32) * 32 * words * 4
    maps = -(-t_len // chunk) * ns * 4
    work = 17 * ns // 2 if ns > SMEM_STATES else 0
    return dec + maps + work + t_len + 4 * ns + 4


def _launch(lib, metrics, exp, stream, chunk=TRACE_CHUNK):
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
    decisions = torch.empty(-(-t_len // 32) * 32 * words, dtype=torch.int32,
                            device=dev)
    maps = torch.empty(-(-t_len // chunk), ns, dtype=torch.int32, device=dev)
    best = torch.empty(1, dtype=torch.int32, device=dev)
    work = torch.empty(17 * ns // 2 if ns > SMEM_STATES else 0,
                       dtype=torch.uint8, device=dev)
    err = lib.viterbi(metrics.data_ptr(), t_len, exp.data_ptr(),
                      ns.bit_length(), chunk, bits.data_ptr(), pm.data_ptr(),
                      decisions.data_ptr(), maps.data_ptr(), best.data_ptr(),
                      work.data_ptr() if work.numel() else None, stream)
    build.check(err, "viterbi")
    return bits, pm


def viterbi_kernel(metrics: torch.Tensor, exp: torch.Tensor):
    """Launch the CUDA kernel on ``metrics`` [T, 2] float32 and ``exp``
    [ns, 2, 2] float32 (entries +-1; the kernel reads their signs) on one
    card."""
    if metrics.dtype != torch.float32 or metrics.dim() != 2 or \
            metrics.shape[1] != 2:
        raise TypeError(f"metrics must be [T, 2] float32, not {metrics.dtype} "
                        f"{tuple(metrics.shape)}")
    if not metrics.is_cuda:
        raise ValueError("metrics must lie on a CUDA device")
    ns = exp.shape[0] if exp.dim() else 0
    k = ns.bit_length()
    if ns < 2 or ns != 1 << (k - 1) or k > MAX_K:
        raise ValueError(f"exp must hold 2^(K-1) states for K from 2 to "
                         f"{MAX_K}, not {ns}")
    if exp.dtype != torch.float32 or tuple(exp.shape) != (ns, 2, 2) or \
            exp.device != metrics.device:
        raise ValueError(f"exp must be [{ns}, 2, 2] float32 on "
                         f"{metrics.device}")
    t_len = metrics.shape[0]
    need = scratch_bytes(t_len, ns)
    have = torch.cuda.get_device_properties(metrics.device).total_memory
    if need > have:
        raise ValueError(f"{t_len} steps at K = {k} need {need} bytes of "
                         f"decisions and scratch: more than the card's "
                         f"{have}")
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
    """(Benchmark hook.) ns of the minimal add-compare-select step of the
    warp at K = 7 (the source's ``viterbi_chain_probe``: the shuffles, the
    subtract, add and select, one ``redux.sync`` max; register-held
    metrics, no decisions stored) on the current card."""
    return build.chain_step_ns(_lib(), "viterbi_chain_probe", steps)
