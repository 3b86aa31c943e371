"""The served auto-FEC Block's steps beside the Viterbi decoder: CUDA
kernels (``csrc/auto_fec.cu``) and their plain twins (``ops/fec.py``).

Three entry points, one launch each, with no host sync:

* :func:`fec_pairs`: the soft pairs of [carry, block] under the search
  state's transform (plain twin :func:`.fec.fec_pairs_plain`);
* :func:`fec_ber`: the block's BER from the decoded bits and the pairs
  (:func:`.fec.fec_ber_plain`);
* :func:`fec_search`: the search's next state (:func:`.fec.fec_search_plain`).

All three are exact (sign flips, integer counts, one float32 product,
comparisons), so kernel and twin are bit-equal. On the card each
launches its kernel, on the CPU it runs the twin; ``launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.fec import (fec_ber_plain, fec_pairs_plain,
                                     fec_search_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
_D = ctypes.c_double

_SIGNATURES = {
    "fec_pairs": [_P, _I, _P, _L, _P, _P, _P, _P, _P],
    "fec_ber": [_P, _P, _I, _L, _I, _U, _U, _F, _P, _P],
    "fec_search": [_P, _P, _P, _D, _D, _P, _P],
}


def _lib():
    return build.library("auto_fec", _SIGNATURES)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(name, t, dtype, dim, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
            t.dim() != dim or t.device != device or not t.is_contiguous():
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"{name} must be a contiguous {dim}-d {dtype} "
                         f"tensor on {device}, not {got}")


def fec_pairs(carry, block, state, pick, sign):
    """``carry`` [c] and ``block`` [n] complex64, ``state`` [1] int32 (the
    search state, its transform ``state & 31``), ``pick`` [32, 2] int64 and
    ``sign`` [32, 2] float32 (by transform): the soft pairs [c - 1 + n, 2]
    float32."""
    if not block.is_cuda:
        return fec_pairs_plain(carry, block, state, pick, sign)
    dev = block.device
    for name, t, dtype, dim in (("carry", carry, torch.complex64, 1),
                                ("block", block, torch.complex64, 1),
                                ("state", state, torch.int32, 1),
                                ("pick", pick, torch.int64, 2),
                                ("sign", sign, torch.float32, 2)):
        _need(name, t, dtype, dim, dev)
    if carry.numel() < 1 or block.numel() < 1 or state.numel() != 1 \
            or pick.shape != (32, 2) or sign.shape != (32, 2):
        raise ValueError("fec_pairs needs a carry, a block, one state and "
                         "a [32, 2] pick and sign")
    ext = torch.empty(carry.numel() - 1 + block.numel(), 2,
                      dtype=torch.float32, device=dev)
    build.check(_lib().fec_pairs(
        carry.data_ptr(), carry.numel(), block.data_ptr(), block.numel(),
        state.data_ptr(), pick.data_ptr(), sign.data_ptr(), ext.data_ptr(),
        _stream(block)), "fec_pairs")
    fec_pairs.launches += 1
    return ext


def fec_ber(bits, ext, overlap: int, k: int, polys):
    """[1] float32: the BER of the decoded ``bits`` [T] uint8 against the
    pairs ``ext`` [T, 2] float32, after the first ``overlap``, all but the
    last 16; rate 1/2, constraint length ``k``."""
    if not ext.is_cuda:
        return fec_ber_plain(bits, ext, overlap, k, polys)
    dev = ext.device
    _need("bits", bits, torch.uint8, 1, dev)
    _need("ext", ext, torch.float32, 2, dev)
    n_eval = ext.shape[0] - overlap - 16
    if bits.shape[0] != ext.shape[0] or ext.shape[1] != 2 or n_eval < 1 \
            or not k - 1 <= overlap or not 1 <= k <= 32 or len(polys) != 2 \
            or ext.data_ptr() % 8:
        raise ValueError(f"fec_ber: {bits.shape[0]} bits, pairs "
                         f"{tuple(ext.shape)}, overlap {overlap}, K {k}, "
                         f"{len(polys)} generators")
    ber = torch.empty(1, dtype=torch.float32, device=dev)
    build.check(_lib().fec_ber(
        bits.data_ptr(), ext.data_ptr(), overlap, n_eval, k, int(polys[0]),
        int(polys[1]), float(np.float32(1) / np.float32(2 * n_eval)),
        ber.data_ptr(), _stream(ext)), "fec_ber")
    fec_ber.launches += 1
    return ber


def fec_search(table, state, ber, threshold: float, unlock: float):
    """The search state [1] int32 after a block of BER ``ber`` (one
    float32) from ``state`` ([1] int32), by the rule's ``table`` [4 S]
    int32."""
    if not table.is_cuda:
        return fec_search_plain(table, state, ber, threshold, unlock)
    dev = table.device
    _need("table", table, torch.int32, 1, dev)
    _need("state", state, torch.int32, 1, dev)
    _need("ber", ber.reshape(-1), torch.float32, 1, dev)
    if state.numel() != 1 or ber.numel() != 1:
        raise ValueError("fec_search takes one state and one BER")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    build.check(_lib().fec_search(
        state.data_ptr(), ber.data_ptr(), table.data_ptr(), float(threshold),
        float(unlock), out.data_ptr(), _stream(table)), "fec_search")
    fec_search.launches += 1
    return out


fec_pairs.launches = 0
fec_ber.launches = 0
fec_search.launches = 0
