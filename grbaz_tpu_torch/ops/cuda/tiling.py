"""Launch geometry of the polyphase FIR kernels (``csrc/polyphase_fir.cuh``).

Plain Python, chosen on the host and passed to the kernel as a
:class:`Geometry`, so the CPU tests can check it: every output covered
exactly once, the rows a lane group reads inside its plane, the shared
memory within a block's 227 KB.

A lane group of ``split`` lanes owns ``r`` consecutive outputs, so a
block of ``threads`` lanes owns a tile of ``threads // split * r``
outputs and stages ``rows = tile + mp - 1`` polyphase rows of ``decim``
samples, phase-planar (``mp``: the taps of one phase, padded with zero
taps to a multiple of ``r``). Every tile has its own block. The kernel
works out the tile, the plane stride and the shared memory from the
geometry itself (``polyphase_fir.cuh: layout``); the functions below
mirror that only to choose a geometry that fits.

Two regimes, told apart by whether the card gets two 256-output tiles
per SM:

* memory-bound (the channel shapes, 2^20 samples in): 256 threads, lane
  groups of 4 lanes with windows of 8 outputs, tiles of 512 outputs,
  every block resident at once;
* latency-bound (the ``audio_aa`` shape, 16384 outputs): windows of 4
  outputs shared by 8 lanes, tiles of 64 outputs: as many warps in
  flight as the outputs allow.

Taps too many for shared memory halve the threads, then the window.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

SMEM_PER_BLOCK = 232448   # 227 KB, the most one block may opt into
MAX_THREADS = 256         # polyphase_fir.cuh: MAX_THREADS
WAVEFRONT_BYTES = 128     # shared memory serves 32 banks x 4 bytes a pass


class Geometry(ctypes.Structure):
    """Mirror of ``pfir::Geometry``, passed to the kernels by value."""

    _fields_ = [(name, ctypes.c_int) for name in ("threads", "r", "split")]

    def __repr__(self):
        return (f"Geometry(threads={self.threads}, r={self.r}, "
                f"split={self.split})")


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def tile_outputs(threads: int, r: int, split: int) -> int:
    return threads // split * r


def row_slot(row: int, r: int) -> int:
    """Plane slot of tile row ``row``: a padding slot after every ``r``
    rows when ``r`` is even (``polyphase_fir.cuh: row_slot``)."""
    return row + row // r if r % 2 == 0 else row


def plane_stride(rows: int, r: int, split: int, sample_bytes: int) -> int:
    """The smallest plane stride that holds ``rows`` rows and puts the
    ``split`` lanes of a group on other banks than the warp's other
    groups: ``P = (W/split) * Q mod W``, with ``Q`` the groups' slot
    stride and ``W`` the samples one shared-memory wavefront serves."""
    q = r + 1 if r % 2 == 0 else r
    w = WAVEFRONT_BYTES // sample_bytes
    want = (w // split) * q % w
    p = row_slot(rows - 1, r) + 1
    return p + (want - p) % w


def taps_per_phase(tpad: int, decim: int, r: int) -> int:
    """The kernel pads each phase's ``tpad // decim`` taps with zeros to a
    multiple of ``r``, so its dot runs whole ``r``-step chunks."""
    return -(-(tpad // decim) // r) * r


def tap_stride(mp: int) -> int:
    """Shared-memory stride of one phase's taps: ``mp`` rounded up to 2
    mod 4 (``polyphase_fir.cuh: tap_stride``), so the lanes of a group
    read their phases' taps from distinct banks."""
    return mp + (2 - mp) % 4


def tile_rows(threads, r, split, tpad, decim) -> int:
    return tile_outputs(threads, r, split) + taps_per_phase(tpad, decim, r) - 1


def smem_bytes(geo: Geometry, tpad, decim, sample_bytes, tap_bytes) -> int:
    """The kernel's dynamic shared memory: ``decim`` planes of samples,
    then the taps phase-major."""
    rows = tile_rows(geo.threads, geo.r, geo.split, tpad, decim)
    plane = plane_stride(rows, geo.r, geo.split, sample_bytes)
    return (decim * plane * sample_bytes
            + decim * tap_stride(taps_per_phase(tpad, decim, geo.r))
            * tap_bytes)


@functools.lru_cache(maxsize=256)
def geometry(n_out: int, tpad: int, decim: int, sample_bytes: int,
             tap_bytes: int, num_sms: int) -> Geometry:
    """The launch geometry for ``n_out`` outputs of a ``tpad``-tap,
    decimate-by-``decim`` FIR over samples of ``sample_bytes`` (4 or 8)
    with taps of ``tap_bytes`` on a card of ``num_sms`` SMs. Cached: a
    chain launches the same shapes every step, and the result is shared,
    so callers must not change it."""
    if decim < 1 or tpad < decim or tpad % decim:
        raise ValueError("taps must be padded to a multiple of decim")
    max_split = min(8, _pow2_floor(decim))
    if -(-max(n_out, 1) // 256) >= 2 * num_sms:
        geo = Geometry(threads=256, r=8, split=min(4, max_split))
    else:
        geo = Geometry(threads=128, r=4, split=max_split)
    geo.r = min(geo.r, _pow2_floor(tpad // decim))
    while smem_bytes(geo, tpad, decim, sample_bytes,
                     tap_bytes) > SMEM_PER_BLOCK:
        if geo.threads > 32:
            geo.threads //= 2
        elif geo.r > 1:
            geo.r //= 2
        else:
            raise ValueError(f"{tpad} taps do not fit in shared memory")
    return geo


def output_counts(geo: Geometry, n_out: int) -> np.ndarray:
    """How many times the kernel stores each output under ``geo``: the
    mapping of ``polyphase_fir_kernel`` (block b computes tile b; lane
    ``tid`` is lane ``tid % split`` of group ``tid // split`` and stores
    the group's outputs ``i`` with ``i % split`` equal to its lane)."""
    tile = tile_outputs(geo.threads, geo.r, geo.split)
    counts = np.zeros(n_out, np.int64)
    tid = np.arange(geo.threads)
    g, s = tid // geo.split, tid % geo.split
    for t in range(-(-n_out // tile)):
        for i in range(geo.r):
            k = t * tile + g * geo.r + i
            k = k[(i % geo.split == s) & (k < n_out)]
            np.add.at(counts, k, 1)
    return counts


@functools.lru_cache(maxsize=None)
def num_sms(device_index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def for_tensor(t, n_out: int, tpad: int, decim: int,
               tap_bytes: int) -> Geometry:
    """:func:`geometry` for samples of ``t``'s type on ``t``'s card."""
    return geometry(n_out, tpad, decim, t.element_size(), tap_bytes,
                    num_sms(t.device.index if t.device.index is not None
                            else 0))
