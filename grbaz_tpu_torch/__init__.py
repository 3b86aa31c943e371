"""grbaz_tpu_torch — the PyTorch/CUDA port of the grbaz_tpu software radio.

The same Block / Stream / Flowgraph contracts as :mod:`grbaz_tpu`, written
over torch tensors for one NVIDIA H100. Plain tensor code is PyTorch; the
JAX package's Pallas kernels become hand-written CUDA C++ kernels for
``sm_90a`` (``csrc/``), each with a plain PyTorch twin beside it
(``ops/cuda/``). The package imports neither JAX nor ``grbaz_tpu``.

Entry points take ``device`` and default to ``"cuda"``; asking for the
card on a machine without one raises (there is no silent CPU fallback).
Tests pass ``device="cpu"``, where every kernel wrapper runs its plain
version because the tensors it is given lie on the CPU.
"""

from grbaz_tpu_torch.core.block import Block, FnBlock, block_from_fn
from grbaz_tpu_torch.core.device import resolve_device
from grbaz_tpu_torch.core.graph import CompiledFlowgraph, Flowgraph
from grbaz_tpu_torch.core.stream import Stream, StreamMeta, stream_flags

__all__ = [
    "Block", "FnBlock", "block_from_fn", "resolve_device",
    "CompiledFlowgraph", "Flowgraph", "Stream", "StreamMeta", "stream_flags",
]
