"""Device selection and the uint32-in-int64 convention.

Torch on the CPU raises ``NotImplementedError`` for add, shift, compare
and arange on ``torch.uint32``. The port therefore carries every uint32
quantity (turn phases, 32.32 fractional positions, stream limbs) in an
int64 tensor masked with ``U32_MASK`` after each operation. Products of
two values below 2^32 stay below 2^64; where one could exceed 2^63 it
wraps modulo 2^64 in int64, which still leaves the low 32 bits exact.
Inside CUDA kernels the same values are native ``uint32_t``.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    the machine has no usable card (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch versions")
    return dev


def scalar(value, dtype, device) -> torch.Tensor:
    """0-d tensor on ``device`` made by a fill, not a host copy, so that
    creating it never waits for the card."""
    return torch.full((), value, dtype=dtype, device=device)


def take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for a 0-d device index tensor, without a host sync
    (plain indexing with a 0-d tensor reads it back to the host)."""
    return x.index_select(0, index.reshape(1).long()).reshape(x.shape[1:])
