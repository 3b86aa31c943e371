"""First-order IIR (one-pole) recurrences (port of ``grbaz_tpu/ops/iir.py``).

``y[k] = a*y[k-1] + b[k]`` with a constant pole ``a`` in [0, 1] equals

    y[k] = a^(k+1) * y0 + sum_{j<=k} a^(k-j) b[j]

The sum is a prefix scan of the affine maps; with a constant pole it
runs as log2(n) doubling passes (Hillis-Steele): after the pass of
distance d every element holds the sum of its last 2d terms, each pass
adding ``a^d`` times the partial sum d places back. Every factor is a
power of a pole in [0, 1], so no pass can overflow. The JAX package
computes the same sum as chunked triangular matrix products, a layout
chosen for the TPU's matrix unit.

Validity masking: streams carry a *contiguous valid prefix*. The
recurrence is causal, so outputs in the invalid tail are don't-care and
the carried state is the value at ``count-1``.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.device import take


def onepole_scan(b: torch.Tensor, a, y0: torch.Tensor) -> torch.Tensor:
    """All-samples one-pole recurrence ``y[k] = a*y[k-1] + b[k]`` along
    dim 0.

    ``a`` is a python float or a 0-d float32 tensor (rounded to float32,
    as the JAX package does); ``y0`` is ``y[-1]``. ``b`` is [n] or, for
    a frame-to-frame average, [n, ...] with ``y0`` of its trailing shape.
    Returns float32 of ``b``'s shape.
    """
    y = b.to(torch.float32)
    n = y.shape[0]
    if n == 0:
        return y
    if not isinstance(a, torch.Tensor):
        a = float(np.float32(a))
    exps = torch.arange(1, n + 1, dtype=torch.float32, device=y.device)
    a_pows = torch.pow(a, exps).reshape((n,) + (1,) * (y.dim() - 1))
    ad, d = a, 1
    while d < n:
        y = torch.cat([y[:d], y[d:] + ad * y[:-d]])
        ad = ad * ad
        d *= 2
    return y + a_pows * y0.to(torch.float32)


def onepole_lowpass(x: torch.Tensor, alpha, y0: torch.Tensor) -> torch.Tensor:
    """Single-pole lowpass ``y[k] = (1-alpha)*y[k-1] + alpha*x[k]``."""
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.tensor(np.float32(alpha), device=x.device)
    alpha = alpha.to(torch.float32)
    return onepole_scan(x.to(torch.float32) * alpha, 1.0 - alpha, y0)


def state_at_count(y: torch.Tensor, count: torch.Tensor,
                   fallback: torch.Tensor) -> torch.Tensor:
    """Carried state for a count-prefix stream: ``y[count-1]``, or the
    previous state when the block carried no valid samples."""
    idx = torch.clamp(count - 1, 0, y.shape[0] - 1)
    return torch.where(count > 0, take(y, idx), fallback)
