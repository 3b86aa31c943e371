"""Rotated-taps helpers of the fused WBFM front end (port of the plain
functions of ``grbaz_tpu/ops/pallas/wbfm_frontend.py``).

The frequency-translating FIR folds its LO into complex taps

    g[t] = h_rev[t] * exp(j*ang(u32((t - (tpad-1)) * lo_inc)))

and leaves its decimated output UNROTATED: the channelizer's output is
``yf[k] * exp(j*ang(u32(phase0 + k*decim*lo_inc)))``. The FM
discriminator never needs that rotation: it advances by the constant
``delta = ang(u32(decim*lo_inc))`` per output, which
:func:`demod_unrotated` adds to the phase difference.

uint32 values are int64 tensors masked to 32 bits (``core.device``).
The JAX file's ``packed_tap_matrix``, ``_align_bands`` and ``_pick_tile2``
are Mosaic layout machinery and have no counterpart here; the product
itself is ``ops.fir.fir_decimate_frame_ctaps`` or the CUDA kernel of
``ops/cuda/xlating_fir_ctaps.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.device import U32_MASK
from grbaz_tpu_torch.ops import exact

# float32 constants, rounded as the JAX package rounds jnp.float32(...)
_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))


def rotated_taps(h_rev_pad: torch.Tensor, lo_inc: torch.Tensor) -> torch.Tensor:
    """Complex taps ``g[t] = h_rev[t] * exp(j*ang((t - (tpad-1)) * lo_inc))``
    with the same uint32 turn arithmetic as the JAX function."""
    tpad = h_rev_pad.shape[0]
    t_idx = torch.arange(tpad, dtype=torch.int64, device=h_rev_pad.device)
    ang = exact.turns_u32_to_radians(((t_idx - (tpad - 1)) * lo_inc)
                                     & U32_MASK)
    return h_rev_pad.to(torch.float32) * torch.complex(torch.cos(ang),
                                                       torch.sin(ang))


def rotate_output(yf: torch.Tensor, phase0: torch.Tensor,
                  lo_inc: torch.Tensor, decim: int) -> torch.Tensor:
    """Apply the deferred output rotation ``exp(j*ang(phase0 + k*decim*inc))``."""
    k = torch.arange(yf.shape[0], dtype=torch.int64, device=yf.device)
    ph = (phase0 + k * ((decim * lo_inc) & U32_MASK)) & U32_MASK
    ang = exact.turns_u32_to_radians(ph)
    return yf * torch.complex(torch.cos(ang), torch.sin(ang))


def demod_unrotated(yf: torch.Tensor, prev_yf: torch.Tensor, gain,
                    lo_inc: torch.Tensor, decim: int) -> tuple:
    """FM quadrature demod of the ROTATED signal from the unrotated
    output: ``arg(Y[k] conj(Y[k-1])) = wrap(arg(yf[k] conj(yf[k-1])) + delta)``.

    ``delta`` is mapped into (-pi, pi] so one wrap each way suffices; a
    zero product (squelch-gated samples) gives 0, as ``atan2(0, 0)`` of
    the rotated product would. Returns ``(d[n_out] float32, yf[-1])``.
    """
    delta = exact.turns_u32_to_radians((decim * lo_inc) & U32_MASK)
    delta = delta - torch.where(delta > _PI, _TWO_PI, 0.0)
    shifted = torch.cat([prev_yf.reshape(1), yf[:-1]])
    prod = yf * torch.conj(shifted)
    theta = torch.atan2(prod.imag, prod.real) + delta
    theta = theta - torch.where(theta > _PI, _TWO_PI, 0.0)
    theta = theta + torch.where(theta < -_PI, _TWO_PI, 0.0)
    theta = torch.where((prod.real == 0) & (prod.imag == 0),
                        torch.zeros_like(theta), theta)
    return theta.to(torch.float32) * gain, yf[-1]
