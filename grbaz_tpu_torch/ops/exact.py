"""Exact long-stream phase / position arithmetic (port of
``grbaz_tpu/ops/exact.py``).

* **Turn phase** (oscillators/rotators): a uint32 in units of 2^-32
  turns; ``(phase0 + k*inc) mod 2^32`` never drifts on unbounded streams.
* **Fixed-point stream positions** (resamplers): ``p_k = mu0 + k*inc``
  in 32.32 fixed point, exact.

uint32 values live in int64 tensors masked to 32 bits (see
``core.device``): the torch CPU build has no uint32 arithmetic. Results
equal the JAX package's uint32 arithmetic bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grbaz_tpu_torch.core.device import U32_MASK

TWO32 = float(2 ** 32)
_TWO_PI = float(2.0 * np.pi)
# float32 radians per 2^-32 turn, rounded once as the JAX package does
_TO_RAD = float(np.float32(_TWO_PI / TWO32))


# ---------------------------------------------------------------------------
# host-side converters (exact, double/int precision on the host)
# ---------------------------------------------------------------------------

def freq_to_turns_u32(freq_hz: float, sample_rate: float) -> np.uint32:
    """Frequency -> uint32 phase increment in 2^-32 turns per sample."""
    turns = float(freq_hz) / float(sample_rate)
    inc = int(round((turns % 1.0) * TWO32)) % (2 ** 32)
    return np.uint32(inc)


def ratio_to_fixed(ratio: float) -> Tuple[np.int32, np.uint32]:
    """Resampling ratio (input samples per output) -> (int, 2^-32 frac)."""
    if ratio <= 0:
        raise ValueError("resampling ratio must be > 0")
    ip = int(np.floor(ratio))
    frac = int(round((float(ratio) - ip) * TWO32))
    if frac >= 2 ** 32:  # rounded up to the next integer
        ip, frac = ip + 1, 0
    return np.int32(ip), np.uint32(frac)


def ppb_to_fixed(int_part: int, frac_ppb: float) -> Tuple[np.int32, np.uint32]:
    """The ppb ratio message ``(i + frac)/1e9`` -> fixed point."""
    return ratio_to_fixed((float(int_part) + float(frac_ppb)) / 1e9)


def fixed_to_ratio(ip, frac) -> float:
    return float(int(ip)) + float(int(np.uint32(frac))) / TWO32


# ---------------------------------------------------------------------------
# device-side exact ramps
# ---------------------------------------------------------------------------

def phase_ramp_u32(n: int, phase0: torch.Tensor,
                   inc: torch.Tensor) -> torch.Tensor:
    """Exact modular phase ramp ``(phase0 + k*inc) mod 2^32``, k in [0, n).

    ``phase0`` / ``inc`` are 0-d int64 tensors holding uint32 values;
    returns int64 [n] holding uint32 values.
    """
    k = torch.arange(n, dtype=torch.int64, device=phase0.device)
    return (phase0 + k * inc) & U32_MASK


def turns_u32_to_radians(phase_u32: torch.Tensor) -> torch.Tensor:
    """uint32 turn phase -> float32 radians in [0, 2pi): the same
    round-to-nearest int->float conversion and float32 multiply as the
    JAX package."""
    return phase_u32.to(torch.float32) * torch.tensor(
        _TO_RAD, dtype=torch.float32)


def lo_at(phase0: torch.Tensor, inc: torch.Tensor, k: torch.Tensor,
          conj: bool = False) -> torch.Tensor:
    """exp(+/- j*2pi*u32(phase0 + k*inc)) at the int64 sample offsets
    ``k`` (negative offsets reach back before ``phase0``'s sample);
    ``phase0`` and ``inc`` broadcast against ``k``, so [C, 1] gives [C,
    len(k)]. complex64."""
    ang = turns_u32_to_radians((phase0 + k * inc) & U32_MASK)
    if conj:
        ang = -ang
    return torch.complex(torch.cos(ang), torch.sin(ang))


def oscillator(n: int, phase0: torch.Tensor, inc: torch.Tensor,
               conj: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(+/- j*2pi*phase) over n samples, plus the next phase0.

    Returns ``(lo[n] complex64, phase_after)``.
    """
    k = torch.arange(n, dtype=torch.int64, device=phase0.device)
    return lo_at(phase0, inc, k, conj), (phase0 + n * inc) & U32_MASK


def fixed_positions(n: int, mu_frac0: torch.Tensor, inc_int: torch.Tensor,
                    inc_frac: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact positions ``p_k = mu0 + k*inc`` in 32.32 sample fixed point.

    Returns ``(idx int64 [n], frac int64 [n] holding uint32)`` with
    ``p_k = idx_k + frac_k * 2^-32`` exactly. ``mu0 + k*inc_frac`` is
    below 2^63 for every k < 2^31, so in int64 its low word is the
    fraction and its high word the integer carries. That one closed form
    equals both of the JAX package's carry forms (16-bit limb products
    for n <= 2^16, a cumulative sum of wrap-downs above) for every n.
    """
    k = torch.arange(n, dtype=torch.int64, device=mu_frac0.device)
    full = mu_frac0.to(torch.int64) + k * inc_frac.to(torch.int64)
    frac = full & U32_MASK
    carries = full >> 32
    idx = k * inc_int.to(torch.int64) + carries
    return idx, frac


def frac_to_phase_bin(frac: torch.Tensor, nsteps_log2: int = 7) -> torch.Tensor:
    """Round a uint32 fractional position to an interpolator phase bin in
    [0, 2**nsteps_log2] inclusive (the top bin is the next-sample filter).
    Rounds on ``frac >> 1`` exactly as the JAX package does."""
    shift = 32 - nsteps_log2 - 1
    half = 1 << (shift - 1)
    return ((frac >> 1) + half) >> shift
