"""MMSE fractional-delay interpolator bank (numpy copy of
``grbaz_tpu/ops/mmse.py``, so the port imports without JAX).

For each phase ``mu`` minimize

    integral over |w| <= B*pi of | H(w) - exp(-j*w*(C + mu)) |^2

with ``H(w) = sum_t h_t exp(-j*w*t)`` and ``C = NTAPS/2 - 1``. The normal
equations are ``A[t,s] = Si(B*pi*(t-s))``, ``b[t] = Si(B*pi*(t - C - mu))``,
``h = A^-1 b``. Interpolating with ``taps[bin]`` over ``x[i .. i+NTAPS-1]``
approximates ``x(i + C + bin/NSTEPS)``.
"""

from __future__ import annotations

import numpy as np

NTAPS = 8
NSTEPS = 128  # power of two: phase bins come from uint32 top bits
NSTEPS_LOG2 = 7
CENTER = NTAPS // 2 - 1  # = 3, constant group delay in samples
BAND = 0.5  # design band (fraction of Nyquist)


def _sint(x: np.ndarray, a: float) -> np.ndarray:
    """integral_0^a cos(w*x) dw = sin(a*x)/x (= a at x=0)."""
    out = np.empty_like(x, dtype=np.float64)
    nz = np.abs(x) > 1e-12
    out[nz] = np.sin(a * x[nz]) / x[nz]
    out[~nz] = a
    return out


def design_taps(ntaps: int = NTAPS, nsteps: int = NSTEPS,
                band: float = BAND) -> np.ndarray:
    """Solve the bandlimited LS problem for every phase; [(nsteps+1), ntaps]."""
    a = band * np.pi
    t = np.arange(ntaps, dtype=np.float64)
    A = _sint(t[:, None] - t[None, :], a)
    center = ntaps // 2 - 1
    taps = np.empty((nsteps + 1, ntaps), dtype=np.float64)
    L = np.linalg.cholesky(A)  # A is symmetric positive definite
    for p in range(nsteps + 1):
        mu = p / nsteps
        b = _sint(t - (center + mu), a)
        y = np.linalg.solve(L, b)
        taps[p] = np.linalg.solve(L.T, y)
    return taps.astype(np.float32)


# Computed once at import (about 1 ms of host work).
TAPS_TABLE = design_taps()
