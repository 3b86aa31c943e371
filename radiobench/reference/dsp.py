"""Plain DSP for the benchmark's references: tap design, the MMSE
interpolator table, exact 32-bit stream arithmetic, FIR, discriminator,
resampler and deemphasis, written out the straightforward way.

Frozen copies of the published designs (firdes' windowed-sinc lowpass,
the 8-tap MMSE interpolator bank, the uint32 turn phase and the 32.32
resampler position) sit here so that a reference imports nothing of the
program under test. Every function takes a ``mode``:

* ``"f64"``: float64 / complex128 throughout; the judge.
* ``"tf32"``: the control. Float32 throughout, and every product of a
  filter or interpolator (the work a matrix unit would take) has both
  operands rounded to TF32 (10 mantissa bits) and sums in float32, as
  TensorFloat-32 tensor cores do.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

TWO32 = 1 << 32
MASK32 = TWO32 - 1
MODES = ("f64", "tf32")


def real_dtype(mode: str) -> torch.dtype:
    return torch.float64 if mode == "f64" else torch.float32


def complex_dtype(mode: str) -> torch.dtype:
    return torch.complex128 if mode == "f64" else torch.complex64


@contextlib.contextmanager
def exact_matmul():
    """Float32 products in float32: no TF32 on the card while a
    reference runs (the control rounds its operands itself)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to TF32: the 13 low mantissa bits dropped, round
    to nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


# ---------------------------------------------------------------------------
# designs (copies of the published formulas)
# ---------------------------------------------------------------------------

def _window(n: int, kind: str) -> np.ndarray:
    t = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if kind == "blackmanharris":
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * t / (n - 1))
                + 0.14128 * np.cos(4 * np.pi * t / (n - 1))
                - 0.01168 * np.cos(6 * np.pi * t / (n - 1)))
    raise ValueError(f"unknown window {kind}")


def low_pass_taps(sample_rate: float, cutoff: float, transition: float,
                  window: str = "hamming") -> np.ndarray:
    """firdes.low_pass at unity gain: a windowed sinc whose length is
    Harris' estimate for the window's attenuation, odd; float32 taps,
    as the filter stores them."""
    atten = {"hamming": 53.0, "blackmanharris": 92.0}[window]
    ntaps = int(atten * sample_rate / (22.0 * transition)) | 1
    t = np.arange(ntaps) - (ntaps - 1) // 2
    fc = cutoff / sample_rate
    h = 2.0 * fc * np.sinc(2.0 * fc * t) * _window(ntaps, window)
    return (h / np.sum(h)).astype(np.float32)


def padded_taps(ntaps: int, decim: int) -> int:
    """Taps rounded up to a whole number of polyphase rows."""
    return -(-ntaps // decim) * decim


def _sint(x: np.ndarray, a: float) -> np.ndarray:
    out = np.full(x.shape, a, dtype=np.float64)
    nz = np.abs(x) > 1e-12
    out[nz] = np.sin(a * x[nz]) / x[nz]
    return out


def mmse_table(ntaps: int = 8, nsteps: int = 128,
               band: float = 0.5) -> np.ndarray:
    """The MMSE fractional-delay bank: for phase mu = p / nsteps, the
    least-squares fit over |w| <= band*pi of exp(-jw(C + mu)), C = ntaps
    / 2 - 1; [nsteps + 1, ntaps] float32."""
    a = band * np.pi
    t = np.arange(ntaps, dtype=np.float64)
    gram = _sint(t[:, None] - t[None, :], a)
    center = ntaps // 2 - 1
    return np.stack([np.linalg.solve(gram, _sint(t - (center + p / nsteps),
                                                 a))
                     for p in range(nsteps + 1)]).astype(np.float32)


# ---------------------------------------------------------------------------
# exact stream arithmetic
# ---------------------------------------------------------------------------

def freq_to_inc(freq_hz: float, sample_rate: float) -> int:
    """A frequency as a uint32 phase step in 2^-32 turns a sample."""
    return int(round(((float(freq_hz) / float(sample_rate)) % 1.0)
                     * TWO32)) % TWO32


def ratio_to_fixed(ratio: float) -> int:
    """Input samples an output as one 32.32 fixed-point integer."""
    ip = math.floor(ratio)
    return ip * TWO32 + int(round((ratio - ip) * TWO32))


def lo(g0: int, n: int, inc: int, mode: str, device) -> torch.Tensor:
    """exp(j 2pi u32((g0 + i) inc) / 2^32) for i < n: the LO at the
    absolute samples g0.. of the stream."""
    p0 = (int(g0) * int(inc)) % TWO32
    i = torch.arange(n, dtype=torch.int64, device=device)
    ph = ((p0 + i * int(inc)) & MASK32).to(torch.float64) * (2 * np.pi
                                                            / TWO32)
    ph = ph.to(real_dtype(mode))
    return torch.complex(torch.cos(ph), torch.sin(ph))


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _dot(windows: torch.Tensor, taps: torch.Tensor, mode: str):
    if mode == "tf32":
        return tf32(windows.to(torch.float32)) @ tf32(taps.to(torch.float32))
    return windows.to(torch.float64) @ taps.to(torch.float64)


def fir_decimate(x: torch.Tensor, h: np.ndarray, decim: int,
                 mode: str) -> torch.Tensor:
    """y[k] = sum_m h[m] x[decim k - m], with zeros before x[0]; k <
    len(x) / decim. Complex inputs filter their two planes."""
    taps = torch.from_numpy(np.ascontiguousarray(h[::-1])).to(x.device)
    n_out = x.shape[0] // decim

    def plane(p):
        win = torch.cat([p.new_zeros(len(h) - 1), p])
        return _dot(win.unfold(0, len(h), decim)[:n_out], taps, mode)
    if x.is_complex():
        return torch.complex(plane(x.real), plane(x.imag))
    return plane(x)


def discriminator(y: torch.Tensor, prev: complex, gain: float):
    """gain * arg(y[k] conj(y[k-1])), with y[-1] = prev."""
    before = torch.cat([y.new_full((1,), prev), y[:-1]])
    prod = y * before.conj()
    return torch.atan2(prod.imag, prod.real) * gain


def resample(a: torch.Tensor, a0: int, k0: int, k1: int, inc: int,
             table: np.ndarray, mode: str) -> torch.Tensor:
    """Outputs k0..k1-1 of the fixed-ratio MMSE resampler over a stream
    whose samples a0.. are ``a`` (zeros before): output k interpolates
    samples floor(k inc) .. + 7 with the taps of the phase bin of k inc's
    fraction, the top 7 bits rounded on the fraction's upper 31."""
    dev = a.device
    k = torch.arange(k0, k1, dtype=torch.int64, device=dev)
    pos = k * int(inc)
    first = (pos >> 32) - a0
    frac = pos & MASK32
    bins = ((frac >> 1) + (1 << 23)) >> 24
    ntaps = table.shape[1]
    pad = int(max(0, -int(first.min()))) if len(k) else 0
    ap = torch.cat([a.new_zeros(pad), a])
    win = ap[(first + pad)[:, None] + torch.arange(ntaps, device=dev)]
    taps = torch.from_numpy(table).to(dev)[bins]
    if mode == "tf32":
        return (tf32(win.to(torch.float32))
                * tf32(taps.to(torch.float32))).sum(dim=1)
    return (win.to(torch.float64) * taps.to(torch.float64)).sum(dim=1)


def deemphasis(x: np.ndarray, rate: float, tau: float,
               mode: str) -> np.ndarray:
    """The bilinear RC deemphasis y[n] = b0 x[n] + b0 x[n-1] + p y[n-1]
    from rest, one sample at a time."""
    wa = 2.0 * rate * math.tan(1.0 / tau / (2.0 * rate))
    k = -wa / (2.0 * rate)
    b0, p = -k / (1.0 - k), (1.0 + k) / (1.0 - k)
    if mode == "tf32":
        b0, p = np.float32(b0), np.float32(p)
        xs = [np.float32(v) for v in x]
        y = np.empty(len(xs), np.float32)
        yp = xp = np.float32(0.0)
    else:
        xs = x.astype(np.float64).tolist()
        y = np.empty(len(xs), np.float64)
        yp = xp = 0.0
    for n, v in enumerate(xs):
        yp = b0 * v + b0 * xp + p * yp
        xp = v
        y[n] = yp
    return y
