"""Spectral analysis: framing, windowed FFT power spectra, FAC (port of
``grbaz_tpu/ops/spectral.py``).

* :class:`Vectorize` / :class:`Overlap`: stream -> frames; each
  overlapping frame repeats the last ``overlap`` items of the previous
  one (``baz_overlap`` semantics);
* :class:`PowerSpectrum`: windowed FFT, ``|.|^2``, single-pole average
  from frame to frame, dB, fftshifted;
* :class:`FACSpectrum`: the Fast Auto-Correlation display chain, frame ->
  keep-one-in-n -> FFT -> ``|.|`` -> FFT -> ``|.|`` -> single-pole
  average -> ``20*log10 - 20*log10(N)``.

Frames batch as ``[n_frames, N]``; the FFTs are ``torch.fft`` over the
batch (the JAX package also leaves them to its library FFT). The
frame-to-frame averages, a serial ``lax.scan`` in the JAX package, are
:func:`.iir.onepole_scan` along the frame axis.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar, take
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.fir import _window
from grbaz_tpu_torch.ops.iir import onepole_scan


class Vectorize(Block):
    """Stream -> frames of ``size`` (gr stream_to_vector). Needs
    size | block_size; carries no remainder (Overlap carries history)."""

    def __init__(self, size: int, name=None):
        super().__init__(name)
        self.size = int(size)

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        if n % self.size:
            raise ValueError("block size must be a multiple of frame size")
        frames = x.data.reshape(-1, self.size)
        out = x.like(frames, count=x.count // self.size,
                     rate_scale=1.0 / self.size)
        return state, (out,)


class Overlap(Block):
    """Overlapping frames: frame k spans ``size`` samples advancing by
    ``size - overlap`` (baz_overlap semantics). Carries the tail."""

    def __init__(self, size: int, overlap: int, dtype=torch.complex64,
                 name=None, device="cuda"):
        super().__init__(name)
        if not 0 <= overlap < size:
            raise ValueError("need 0 <= overlap < size")
        self.device = resolve_device(device)
        self.size = int(size)
        self.overlap = int(overlap)
        self.advance = self.size - self.overlap
        self.dtype = dtype

    def init_state(self):
        return dict(tail=torch.zeros(self.overlap, dtype=self.dtype,
                                     device=self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        if n % self.advance:
            raise ValueError("block size must be a multiple of "
                             "(size - overlap)")
        frame_src = torch.cat([state["tail"], x.data])
        frames = frame_src.unfold(0, self.size, self.advance).contiguous()
        new_state = dict(tail=frame_src[n:]) if self.overlap else state
        out = x.like(frames, count=x.count // self.advance,
                     rate_scale=1.0 / self.advance)
        return new_state, (out,)


class SinglePoleIIRVector(Block):
    """Per-bin single-pole IIR over frames (gr single_pole_iir_filter_ff):
    ``y = alpha*x + (1-alpha)*y_prev``, applied frame to frame."""

    def __init__(self, alpha: float, size: int, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.alpha0 = float(alpha)
        self.size = int(size)

    def init_state(self):
        return dict(prev=torch.zeros(self.size, dtype=torch.float32,
                                     device=self.device))

    def init_params(self):
        return dict(alpha=scalar(self.alpha0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        a = params["alpha"]
        ys = onepole_scan(a * x.data, 1.0 - a, state["prev"])
        return dict(prev=ys[-1]), (x.like(ys, count=x.count),)


class PowerSpectrum(Block):
    """Frames [n, N] -> averaged dB power spectra [n, N].

    Windowed FFT + ``|.|^2`` + single-pole average + ``10*log10``,
    fftshifted so bin 0 is the most negative frequency (display order).
    A unit-amplitude complex tone on a bin reads 0 dBFS.
    """

    def __init__(self, fft_size: int, window: str = "blackmanharris",
                 avg_alpha: float = 1.0, ref_scale: float = 1.0,
                 shift: bool = True, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.size = int(fft_size)
        win = _window(fft_size, window).astype(np.float32)
        self.win = torch.from_numpy(win).to(self.device)
        self.norm = float(np.float32(np.sum(win) * ref_scale))
        self.avg_alpha0 = float(avg_alpha)
        self.shift = shift

    def init_state(self):
        return dict(avg=torch.zeros(self.size, dtype=torch.float32,
                                    device=self.device))

    def init_params(self):
        return dict(alpha=scalar(self.avg_alpha0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        spec = torch.fft.fft(x.data * self.win, dim=-1)
        norm2 = float(np.float32(self.norm) ** 2)
        p = (spec.real ** 2 + spec.imag ** 2) / norm2
        a = params["alpha"]
        ps = onepole_scan(a * p, 1.0 - a, state["avg"])
        db = 10.0 * torch.log10(torch.clamp(ps, min=1e-30))
        if self.shift:
            db = torch.fft.fftshift(db, dim=-1)
        return dict(avg=ps[-1]), (x.like(db, count=x.count),)


class FACSpectrum(Block):
    """Fast Auto-Correlation spectrum (the facsink pipeline).

    Input: frames [n, N] (complex or float). Per kept frame:
    ``20*log10(|FFT(|FFT(frame)|)|) - 20*log10(N)`` with single-pole
    averaging between the second magnitude and the log. The keep-one-in-n
    phase and the number of kept frames stay on the device.
    """

    def __init__(self, fac_size: int, keep_one_in_n: int = 1,
                 avg_alpha: float = 1.0, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.size = int(fac_size)
        self.keep = max(1, int(keep_one_in_n))
        self.avg_alpha0 = float(avg_alpha)

    def init_state(self):
        return dict(avg=torch.zeros(self.size, dtype=torch.float32,
                                    device=self.device),
                    phase=scalar(self.keep - 1, torch.int32, self.device))

    def init_params(self):
        return dict(alpha=scalar(self.avg_alpha0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        n_frames = x.data.shape[0]
        cap = n_frames // self.keep + 1
        k = torch.arange(cap + 1, dtype=torch.int32, device=x.data.device)
        idx = state["phase"] + k * self.keep
        valid = idx[:cap] < torch.clamp(x.count, max=n_frames)
        frames = x.data.index_select(
            0, torch.clamp(idx[:cap], 0, n_frames - 1).long())
        n_out = valid.sum(dtype=torch.int32)
        new_phase = take(idx, n_out) - n_frames

        m1 = torch.abs(torch.fft.fft(frames.to(torch.complex64), dim=-1))
        m2 = torch.abs(torch.fft.fft(m1.to(torch.complex64), dim=-1))
        a = params["alpha"]
        # the kept frames are a prefix: the frames past it take the last
        # kept average, so masked frames leave the carried average alone
        avg_raw = onepole_scan(a * m2, 1.0 - a, state["avg"])
        last = torch.where(n_out > 0,
                           take(avg_raw, torch.clamp(n_out - 1, min=0)),
                           state["avg"])
        avg = torch.where(valid[:, None], avg_raw, last)
        db = 20.0 * torch.log10(torch.clamp(avg, min=1e-30)) \
            - float(np.float32(20.0 * np.log10(self.size)))
        out = x.like(db, count=n_out, rate_scale=1.0 / self.keep)
        return dict(avg=last, phase=new_phase), (out,)
