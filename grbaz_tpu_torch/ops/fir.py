"""FIR filtering: tap design, decimating FIR and frequency-translating FIR
(port of ``grbaz_tpu/ops/fir.py``).

Tap design is numpy, copied so the port imports without JAX. The FIR
cores are plain PyTorch: the decimating FIR is the polyphase product
``Q = Z @ H^T`` (``Z[j, p] = frame[j*decim + p]``, ``H[m, p] =
h[m*decim + p]``) followed by ``y[k] = sum_m Q[k+m, m]`` -- a large
matrix product, which the JAX package also leaves outside its kernels.
The blocks reach the hand-written CUDA kernels of :mod:`.cuda` on the
card (``backend='auto'``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.wbfm_frontend import rotate_output, rotated_taps

BACKENDS = ("auto", "plain", "kernel")


# ---------------------------------------------------------------------------
# tap design (firdes equivalents; numpy copies of grbaz_tpu/ops/fir.py)
# ---------------------------------------------------------------------------

def _window(n: int, kind: str = "hamming") -> np.ndarray:
    t = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * t / (n - 1))
    if kind == "blackman":
        return (0.42 - 0.5 * np.cos(2 * np.pi * t / (n - 1))
                + 0.08 * np.cos(4 * np.pi * t / (n - 1)))
    if kind == "blackmanharris":
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * t / (n - 1))
                + 0.14128 * np.cos(4 * np.pi * t / (n - 1))
                - 0.01168 * np.cos(6 * np.pi * t / (n - 1)))
    if kind == "rect":
        return np.ones(n)
    raise ValueError(f"unknown window {kind}")


def low_pass_taps(gain: float, sample_rate: float, cutoff: float,
                  transition: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass (firdes.low_pass equivalent), unity DC gain."""
    # Harris rule-of-thumb tap estimate for the window's attenuation
    atten = {"hamming": 53.0, "hann": 44.0, "blackman": 74.0,
             "blackmanharris": 92.0, "rect": 21.0}[window]
    ntaps = int(atten * sample_rate / (22.0 * transition))
    ntaps |= 1  # odd for symmetric linear phase
    m = (ntaps - 1) // 2
    t = np.arange(ntaps) - m
    fc = cutoff / sample_rate
    h = 2.0 * fc * np.sinc(2.0 * fc * t) * _window(ntaps, window)
    h *= gain / np.sum(h)
    return h.astype(np.float32)


def band_pass_taps(gain: float, sample_rate: float, low: float, high: float,
                   transition: float, window: str = "hamming") -> np.ndarray:
    """Real band-pass via modulated lowpass."""
    bw = (high - low) / 2.0
    lp = low_pass_taps(1.0, sample_rate, bw, transition, window)
    m = (len(lp) - 1) // 2
    t = np.arange(len(lp)) - m
    center = (low + high) / 2.0
    h = lp * 2.0 * np.cos(2 * np.pi * center / sample_rate * t)
    # normalize the peak response at the center frequency
    w = 2 * np.pi * center / sample_rate
    resp = np.abs(np.sum(h * np.exp(-1j * w * np.arange(len(h)))))
    h *= gain / resp
    return h.astype(np.float32)


def prepare_taps(taps: Sequence[float], decim: int) -> np.ndarray:
    """Reverse and left-pad taps to a multiple of decim."""
    h = np.asarray(taps, dtype=np.float32)
    h_rev = h[::-1]
    tpad = int(math.ceil(len(h) / decim)) * decim
    pad = tpad - len(h)
    return np.concatenate([np.zeros(pad, np.float32), h_rev])


# ---------------------------------------------------------------------------
# FIR cores (plain PyTorch)
# ---------------------------------------------------------------------------

def _band_sum(q: torch.Tensor, n_out: int) -> torch.Tensor:
    """y[k] = sum_m q[k+m, m]."""
    y = q[0:n_out, 0]
    for m in range(1, q.shape[1]):
        y = y + q[m:m + n_out, m]
    return y


def _polyphase_rows(frame: torch.Tensor, tpad: int, decim: int):
    n_out = max(frame.shape[0] - (tpad - 1), 0) // decim
    n_rows = n_out + tpad // decim
    pad = n_rows * decim - frame.shape[0]
    if pad > 0:
        frame = torch.cat([frame, frame.new_zeros(pad)])
    return frame[:n_rows * decim].reshape(n_rows, decim), n_out


def fir_decimate_frame(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                       decim: int) -> torch.Tensor:
    """Causal decimating FIR over a frame with tpad-1 leading history:
    ``y[k] = sum_t h_rev_pad[t] * frame[k*decim + t]``. Complex frames
    run as real and imaginary planes against the real taps."""
    tpad = h_rev_pad.shape[0]
    z, n_out = _polyphase_rows(frame, tpad, decim)
    h2t = h_rev_pad.to(torch.float32).reshape(tpad // decim, decim).T
    if frame.is_complex():
        return torch.complex(_band_sum(z.real @ h2t, n_out),
                             _band_sum(z.imag @ h2t, n_out))
    return _band_sum(z.to(torch.float32) @ h2t, n_out).to(frame.dtype)


def fir_decimate_frame_windows(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                               decim: int) -> torch.Tensor:
    """The strided-window form of :func:`fir_decimate_frame`: the
    [n_out, tpad] windows ``frame[k*decim : k*decim + tpad]`` as an
    ``unfold`` view times the taps (complex frames as two real planes).
    The frame's new samples must be a multiple of ``decim``."""
    tpad = h_rev_pad.shape[0]
    n_new = frame.shape[0] - (tpad - 1)
    if n_new % decim:
        raise ValueError("block size must be a multiple of decim")
    n_out = n_new // decim
    h = h_rev_pad.to(torch.float32)
    if frame.is_complex():
        return torch.complex(frame.real.unfold(0, tpad, decim)[:n_out] @ h,
                             frame.imag.unfold(0, tpad, decim)[:n_out] @ h)
    return frame.unfold(0, tpad, decim)[:n_out] @ h_rev_pad.to(frame.dtype)


def fir_decimate_tail_block(tail: torch.Tensor, x: torch.Tensor,
                            h_rev_pad: torch.Tensor,
                            decim: int) -> torch.Tensor:
    """Decimating FIR over (carried tail, new block): ``tail`` holds the
    previous TPAD samples and ``tail[1:]`` is the filter history. Equals
    ``fir_decimate_frame(concat(tail[1:], x))``."""
    return fir_decimate_frame(torch.cat([tail[1:], x]), h_rev_pad, decim)


def fir_decimate_frame_ctaps(frame: torch.Tensor, g_rev_pad: torch.Tensor,
                             decim: int) -> torch.Tensor:
    """Polyphase decimating FIR with COMPLEX taps over a complex frame
    with tpad-1 leading history: ``y[k] = sum_t g_rev_pad[t] *
    frame[k*decim + t]`` (port of ``_fir_decimate_poly_ctaps``)."""
    tpad = g_rev_pad.shape[0]
    z, n_out = _polyphase_rows(frame.to(torch.complex64), tpad, decim)
    g2t = g_rev_pad.to(torch.complex64).reshape(tpad // decim, decim).T
    return _band_sum(z @ g2t, n_out)


def xlating_fir_decimate_frame(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                               decim: int, phase0: torch.Tensor,
                               lo_inc: torch.Tensor) -> torch.Tensor:
    """Frequency-translating decimating FIR via the rotated-taps identity:
    filter with the complex taps ``g[t] = h_rev[t] * lo((t - (tpad-1)))``
    and rotate only the decimated outputs by ``lo(phase0 + k*decim*inc)``.
    Same output as rotate-then-filter, f32 rounding aside."""
    yf = fir_decimate_frame_ctaps(frame, rotated_taps(h_rev_pad, lo_inc),
                                  decim)
    return rotate_output(yf, phase0, lo_inc, decim)


def fft_fir_frame(frame: torch.Tensor, h_rev_pad: torch.Tensor,
                  decim: int = 1) -> torch.Tensor:
    """Overlap-save FFT convolution with :func:`fir_decimate_frame`
    semantics, ``y[k] = sum_t h_rev_pad[t] * frame[k*decim + t]`` over a
    frame with ``tpad-1`` samples of history; real or complex taps (a
    sync correlator's are complex). Segments of ``f`` samples (the power
    of two at or above 4x the taps, at least 256) overlap by ``tpad-1``
    and run as one batched ``torch.fft``."""
    tpad = h_rev_pad.shape[0]
    n_full = frame.shape[0] - (tpad - 1)
    f = max(256, 1 << int(math.ceil(math.log2(4 * tpad))))
    step = f - (tpad - 1)          # valid outputs per segment
    n_seg = -(-n_full // step)
    fc = frame.to(torch.complex64)
    pad = (tpad - 1) + n_seg * step - fc.shape[0]
    if pad > 0:
        fc = torch.cat([fc, fc.new_zeros(pad)])
    # segment j covers outputs [j*step, (j+1)*step): frame[j*step:][:f];
    # y[k] = conv(frame, g)[k + tpad - 1] with g the taps reversed
    segs = fc.unfold(0, f, step)
    hf = torch.fft.fft(h_rev_pad.flip(0).to(torch.complex64), n=f)
    yseg = torch.fft.ifft(torch.fft.fft(segs, dim=1) * hf, dim=1)
    y = yseg[:, tpad - 1:].reshape(-1)[:n_full]
    if decim > 1:
        y = y[::decim][:n_full // decim]
    if not frame.is_complex():
        return y.real.to(frame.dtype)
    return y.to(frame.dtype)


def _carry_tail(tail: torch.Tensor, x: torch.Tensor,
                tail_len: int) -> torch.Tensor:
    if x.shape[0] >= tail_len:
        return x[-tail_len:]
    return torch.cat([tail, x])[-tail_len:]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    return backend


def _kernel_arm(backend: str, device: torch.device) -> bool:
    """A block's kernel arm runs under 'kernel', and under 'auto' on the
    card."""
    return backend == "kernel" or (backend == "auto"
                                   and device.type == "cuda")


class FIRDecimator(Block):
    """Decimating FIR with carried filter tail. decim=1 gives a plain FIR.

    ``backend``: 'auto' and 'kernel' go through the CUDA decimating-FIR
    kernel's block entry point (``fir_decimate_block``), which reads the
    carried tail and the new block in place on the card and runs the
    plain twin (the polyphase product) on the CPU; 'plain' always runs
    the plain product. 'kernel' is accepted so that one backend name
    (``WBFMConfig.chan_backend``) can serve every block of a chain.
    """

    def __init__(self, taps, decim: int = 1, dtype=torch.complex64,
                 name=None, backend: str = "auto", device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.decim = int(decim)
        self.backend = _check_backend(backend)
        self.h_rev_pad = torch.from_numpy(
            prepare_taps(taps, self.decim)).to(self.device)
        # the carried tail holds TPAD samples (history + 1), the
        # convention of the JAX package's fir_decimate_tail_block
        self.tail_len = self.h_rev_pad.shape[0]
        self.dtype = dtype

    def init_state(self):
        return dict(tail=torch.zeros(self.tail_len, dtype=self.dtype,
                                     device=self.device))

    def apply(self, state, params, x: Stream):
        if self.backend == "plain":
            y = fir_decimate_tail_block(state["tail"], x.data, self.h_rev_pad,
                                        self.decim)
        else:
            from grbaz_tpu_torch.ops.cuda.fir_decimate import \
                fir_decimate_block
            y = fir_decimate_block(x.data, state["tail"], self.h_rev_pad,
                                   self.decim)
        tail = _carry_tail(state["tail"], x.data, self.tail_len)
        out = x.like(y, count=x.count // self.decim,
                     rate_scale=1.0 / self.decim)
        return dict(tail=tail), (out,)


class FreqXlatingFIRDecimator(Block):
    """Frequency-translating decimating FIR (gr freq_xlating_fir_filter
    equivalent): rotate the band at ``center_freq`` down to 0 with an
    exact-phase LO, then lowpass and decimate with real taps.
    ``center_freq`` is retunable through the ``lo_inc`` param.

    Three arms, as in the JAX package:

    * ``rotate_taps=True``: complex rotated taps plus a decimated output
      rotation; the tail carries UNROTATED samples;
    * the kernel arm (``backend='auto'`` on the card, or ``'kernel'``):
      the CUDA channelizer kernel (``xlating_fir_block``) rotates and
      filters in one pass, reading the new block and the carried tail in
      place, for any block length;
    * rotate-then-filter (``backend='plain'``, or 'auto' on the CPU):
      oscillator, rotation, then the decimating FIR -- the CUDA
      ``fir_decimate_frame`` kernel when ``fir_kernel=True`` (the JAX
      ``use_pallas``), else the plain product.

    The kernel and rotate-then-filter arms carry one state, the JAX
    package's CPU layout: a tail of ROTATED samples (the last TPAD of
    ``x * lo``). The kernel filters an UNROTATED history, so the kernel
    arm first derotates the carried tail with the current increment
    (sample i < 0 times ``conj(lo(phase + i*lo_inc))``): the kernel's
    rotation then gives back the rotated tail even across a retune, where
    a tail rotated under the old increment meets the new one. After the
    launch it rotates the block's last TPAD samples into the new tail, as
    ``parallel/channel_bank.py`` does for its slots; both take the LO at
    those offsets from :func:`.exact.lo_at`. A checkpoint thus
    moves between the arms, and between the card and the CPU.
    """

    def __init__(self, taps, decim: int, center_freq: float,
                 sample_rate: float, dtype=torch.complex64, name=None,
                 fir_kernel: bool = False, rotate_taps: bool = False,
                 backend: str = "auto", device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.decim = int(decim)
        self.fir_kernel = bool(fir_kernel)
        self.rotate_taps = bool(rotate_taps)
        self.backend = _check_backend(backend)
        self.h_rev_pad = torch.from_numpy(
            prepare_taps(taps, self.decim)).to(self.device)
        self.tail_len = self.h_rev_pad.shape[0]
        self.dtype = dtype
        self.sample_rate = float(sample_rate)
        self.center_freq0 = float(center_freq)
        self._offsets = {}   # block length -> _tail_offsets

    def init_state(self):
        return dict(tail=torch.zeros(self.tail_len, dtype=self.dtype,
                                     device=self.device),
                    phase=scalar(0, torch.int64, self.device))

    def init_params(self):
        lo = exact.freq_to_turns_u32(-self.center_freq0, self.sample_rate)
        return dict(lo_inc=scalar(int(lo), torch.int64, self.device))

    @staticmethod
    def freq_params(center_freq: float, sample_rate: float):
        """Host helper: params (numpy uint32) for a new center frequency."""
        return dict(lo_inc=exact.freq_to_turns_u32(-center_freq, sample_rate))

    def _use_kernel(self) -> bool:
        return not self.rotate_taps and _kernel_arm(self.backend, self.device)

    def _tail_offsets(self, n: int) -> torch.Tensor:
        """int64 ``[-tl .. -1, n-m .. n-1]`` (m = min(n, tl)) on the
        block's device, made once per block length."""
        if n not in self._offsets:
            tl = self.tail_len
            self._offsets[n] = torch.cat([torch.arange(-tl, 0), torch.arange(
                n - min(n, tl), n)]).to(self.device)
        return self._offsets[n]

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        phase, lo_inc = state["phase"], params["lo_inc"]
        phase_after = (phase + n * lo_inc) & U32_MASK
        if self.rotate_taps:
            frame = torch.cat([state["tail"][1:], x.data])
            y = xlating_fir_decimate_frame(frame, self.h_rev_pad, self.decim,
                                           phase, lo_inc)
            tail = _carry_tail(state["tail"], x.data, self.tail_len)
        elif self._use_kernel():
            from grbaz_tpu_torch.ops.cuda.xlating_fir import \
                xlating_fir_block
            # one LO for the carried tail (samples -tl..-1) and the
            # block's last m samples
            tl = self.tail_len
            m = min(n, tl)
            lo = exact.lo_at(phase, lo_inc, self._tail_offsets(n))
            y = xlating_fir_block(x.data, state["tail"] * lo[:tl].conj(),
                                  self.h_rev_pad, self.decim, phase, lo_inc)
            tail = _carry_tail(state["tail"], x.data[n - m:] * lo[tl:], tl)
        else:
            lo, _ = exact.oscillator(n, phase, lo_inc)
            xr = x.data * lo
            if self.fir_kernel:
                from grbaz_tpu_torch.ops.cuda.fir_decimate import \
                    fir_decimate_frame as fir_kernel
                y = fir_kernel(torch.cat([state["tail"][1:], xr]),
                               self.h_rev_pad, self.decim)
            else:
                y = fir_decimate_tail_block(state["tail"], xr, self.h_rev_pad,
                                            self.decim)
            tail = _carry_tail(state["tail"], xr, self.tail_len)
        out = x.like(y, count=x.count // self.decim,
                     rate_scale=1.0 / self.decim)
        return dict(tail=tail, phase=phase_after), (out,)
