"""Audio FMCW radar (port of ``grbaz_tpu/models/fmcw.py``): the reference
demo flowgraph (Audio FMCW.grc: sawtooth sweep -> VCO chirp -> audio
out; audio in -> multiply-conjugate deramp -> stream_to_vector -> FFT ->
|.| -> nlog10 -> waterfall/plot sinks).

The chirp is not a sequential VCO loop: within a sweep of ``P`` samples
the phase is the closed-form quadratic

    phase(k) = inc0*k + step*(k*(k-1)/2)      (mod 2^32 turns)

in exact uint32 modular arithmetic, held here in int64 tensors masked to
32 bits (``core.device``): ``k*(k-1)`` is taken mod 2^32 before it is
halved, and every sum and product wraps as the JAX package's uint32 does.
The only carry is the global sample counter (sweep alignment across
blocks).

Behaviour kept from the JAX package: the counter advances by the block's
capacity, not its count, and ``k = counter mod P`` loses sweep alignment
across the 2^32 wrap when P is not a power of two; ``RangeFFT`` takes the
FFT of every sweep of the block, padding included, and reports the
number of sweeps as its count. The JAX blocks call a ``Stream.replace``
and ``build_fmcw`` a ``connect(..., out_port=0)`` that its core does not
have; here a block's outputs keep the input's count and meta, and port 0
of the deramp feeds the range FFT.

Flowgraph surface:
    input  "rx"     float audio from the microphone path
    output "range"  (n_sweeps, P//2+1) log-magnitude range profiles
    output "tx"     float chirp for the speaker path (same timeline)
    output "beat"   deramped complex baseband (diagnostics)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import U32_MASK, resolve_device, scalar
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.exact import freq_to_turns_u32, turns_u32_to_radians


@dataclasses.dataclass
class FMCWConfig:
    sample_rate: float = 48e3
    f0: float = 2e3            # sweep start (audio band, like the demo)
    f1: float = 8e3            # sweep end
    sweep_period: int = 1024   # samples per sweep (P)
    block_size: int = 8192     # must be a multiple of sweep_period
    wave_speed: float = 343.0  # m/s (sound; use c for RF captures)

    @property
    def n_sweeps(self) -> int:
        return self.block_size // self.sweep_period

    def range_resolution(self) -> float:
        """Metres per beat-frequency bin: v / (2 * sweep_bandwidth)."""
        return self.wave_speed / (2.0 * (self.f1 - self.f0))

    def bin_to_range(self, beat_bin: float) -> float:
        """Round-trip range for an FFT beat bin (one sweep = one FFT)."""
        return float(beat_bin) * self.range_resolution()

    def delay_to_bin(self, delay_samples: float) -> float:
        """Expected beat bin for an echo delayed by ``delay_samples``."""
        return float(delay_samples) * (self.f1 - self.f0) / self.sample_rate


def chirp_phase_u32(k: torch.Tensor, cfg: FMCWConfig) -> torch.Tensor:
    """Exact uint32 phase (turns) at intra-sweep index ``k`` (uint32
    values in int64); int64 holding uint32 values. A product of two
    values below 2^32 may pass 2^63 and wrap in int64, which leaves its
    low 32 bits exact."""
    inc0 = int(freq_to_turns_u32(cfg.f0, cfg.sample_rate))
    inc1 = int(freq_to_turns_u32(cfg.f1, cfg.sample_rate))
    step = ((inc1 - inc0) % (1 << 32)) // cfg.sweep_period
    k = k.to(torch.int64) & U32_MASK
    tri = ((k * ((k - 1) & U32_MASK)) & U32_MASK) >> 1
    return (inc0 * k + step * tri) & U32_MASK


def chirp_iq(global_idx: torch.Tensor, cfg: FMCWConfig) -> torch.Tensor:
    """Complex chirp samples for absolute sample indices (uint32 values
    in int64): sawtooth FM, the phase reset at each sweep start."""
    k = (global_idx.to(torch.int64) & U32_MASK) % cfg.sweep_period
    ang = turns_u32_to_radians(chirp_phase_u32(k, cfg))
    return torch.complex(torch.cos(ang), torch.sin(ang))


class ChirpDeramp(Block):
    """rx float -> (beat complex, tx float).

    Generates the transmit chirp for the block's absolute sample span
    and mixes the received audio against its conjugate (the demo's
    ``blocks_multiply_conjugate_cc``), yielding the beat signal whose
    frequency encodes round-trip delay.
    """

    n_in, n_out = 1, 2

    def __init__(self, cfg: FMCWConfig, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.cfg = cfg

    def init_state(self):
        # global sample counter (uint32 in int64), for sweep alignment
        return scalar(0, torch.int64, self.device)

    def apply(self, state, params, rx: Stream):
        n = rx.data.shape[0]
        idx = (state + torch.arange(n, dtype=torch.int64,
                                    device=rx.data.device)) & U32_MASK
        tx = chirp_iq(idx, self.cfg)
        beat = rx.data.to(torch.float32) * torch.conj(tx)
        new_state = (state + n) & U32_MASK
        return new_state, (rx.like(beat, count=rx.count),
                           rx.like(tx.real.contiguous(), count=rx.count))


class RangeFFT(Block):
    """Sweep-aligned range profiles: reshape the beat signal into
    (n_sweeps, P), window, FFT, log magnitude (the demo's
    stream_to_vector -> fft_vxx -> complex_to_mag -> nlog10 chain)."""

    def __init__(self, cfg: FMCWConfig, name=None, device="cuda"):
        super().__init__(name)
        if cfg.block_size % cfg.sweep_period:
            raise ValueError("block_size must be a multiple of sweep_period")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.window = torch.from_numpy(
            np.hanning(cfg.sweep_period).astype(np.float32)).to(self.device)

    def apply(self, state, params, beat: Stream):
        P = self.cfg.sweep_period
        frames = beat.data.reshape(-1, P) * self.window
        spec = torch.fft.fft(frames, dim=-1)[:, :P // 2 + 1]
        logmag = 10.0 * torch.log10(spec.abs() + 1e-12)
        return state, (beat.like(logmag, count=frames.shape[0]),)


def build_fmcw(cfg: FMCWConfig, device="cuda"):
    """Wire the FMCW flowgraph on ``device``; returns (flowgraph,
    handles)."""
    fg = Flowgraph("fmcw")
    deramp = ChirpDeramp(cfg, name="deramp", device=device)
    rfft = RangeFFT(cfg, name="range", device=device)
    fg.input("rx", deramp)
    fg.connect((deramp, 0), rfft)
    fg.output("beat", (deramp, 0))
    fg.output("tx", (deramp, 1))
    fg.output("range", rfft)
    return fg, dict(deramp=deramp, range=rfft)


def simulate_echo(cfg: FMCWConfig, n: int, delay_samples: int,
                  atten: float = 0.5, noise: float = 0.0,
                  seed: int = 0) -> np.ndarray:
    """Synthesize a received audio block (numpy): the chirp echo delayed
    by ``delay_samples`` (+ optional noise), a loopback test signal."""
    idx = np.arange(n, dtype=np.uint64)
    k = (idx - delay_samples) % cfg.sweep_period
    valid = idx >= delay_samples
    inc0 = int(freq_to_turns_u32(cfg.f0, cfg.sample_rate))
    step = ((int(freq_to_turns_u32(cfg.f1, cfg.sample_rate)) - inc0)
            % (1 << 32)) // cfg.sweep_period
    ph = (inc0 * k + step * (k * (k - 1) // 2)) % (1 << 32)
    tx_del = np.cos(ph.astype(np.float64) * (2 * np.pi / 2**32))
    rng = np.random.default_rng(seed)
    out = atten * tx_del * valid
    if noise:
        out = out + rng.normal(0, noise, n)
    return out.astype(np.float32)
