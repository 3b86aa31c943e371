"""Basic math and utility blocks (port of ``grbaz_tpu/ops/basic.py``).

The small stream blocks: element-wise math, the wire-format conversions
(complex <-> interleaved int16 for BorIP, u8 IQ for the RTL path), pow,
I/Q swap, a runtime-variable delay, keep-one-in-n, bit (un)packing and a
two-threshold comparator. All work on whole blocks; the few with stream
memory carry it in explicit state.

The three wire conversions are ``block_from_fn`` blocks, as in the JAX
package, so their output keeps the input's ``count``: the u8 and int16
to complex conversions report twice their samples, complex to int16
half its values. The port keeps that count, since it is held to the
JAX package.

Constants are rounded to float32 before they multiply a float32 tensor,
so a product is one float32 rounding whichever way torch promotes the
scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block, FnBlock, block_from_fn
from grbaz_tpu_torch.core.device import resolve_device, scalar, take
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.segments import running_max


def _f32(v: float) -> float:
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# stateless element-wise blocks
# ---------------------------------------------------------------------------

@block_from_fn
def conjugate(x):
    return torch.conj_physical(x)


@block_from_fn
def complex_to_mag(x):
    return x.abs().to(torch.float32)


@block_from_fn
def complex_to_mag_squared(x):
    return (x.real * x.real + x.imag * x.imag).to(torch.float32)


@block_from_fn
def complex_to_arg(x):
    return torch.atan2(x.imag, x.real).to(torch.float32)


@block_from_fn
def real_part(x):
    return x.real.to(torch.float32)


@block_from_fn
def imag_part(x):
    return x.imag.to(torch.float32)


def multiply_const(k):
    def multiply_const(x):
        return x * k
    return FnBlock(multiply_const)  # auto-named: a graph may hold several


def add_const(k):
    def add_const(x):
        return x + k
    return FnBlock(add_const)


@block_from_fn(n_in=2)
def multiply(a, b):
    return a * b


@block_from_fn(n_in=2)
def add(a, b):
    return a + b


def float_to_complex():
    def float_to_complex(r, i):
        return torch.complex(r.to(torch.float32), i.to(torch.float32))
    return FnBlock(float_to_complex, n_in=2)


# -- sample format conversions (wire / device formats) ----------------------

def _pairs_to_complex(f: torch.Tensor) -> torch.Tensor:
    pairs = f.reshape(-1, 2)
    return torch.complex(pairs[:, 0], pairs[:, 1])


@block_from_fn
def uchar_iq_to_complex(x):
    """Interleaved u8 IQ (RTL2832 native, offset 127.5) -> complex64."""
    f = (x.to(torch.float32) - 127.5) * _f32(1.0 / 127.5)
    return _pairs_to_complex(f)


@block_from_fn
def ishort_to_complex(x):
    """Interleaved int16 IQ (the BorIP wire format) -> complex64."""
    return _pairs_to_complex(x.to(torch.float32) * _f32(1.0 / 32767.0))


@block_from_fn
def complex_to_ishort(x):
    """complex64 -> interleaved int16 IQ (scale 32767, saturating; rounds
    half to even, as ``jnp.round``)."""
    scaled = torch.stack([x.real, x.imag], dim=-1).reshape(-1) * 32767.0
    return torch.clamp(torch.round(scaled), -32768, 32767).to(torch.int16)


# ---------------------------------------------------------------------------
# pow / swap
# ---------------------------------------------------------------------------

class PowCC(Block):
    """out = in^exponent / in^div_exp, runtime-settable (baz_pow_cc)."""

    def __init__(self, exponent: float = 1.0, div_exp: float = 0.0,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.e0, self.d0 = float(exponent), float(div_exp)

    def init_params(self):
        return dict(exponent=scalar(self.e0, torch.float32, self.device),
                    div_exp=scalar(self.d0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        e = params["exponent"] - params["div_exp"]
        d = x.data
        mag = d.abs()
        ang = torch.atan2(d.imag, d.real)
        out_mag = torch.where(
            mag > 0, torch.exp(e * torch.log(torch.clamp(mag, min=1e-30))),
            0.0)
        out_ang = ang * e
        y = torch.complex(out_mag * torch.cos(out_ang),
                          out_mag * torch.sin(out_ang)).to(d.dtype)
        return state, (x.like(y, count=x.count),)


class SwapIQ(Block):
    """Swap I and Q, runtime-switchable (baz_swap)."""

    def __init__(self, swap: bool = True, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.swap0 = bool(swap)

    def init_params(self):
        return dict(swap=scalar(self.swap0, torch.bool, self.device))

    def apply(self, state, params, x: Stream):
        swapped = torch.complex(x.data.imag, x.data.real)
        y = torch.where(params["swap"], swapped, x.data)
        return state, (x.like(y, count=x.count),)


# ---------------------------------------------------------------------------
# variable delay (baz_delay)
# ---------------------------------------------------------------------------

class VariableDelay(Block):
    """Runtime-variable delay, zero-filling on increase (baz_delay).

    ``params['delay']`` may change between blocks. When it grows by k the
    first k outputs of the next block are zeros; when it shrinks the
    stream jumps forward. The delayed window is a gather over
    ``arange(n) + start`` with the start on the device.
    """

    def __init__(self, max_delay: int, delay: int = 0,
                 dtype=torch.complex64, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.max_delay = int(max_delay)
        self.delay0 = int(delay)
        self.dtype = dtype
        if not 0 <= delay <= max_delay:
            raise ValueError("delay must be in [0, max_delay]")

    def init_state(self):
        return dict(tail=torch.zeros(self.max_delay, dtype=self.dtype,
                                     device=self.device),
                    prev_delay=scalar(self.delay0, torch.int32, self.device))

    def init_params(self):
        return dict(delay=scalar(self.delay0, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        d = torch.clamp(params["delay"].to(torch.int32), 0, self.max_delay)
        frame = torch.cat([state["tail"], x.data])
        idx = torch.arange(n, dtype=torch.int64, device=frame.device)
        y = frame.index_select(0, idx + (self.max_delay - d))
        grew = torch.clamp(d - state["prev_delay"], min=0)
        y = torch.where(idx < grew, torch.zeros((), dtype=y.dtype,
                                                device=y.device), y)
        new_state = dict(tail=frame[frame.shape[0] - self.max_delay:],
                         prev_delay=d)
        return new_state, (x.like(y, count=x.count),)


# ---------------------------------------------------------------------------
# keep_one_in_n (baz_keep_one_in_n)
# ---------------------------------------------------------------------------

class KeepOneInN(Block):
    """Keep one sample in every n, phase-coherent across blocks
    (baz_keep_one_in_n; n is limited only by the int32 counter)."""

    def __init__(self, n: int, block_size: int, dtype=torch.complex64,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.n = int(n)
        self.block_size = int(block_size)
        self.capacity = block_size // self.n + 1
        self.dtype = dtype

    def init_state(self):
        # the index (within the current block) of the next kept sample
        return dict(phase=scalar(self.n - 1, torch.int32, self.device))

    def apply(self, state, params, x: Stream):
        nb = x.data.shape[0]
        k = torch.arange(self.capacity + 1, dtype=torch.int32,
                         device=x.data.device)
        idx = state["phase"] + k * self.n  # one extra for the next phase
        valid = idx[:self.capacity] < torch.clamp(x.count, max=nb)
        y = x.data.index_select(0, torch.clamp(idx[:self.capacity], 0,
                                               nb - 1))
        mask = valid if y.dim() == 1 else valid[:, None]
        y = torch.where(mask, y, torch.zeros((), dtype=y.dtype,
                                             device=y.device))
        n_out = valid.sum(dtype=torch.int32)
        new_phase = take(idx, n_out) - nb
        return dict(phase=new_phase), (
            x.like(y, count=n_out, rate_scale=1.0 / self.n),)


# ---------------------------------------------------------------------------
# bit (un)packing (baz_unpacked_to_packed_bb)
# ---------------------------------------------------------------------------

def _bit_order(msb_first: bool) -> list:
    """A byte's bit positions in stream order."""
    return list(range(7, -1, -1)) if msb_first else list(range(8))


class UnpackedToPacked(Block):
    """Pack bit-bytes (0/1) into bytes, MSB- or LSB-first."""

    def __init__(self, msb_first: bool = True, name=None, device="cuda"):
        super().__init__(name)
        self.weights = torch.tensor([1 << b for b in _bit_order(msb_first)],
                                    dtype=torch.int32,
                                    device=resolve_device(device))

    def apply(self, state, params, x: Stream):
        n = x.data.shape[0]
        if n % 8:
            raise ValueError("block size must be a multiple of 8")
        bits = (x.data.to(torch.int32) & 1).reshape(-1, 8)
        packed = (bits * self.weights).sum(dim=1).to(torch.uint8)
        count = torch.div(x.count, 8, rounding_mode="floor")
        return state, (x.like(packed, count=count, rate_scale=1.0 / 8),)


class PackedToUnpacked(Block):
    """Unpack bytes into bit-bytes (0/1), MSB- or LSB-first."""

    def __init__(self, msb_first: bool = True, name=None, device="cuda"):
        super().__init__(name)
        self.shifts = torch.tensor(_bit_order(msb_first), dtype=torch.int32,
                                   device=resolve_device(device))

    def apply(self, state, params, x: Stream):
        b = x.data.to(torch.int32)[:, None]
        bits = ((b >> self.shifts[None, :]) & 1).reshape(-1).to(torch.uint8)
        return state, (x.like(bits, count=x.count * 8, rate_scale=8.0),)


class Hysteresis(Block):
    """Two-threshold comparator with memory (gr threshold_ff).

    The output is 1 once the input rises to >= ``high``, 0 once it falls
    to <= ``low``, and holds in between. Each sample takes the value of
    the latest decisive sample (a running max over decisive positions,
    exact, and a gather), the carried state covering a block's head.
    """

    def __init__(self, low: float, high: float, initial: float = 0.0,
                 name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        if high < low:
            raise ValueError("high must be >= low")
        self.low0 = float(low)
        self.high0 = float(high)
        self.initial = 1.0 if initial >= high else 0.0

    def init_state(self):
        return dict(prev=scalar(self.initial, torch.float32, self.device))

    def init_params(self):
        return dict(low=scalar(self.low0, torch.float32, self.device),
                    high=scalar(self.high0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        xd = x.data.to(torch.float32)
        n = xd.shape[0]
        hi = xd >= params["high"]
        lo = xd <= params["low"]
        decisive = (hi | lo) & x.valid_mask()
        idx = torch.arange(n, dtype=torch.int32, device=xd.device)
        last = running_max(torch.where(decisive, idx, -1))
        val = hi.to(torch.float32)
        y = torch.where(last >= 0, val.index_select(0, torch.clamp(
            last, 0, n - 1)), state["prev"])
        iend = torch.clamp(x.count - 1, 0, n - 1)
        new_prev = torch.where(x.count > 0, take(y, iend), state["prev"])
        return dict(prev=new_prev), (x.like(y, count=x.count),)
