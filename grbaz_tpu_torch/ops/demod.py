"""Demodulation blocks: FM quadrature demod, power squelch, deemphasis
(port of ``grbaz_tpu/ops/demod.py``).

The only carried state is a scalar (previous sample / envelope), and the
first-order recurrences run through :func:`.iir.onepole_scan`.
"""

from __future__ import annotations

import math

import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.iir import onepole_scan, state_at_count


def quadrature_demod(x: torch.Tensor, prev: torch.Tensor, gain) -> tuple:
    """y[n] = gain * arg(x[n] * conj(x[n-1])); returns (y, last_sample)."""
    shifted = torch.cat([prev.reshape(1), x[:-1]])
    prod = x * torch.conj(shifted)
    y = torch.atan2(prod.imag, prod.real).to(torch.float32) * gain
    return y, x[-1]


class QuadratureDemod(Block):
    """FM discriminator. ``gain`` is typically fs/(2*pi*max_deviation)."""

    def __init__(self, gain: float, name=None, device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.gain0 = float(gain)

    def init_state(self):
        return dict(prev=scalar(1.0 + 0.0j, torch.complex64, self.device))

    def init_params(self):
        return dict(gain=scalar(self.gain0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        y, _ = quadrature_demod(x.data, state["prev"], params["gain"])
        # hold prev across a block with no valid data
        last = state_at_count(x.data, x.count, state["prev"])
        return dict(prev=last), (x.like(y, count=x.count),)


class PowerSquelch(Block):
    """Single-pole smoothed-power squelch (gr pwr_squelch equivalent):
    ``avg[n] = avg[n-1]*(1-alpha) + |x[n]|^2 * alpha``; the output is x
    where avg >= threshold, else 0."""

    def __init__(self, threshold_db: float, alpha: float = 1e-4, name=None,
                 device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.threshold0 = 10.0 ** (float(threshold_db) / 10.0)
        self.alpha0 = float(alpha)

    def init_state(self):
        return dict(avg=scalar(0.0, torch.float32, self.device))

    def init_params(self):
        return dict(threshold=scalar(self.threshold0, torch.float32,
                                     self.device),
                    alpha=scalar(self.alpha0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        d = x.data
        p = d.real * d.real + d.imag * d.imag if d.is_complex() else d * d
        alpha = params["alpha"]
        avg_raw = onepole_scan(p.to(torch.float32) * alpha, 1.0 - alpha,
                               state["avg"])
        # count-prefix rule: the invalid tail takes the carried state
        avg_last = state_at_count(avg_raw, x.count, state["avg"])
        avg = torch.where(x.valid_mask(), avg_raw, avg_last)
        y = torch.where(avg >= params["threshold"], d, torch.zeros_like(d))
        return dict(avg=avg_last), (x.like(y, count=x.count),)


class FMDeemphasis(Block):
    """Single-pole IIR deemphasis ``y[n] = b0*x[n] + b1*x[n-1] + a*y[n-1]``:
    the bilinear-transformed RC network with time constant ``tau`` at
    ``sample_rate`` (75 us US / 50 us EU)."""

    def __init__(self, sample_rate: float, tau: float = 75e-6, name=None,
                 device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        w_c = 1.0 / tau
        w_ca = 2.0 * sample_rate * math.tan(w_c / (2.0 * sample_rate))
        k = -w_ca / (2.0 * sample_rate)
        z1 = -1.0
        p1 = (1.0 + k) / (1.0 - k)
        b0 = -k / (1.0 - k)
        self.b = [b0, -z1 * b0]  # feedforward
        self.a = p1  # feedback pole

    def init_state(self):
        return dict(y_prev=scalar(0.0, torch.float32, self.device),
                    x_prev=scalar(0.0, torch.float32, self.device))

    def apply(self, state, params, x: Stream):
        xd = x.data.to(torch.float32)
        x_sh = torch.cat([state["x_prev"].reshape(1), xd[:-1]])
        ff = self.b[0] * xd + self.b[1] * x_sh
        # causal recurrence over a count-prefix stream: the valid prefix
        # is exact, the carried state is y[count-1], and the invalid tail
        # is overwritten with it
        y_raw = onepole_scan(ff, self.a, state["y_prev"])
        y_last = state_at_count(y_raw, x.count, state["y_prev"])
        y = torch.where(x.valid_mask(), y_raw, y_last)
        new_state = dict(y_prev=y_last,
                         x_prev=state_at_count(xd, x.count, state["x_prev"]))
        return new_state, (x.like(y, count=x.count),)
