"""AGC: single-pole envelope tracker (port of ``grbaz_tpu/ops/agc.py``).

    env_0 = |x_0|                       (first sample ever)
    env_k = env_{k-1}*(1-rate) + |x_k|*rate
    gain_k = reference / env_k
    out_k  = x_k * gain_k

plus the envelope and gain as extra outputs. The recurrence is a
constant-pole one-pole scan (:func:`.iir.onepole_scan`); the carried
state (env, started) is one scalar pair, so blocks chain like a serial
run.
"""

from __future__ import annotations

import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device, scalar
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.iir import onepole_scan, state_at_count


def agc_block(x: torch.Tensor, env0: torch.Tensor, started: torch.Tensor,
              rate: torch.Tensor, reference: torch.Tensor, valid_mask=None):
    """Run the AGC over one block.

    Returns ``(y, env[N], gain[N], env_last, started')``. ``valid_mask``
    (bool [N], a contiguous valid prefix) keeps masked samples out of
    the carried envelope: the recurrence runs unmasked (causality keeps
    the valid prefix exact) and the invalid tail takes the last valid
    envelope. The first sample ever (``started`` false) sets the
    envelope to its magnitude: the incoming state is zeroed and b[0]
    becomes mag[0].
    """
    mag = torch.abs(x).to(torch.float32)
    b = mag * rate
    b = torch.cat([torch.where(started, b[:1], mag[:1]), b[1:]])
    y0 = torch.where(started, env0, torch.zeros_like(env0))
    env_raw = onepole_scan(b, 1.0 - rate, y0)
    if valid_mask is not None:
        count = valid_mask.sum(dtype=torch.int32)
        env_last = state_at_count(env_raw, count, env0)
        env = torch.where(valid_mask, env_raw, env_last)
        any_valid = valid_mask.any()
    else:
        env, env_last = env_raw, env_raw[-1]
        any_valid = torch.ones((), dtype=torch.bool, device=x.device)
    gain = reference / env
    y = x * gain.to(x.dtype) if not x.is_complex() else x * gain
    return y, env, gain, env_last, started | any_valid


class AGC(Block):
    """Streaming AGC block: in (c64 or f32) -> (out, envelope, gain)."""

    n_in = 1
    n_out = 3

    def __init__(self, rate: float = 1e-4, reference: float = 1.0,
                 gain: float = 1.0, max_gain: float = 0.0, name=None,
                 device="cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.rate0 = float(rate)
        self.reference0 = float(reference)
        # gain/max_gain are accepted for API parity: the gain is recomputed
        # from the envelope every sample, so neither is read (as in the
        # JAX package)

    def init_state(self):
        return dict(env=scalar(1.0, torch.float32, self.device),
                    started=scalar(False, torch.bool, self.device))

    def init_params(self):
        return dict(rate=scalar(self.rate0, torch.float32, self.device),
                    reference=scalar(self.reference0, torch.float32,
                                     self.device))

    def apply(self, state, params, x: Stream):
        y, env, gain, env_last, started = agc_block(
            x.data, state["env"], state["started"], params["rate"],
            params["reference"], valid_mask=x.valid_mask())
        new_state = dict(env=env_last, started=started)
        return new_state, (x.like(y, count=x.count),
                           x.like(env, count=x.count),
                           x.like(gain, count=x.count))
