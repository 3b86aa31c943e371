"""The DPLL bit synchronizer's walk: CUDA kernel (``csrc/dpll_walk.cu``)
and its plain version.

Replaces the per-sample ``lax.scan`` of ``DPLLBitSync.apply``
(``grbaz_tpu/ops/decode.py:118``). :func:`dpll_walk` walks each row of
``pulses`` [B, n] as an independent stream from the [B] state fields
(``period``, ``phase`` float32; :data:`.decode.DPLL_INTS` int32) and
returns (pulses [B, n] uint8, period estimates [B, n] float32, events
[B, 512, 3] float32, event count [B] int32, the new state). On the card it
launches the kernel, one warp a row, with every float32 rounding written
out as XLA compiles the JAX scan on the CPU: the warp stages the row in
tiles (four samples a lane, two tiles ahead) as a list of pulses, walks
it pulse to pulse (the phase's fadd chain between pulses, the divisions
only on a pulse) and writes the period estimates from each tile's
pulses; on the CPU it runs
:func:`.decode.dpll_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.decode import (DPLL_INTS, DPLL_MAX_EVENTS,
                                        dpll_fuses_gain, dpll_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {"dpll_walk": [_P, _I, _I, _I, _P, _P, _F, _F, _F, _F, _F, _I,
                             _P, _P, _P, _P, _P, _P, _P],
               "dpll_fadd_probe": [_I, _P, _P],
               "dpll_pulse_probe": [_I, _P, _P]}


def _lib():
    return build.library("dpll_walk", _SIGNATURES)


def _launch(lib, pulses, state, gain, relative_limit, ignore_limit, stream):
    """Prepare the arguments, call ``lib.dpll_walk`` and unpack its
    outputs (tensors on ``pulses``'s device; ``lib`` the card's library or
    a CPU rehearsal's)."""
    rows, n = pulses.shape
    dev = pulses.device
    x = pulses if pulses.dtype == torch.uint8 else \
        (pulses != 0).to(torch.uint8)
    x = x.contiguous()
    fin = torch.stack([state[k].reshape(rows).to(torch.float32)
                       for k in ("period", "phase")]).contiguous()
    iin = torch.stack([state[k].reshape(rows).to(torch.int32)
                       for k in DPLL_INTS]).contiguous()
    p_out = torch.empty(rows, n, dtype=torch.uint8, device=dev)
    periods = torch.empty(rows, n, dtype=torch.float32, device=dev)
    events = torch.empty(rows, DPLL_MAX_EVENTS, 3, dtype=torch.float32,
                         device=dev)
    n_ev = torch.empty(rows, dtype=torch.int32, device=dev)
    fout, iout = torch.empty_like(fin), torch.empty_like(iin)
    f = np.float32
    err = lib.dpll_walk(
        x.data_ptr(), n, rows, int(n % 4 == 0 and x.data_ptr() % 4 == 0),
        fin.data_ptr(), iin.data_ptr(),
        f(1.0 - gain), f(gain), f(1.0 - relative_limit),
        f(1.0 + relative_limit), f(ignore_limit),
        int(dpll_fuses_gain(gain, relative_limit)), p_out.data_ptr(),
        periods.data_ptr(), events.data_ptr(), n_ev.data_ptr(),
        fout.data_ptr(), iout.data_ptr(),
        stream)
    build.check(err, "dpll_walk")
    new = dict(period=fout[0], phase=fout[1])
    new.update(zip(DPLL_INTS, iout))
    return p_out, periods, events, n_ev, new


def dpll_walk_kernel(pulses: torch.Tensor, state: dict, gain: float,
                     relative_limit: float, ignore_limit: float):
    """Launch the CUDA kernel: ``pulses`` [B, n] (integers, nonzero = a
    pulse) and ``state`` [B] tensors on one card."""
    if pulses.dim() != 2 or pulses.is_floating_point() or pulses.is_complex():
        raise TypeError(f"pulses must be [B, n] integers, not {pulses.dtype} "
                        f"{tuple(pulses.shape)}")
    if not pulses.is_cuda:
        raise ValueError("pulses must lie on a CUDA device")
    rows, n = pulses.shape
    if n < 1 or n >= 2 ** 31 - 4096 or rows < 1 or rows >= 2 ** 31:
        raise ValueError(f"rows of shape {tuple(pulses.shape)} are not "
                         "walkable")
    for k, v in state.items():
        if v.device != pulses.device:
            raise ValueError(f"{k} must lie on {pulses.device}, not "
                             f"{v.device}")
    out = _launch(_lib(), pulses, state, gain, relative_limit, ignore_limit,
                  torch.cuda.current_stream(pulses.device).cuda_stream)
    dpll_walk.launches += 1
    return out


def dpll_walk(pulses: torch.Tensor, state: dict, gain: float,
              relative_limit: float, ignore_limit: float):
    """The kernel for rows on the card, the plain version for rows on the
    CPU."""
    if pulses.is_cuda:
        return dpll_walk_kernel(pulses, state, gain, relative_limit,
                                ignore_limit)
    return dpll_plain(pulses, state, gain, relative_limit, ignore_limit)


dpll_walk.launches = 0


def fadd_step_ns(steps: int = 1 << 20) -> float:
    """(Benchmark hook.) ns of a sample between pulses, the phase's fadd
    chain alone (the source's ``dpll_fadd_probe``) on the current card."""
    return build.chain_step_ns(_lib(), "dpll_fadd_probe", steps)


def pulse_step_ns(steps: int = 1 << 16) -> float:
    """(Benchmark hook.) ns of a pulse step alone (the source's
    ``dpll_pulse_probe``: the ratio's division, the clamp, the update and
    the new period's reciprocal, back to back) on the current card."""
    return build.chain_step_ns(_lib(), "dpll_pulse_probe", steps)
