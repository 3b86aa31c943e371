"""Multi-channel WBFM bank over a ('chan', 'time') mesh (port of
``grbaz_tpu/parallel/wbfm_bank.py``).

* **'chan'**: the same receive chain over C channels, split over the
  dim's ranks with no communication.
* **'time'**: each rank holds a contiguous time slice of every block of
  its channels and receives the filter's tail *halo* from its left
  neighbour (``ppermute``), so the slices' boundaries give the serial
  run's samples.

Carried state that must agree everywhere (the last slice's filter tail,
the discriminator's last sample, the resampler's history) is replicated
from the last time rank. The LO needs no halo: its phase is an exact
function of the global sample index (uint32 arithmetic, ``ops.exact``),
so each time rank computes its slice of the oscillator itself.

The fractional resampler is time-sharded too: its output positions are
exact 32.32 functions of the output index, so every rank computes the
same global position ramp, keeps the outputs whose source index falls
in its own slice, and reads their 8-tap windows from its samples and a
7-sample left halo. The mu advance is the same on every rank. Each rank
holds a ragged number of outputs; :meth:`ShardedWBFMBank.compact_audio`
assembles them on the host.

Data is rank-local: each rank holds its [C / pc, N / pt] shard of a
block (:meth:`shard_input`) and its channels' state and params
(:meth:`shard_state`; ``init_params`` gives the rank's). The channel FIR
runs on the CUDA kernel B3's block entry (``fir_decimate_block``, a
launch a channel row) on the card and on its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from grbaz_tpu_torch.core.device import U32_MASK, scalar
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.cuda.fir_decimate import fir_decimate_block
from grbaz_tpu_torch.ops.fir import low_pass_taps, prepare_taps
from grbaz_tpu_torch.ops.mmse import NSTEPS_LOG2, NTAPS, TAPS_TABLE
from grbaz_tpu_torch.ops.resampler import HIST as RS_HIST
from grbaz_tpu_torch.parallel._collectives import (all_gather, dim,
                                                   mesh_device, ppermute,
                                                   replicate, shard)


@dataclasses.dataclass
class BankConfig:
    channels: int                 # total channels (multiple of chan-mesh size)
    block_size: int               # input samples per channel per step
    sample_rate: float = 3.2e6
    decim: int = 8
    audio_rate: float = 48e3
    max_deviation: float = 75e3
    channel_width: float = 150e3
    transition: float = 75e3

    @property
    def quad_rate(self):
        return self.sample_rate / self.decim

    @property
    def ratio(self):
        return self.quad_rate / self.audio_rate


class ShardedWBFMBank:
    """N-channel WBFM receiver over a ('chan', 'time') mesh.

    One step takes this rank's ``x[C/pc, N/pt]`` complex64 and gives its
    ``audio [C/pc, cap]`` float32 with valid counts ``[C/pc, 1]``: the
    rank's block of JAX's ``(audio [C, pt*cap], counts [C, pt])``.
    """

    def __init__(self, cfg: BankConfig, mesh: DeviceMesh):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.chan_group, self.c_idx, self.pc = dim(mesh, "chan")
        self.time_group, self.t_idx, self.pt = dim(mesh, "time")
        if cfg.channels % self.pc:
            raise ValueError("channels must divide over the chan mesh axis")
        if cfg.block_size % (self.pt * cfg.decim):
            raise ValueError("block_size must divide over time shards * decim")
        taps = low_pass_taps(1.0, cfg.sample_rate,
                             cfg.channel_width / 2 + cfg.transition / 2,
                             cfg.transition)
        self.h_rev_pad = torch.from_numpy(
            prepare_taps(taps, cfg.decim)).to(self.device)
        # the halo carries TPAD samples (one more than the filter
        # history), the tail that fir_decimate_block takes
        self.hist = self.h_rev_pad.shape[0]
        if cfg.block_size // self.pt <= self.hist:
            raise ValueError("time shards too small for filter history")
        self.demod_gain = float(np.float32(
            cfg.quad_rate / (2 * np.pi * cfg.max_deviation)))
        nq = cfg.block_size // cfg.decim
        self.nq = nq
        self.ntq = nq // self.pt  # quad samples per time shard
        if self.ntq <= RS_HIST:
            raise ValueError("time shards too small for resampler history")
        # global ramp capacity (+1 for the next-mu lookup)
        self.rs_cap_global = int(np.ceil(nq / (cfg.ratio * 0.5))) + 1
        # per-shard output capacity (ragged, masked)
        self.audio_capacity = int(np.ceil(self.ntq / (cfg.ratio * 0.5))) + 2
        self.taps_table = torch.from_numpy(TAPS_TABLE).to(self.device)
        # left neighbour -> right, cyclic as in the JAX package (time rank
        # 0 takes the carried state instead of what it receives)
        self.perm = [(i, (i + 1) % self.pt) for i in range(self.pt)]

    # -- state -------------------------------------------------------------
    def init_state(self) -> Dict[str, torch.Tensor]:
        """The global state (every channel) on the mesh's device."""
        C, dev = self.cfg.channels, self.device
        return dict(
            lo_phase=torch.zeros(C, dtype=torch.int64, device=dev),
            fir_tail=torch.zeros(C, self.hist, dtype=torch.complex64,
                                 device=dev),
            demod_prev=torch.ones(C, dtype=torch.complex64, device=dev),
            rs_tail=torch.zeros(C, RS_HIST, dtype=torch.float32, device=dev),
            rs_mu_int=torch.full((C,), RS_HIST, dtype=torch.int32,
                                 device=dev),
            rs_mu_frac=torch.zeros(C, dtype=torch.int64, device=dev),
        )

    def shard_state(self, state) -> Dict[str, torch.Tensor]:
        """This rank's channels of a global state (JAX's
        ``state_shardings``: every leaf split over 'chan')."""
        return {k: shard(v, self.mesh, "chan") for k, v in state.items()}

    def shard_input(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's [C/pc, N/pt] block of a global [C, N] block (JAX's
        ``input_sharding``)."""
        return shard(shard(x, self.mesh, "chan"), self.mesh, "time", axis=1)

    def init_params(self, center_freqs):
        """center_freqs: [C] station offsets in Hz; the params of this
        rank's channels."""
        cfg = self.cfg
        lo_inc = torch.tensor(
            [int(exact.freq_to_turns_u32(-f, cfg.sample_rate))
             for f in center_freqs], dtype=torch.int64, device=self.device)
        ip, fr = exact.ratio_to_fixed(cfg.ratio)
        return dict(lo_inc=shard(lo_inc, self.mesh, "chan"),
                    rs_inc_int=scalar(int(ip), torch.int32, self.device),
                    rs_inc_frac=scalar(int(fr), torch.int64, self.device))

    # -- the step ------------------------------------------------------------
    def step(self, state, params, x):
        """Rank-local: (state', (audio [C/pc, cap], counts [C/pc, 1]))."""
        cfg, pt, t_idx = self.cfg, self.pt, self.t_idx
        group = self.time_group
        lo_phase, lo_inc = state["lo_phase"], params["lo_inc"]
        Cl, Nt = x.shape

        # --- exact LO slice: phase = phase0 + (t_idx*Nt + j)*inc ---
        base = (lo_phase + ((t_idx * Nt) & U32_MASK) * lo_inc) & U32_MASK
        j = torch.arange(Nt, dtype=torch.int64, device=x.device)
        xr = x * exact.lo_at(base[:, None], lo_inc[:, None], j)

        # --- halo: the left neighbour's last TPAD rotated samples ---
        from_left = ppermute(xr[:, -self.hist:], self.perm, group)
        carry_tail = state["fir_tail"] if t_idx == 0 else from_left

        # --- channel FIR + decimate (the kernel's block entry a row) ---
        y = torch.stack([fir_decimate_block(xr[c], carry_tail[c],
                                            self.h_rev_pad, cfg.decim)
                         for c in range(Cl)])

        # --- FM discriminator with a 1-sample halo ---
        prev_from_left = ppermute(y[:, -1], self.perm, group)
        prev = state["demod_prev"] if t_idx == 0 else prev_from_left
        shifted = torch.cat([prev[:, None], y[:, :-1]], dim=1)
        prod = y * torch.conj(shifted)
        quad = torch.atan2(prod.imag, prod.real).to(torch.float32) \
            * self.demod_gain

        # --- time-sharded fractional resampler ---
        audio, counts, mu_int, mu_frac = self._resample_local(
            quad, state, params)

        # --- new carries, replicated from the last time rank ---
        last = pt - 1
        new_state = dict(
            lo_phase=(lo_phase + cfg.block_size * lo_inc) & U32_MASK,
            fir_tail=replicate(xr[:, -self.hist:], last, group),
            demod_prev=replicate(y[:, -1], last, group),
            rs_tail=replicate(quad[:, -RS_HIST:], last, group),
            rs_mu_int=mu_int, rs_mu_frac=mu_frac)
        return new_state, (audio, counts[:, None])

    def _resample_local(self, quad, state, params):
        """This rank's outputs of the resampler over the global block.

        Every rank computes the same global position ramp, keeps the
        outputs whose source index lands in its slice, and reads their
        windows from (left halo + its samples). Returns (audio [Cl,
        cap], counts [Cl] int32, mu_int [Cl] int32, mu_frac [Cl]); the
        mu update is the same on every rank.
        """
        ntq, nq = self.ntq, self.nq
        cap_g, cap_l = self.rs_cap_global, self.audio_capacity
        Cl = quad.shape[0]
        halo = ppermute(quad[:, -RS_HIST:], self.perm, self.time_group)
        left = state["rs_tail"] if self.t_idx == 0 else halo
        frame = torch.cat([left, quad], dim=1)             # [Cl, ntq + 7]
        base = self.t_idx * ntq

        idx, frac = exact.fixed_positions(
            cap_g + 1, state["rs_mu_frac"][:, None], params["rs_inc_int"],
            params["rs_inc_frac"])
        idx = idx + state["rs_mu_int"].to(torch.int64)[:, None]
        ig = idx[:, :cap_g]
        valid_g = ig <= nq - 1
        own = valid_g & (ig >= base) & (ig < base + ntq)
        taps = self.taps_table[exact.frac_to_phase_bin(frac[:, :cap_g],
                                                       NSTEPS_LOG2)]
        off = torch.clamp(ig - base, 0, ntq - 1)
        win_idx = off[:, :, None] + torch.arange(NTAPS, device=quad.device)
        win = torch.gather(frame, 1, win_idx.reshape(Cl, -1)).reshape(
            Cl, cap_g, NTAPS)
        yv = torch.where(own, (win * taps).sum(dim=2), 0.0)
        # compact the owned outputs to the front of the rank's buffer
        pos = torch.cumsum(own, dim=1) - 1
        slot = torch.where(own, torch.clamp(pos, 0, cap_l - 1), cap_l - 1)
        out = torch.zeros(Cl, cap_l, dtype=torch.float32, device=quad.device)
        out.scatter_add_(1, slot, yv)
        counts = torch.clamp(own.sum(dim=1), max=cap_l).to(torch.int32)
        # the mu advance, the same on every rank
        n_out_g = valid_g.sum(dim=1, keepdim=True)
        mu_int = (torch.gather(idx, 1, n_out_g) - nq).to(torch.int32)[:, 0]
        mu_frac = torch.gather(frac, 1, n_out_g)[:, 0]
        return out, counts, mu_int, mu_frac

    def compact_audio(self, audio, counts) -> List[np.ndarray]:
        """Every rank's audio (rank-local ``step`` outputs) gathered over
        the mesh and compacted on the host: a list of C [n_c] arrays, on
        every rank."""
        a = all_gather(all_gather(audio, self.time_group), self.chan_group)
        n = all_gather(all_gather(counts, self.time_group), self.chan_group)
        C, cap = self.cfg.channels, self.audio_capacity
        # [pc, pt, Cl, ...] -> [C, pt, ...]
        a = a.permute(0, 2, 1, 3).reshape(C, self.pt, cap).cpu().numpy()
        n = n.permute(0, 2, 1, 3).reshape(C, self.pt).cpu().numpy()
        return [np.concatenate([a[c, s, :n[c, s]] for s in range(self.pt)])
                for c in range(C)]
