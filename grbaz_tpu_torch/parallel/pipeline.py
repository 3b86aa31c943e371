"""Pipeline parallelism: a flowgraph chain split into stages over a
'stage' mesh dim (port of ``grbaz_tpu/parallel/pipeline.py``).

Each rank of the dim owns one segment of the chain. Microbatches of
samples flow left to right (``ppermute``): after the S-1-tick fill every
rank computes every tick (the GPipe schedule). A rank knows its stage
on the host, so it runs only its own stage function, where the JAX
package's traced program switches over all of them; bubble ticks
(fill and drain) run no stage at all and post no transfer, where JAX
runs the stage on zeros and keeps its state.

Contracts, as in the JAX package:

* every stage is ``fn(state_s, buf) -> (state_s', buf')`` over a common
  fixed-shape float32 buffer (``buf_shape``); stages encode their real
  dtypes into it (complex as two planes, counts in a lane);
* every rank holds a copy of every stage's state, but only the owner's
  evolves; after a run each stage's state and the outputs are
  replicated from their owner rank, so the returned values agree on
  every rank;
* microbatches are consecutive time blocks, so carried DSP state (filter
  tails, phase, mu) chains as in the serial graph.

An optional 'data' mesh dim runs B independent streams through the same
pipeline (dp x pp): a rank holds its B / dp streams (:meth:`shard`),
every buffer and state leaf gains a leading stream dim, and the stage
runs once per stream.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from grbaz_tpu_torch.core.device import scalar
from grbaz_tpu_torch.ops import exact
from grbaz_tpu_torch.ops.cuda.fir_decimate import fir_decimate_block
from grbaz_tpu_torch.ops.iir import onepole_scan, state_at_count
from grbaz_tpu_torch.ops.mmse import TAPS_TABLE
from grbaz_tpu_torch.ops.resampler import HIST as RS_HIST
from grbaz_tpu_torch.ops.resampler import resample_block
from grbaz_tpu_torch.parallel._collectives import (dim, mesh_device,
                                                   ppermute, replicate, shard)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, tuples and lists, dict keys
    in sorted order (the same on every rank, however a stage built its
    state)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in sorted(t)}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaf(a, device) -> torch.Tensor:
    """A numpy or python leaf as a tensor on ``device`` (uint32 as int64,
    the port's convention)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


class StagePipeline:
    """Run S stage functions as a pipeline over the mesh dim ``stage_axis``.

    Args:
      stage_fns: S callables ``(state, buf[*buf_shape]) -> (state', buf')``.
      init_states: S pytrees (numpy leaves): each stage's initial state.
      buf_shape: common inter-stage buffer shape (float32).
      mesh: a mesh with a ``stage_axis`` dim of size S (and optionally a
        ``data_axis`` dim for stream batches).
      data_axis: the stream-batch dim's name, or None. When set, ``run``
        takes this rank's microbatches ``[Bl, M, *buf_shape]`` and states
        with a leading ``[Bl, ...]`` dim; each stream is independent.

    ``ticks`` is the number of schedule ticks the last ``run`` took on
    this rank (M + S - 1).
    """

    def __init__(self, stage_fns: Sequence[Callable],
                 init_states: Sequence[Any], buf_shape: Tuple[int, ...],
                 mesh: DeviceMesh, stage_axis: str = "stage",
                 data_axis: str | None = None):
        self.stage_fns = list(stage_fns)
        self.S = len(self.stage_fns)
        self.group, self.stage, size = dim(mesh, stage_axis)
        if size != self.S:
            raise ValueError(
                f"mesh axis '{stage_axis}' has {size} devices but {self.S} "
                "stages were given")
        self.init_states_np = tuple(init_states)
        self.buf_shape = tuple(buf_shape)
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.stage_axis = stage_axis
        self.data_axis = data_axis
        self.ticks = 0

    # -- state -------------------------------------------------------------
    def init_states(self, batch: int | None = None):
        """Initial state tuple on the mesh's device; with ``batch`` each
        leaf gains a leading [B] dim (every stream, before :meth:`shard`)."""
        states = _tree_map(lambda a: _leaf(a, self.device),
                           self.init_states_np)
        if batch is None:
            return states
        return _tree_map(lambda a: a[None].expand((batch,) + a.shape)
                         .contiguous(), states)

    def shard(self, tree):
        """This rank's streams of a batched tree (states or
        microbatches): dim 0 split over the data dim, as JAX's
        ``P('data')``. Without a data dim, the tree itself."""
        if self.data_axis is None:
            return tree
        return _tree_map(lambda a: shard(a, self.mesh, self.data_axis), tree)

    # -- the schedule --------------------------------------------------------
    def _apply(self, fn, st, buf):
        if self.data_axis is None:
            return fn(st, buf)
        res = [fn(_tree_map(lambda a, b=b: a[b], st), buf[b])
               for b in range(buf.shape[0])]
        return (_tree_map(lambda *a: torch.stack(a), *(r[0] for r in res)),
                torch.stack([r[1] for r in res]))

    def run(self, states, microbatches):
        """states: the stage tuple; microbatches [M, *buf_shape] float32
        (or [Bl, M, *buf_shape] with a data dim), the same on every stage
        rank. Returns (states', outputs) of the same shapes, where
        outputs[m] = chain(microbatches[m]), on every stage rank."""
        S, s = self.S, self.stage
        batched = self.data_axis is not None
        mb = microbatches
        M = mb.shape[1] if batched else mb.shape[0]
        bshape = ((mb.shape[0],) if batched else ()) + self.buf_shape
        states = list(states)
        fn = self.stage_fns[s]
        cur = torch.zeros(bshape, dtype=torch.float32, device=self.device)
        outs = []
        self.ticks = 0
        for t in range(M + S - 1):
            if s == 0:
                cur = mb[:, min(t, M - 1)] if batched else mb[min(t, M - 1)]
            # rank s runs microbatch t - s; outside [0, M) the tick is a
            # fill or drain bubble
            if 0 <= t - s < M:
                states[s], cur = self._apply(fn, states[s], cur)
                if s == S - 1:
                    outs.append(cur)
            # shift right; only a stage that ran hands its buffer on (the
            # next stage's next tick is a bubble exactly when this one was)
            perm = [(i, i + 1) for i in range(S - 1) if 0 <= t - i < M]
            cur = ppermute(cur, perm, self.group)
            self.ticks += 1

        states = tuple(_tree_map(lambda a, i=i: replicate(a, i, self.group),
                                 states[i]) for i in range(S))
        if s == S - 1:
            out = torch.stack(outs, dim=1 if batched else 0)
        else:
            shape = ((mb.shape[0], M) if batched else (M,)) + self.buf_shape
            out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return states, replicate(out, S - 1, self.group)


# ---------------------------------------------------------------------------
# the flagship demo: the WBFM chain as a 4-stage pipeline
# ---------------------------------------------------------------------------

def _wbfm_stages(cfg, device):
    """The WBFM receive chain (``models/wbfm.py``, fractional audio) as
    four stage functions over one float32 buffer [2, N]: channelize | FM
    demod (with the power squelch where ``cfg.squelch_db`` is set) |
    fractional resample | deemphasis. Returns ``(stage_fns,
    init_states, buf_shape)``. The channel stage's FIR is the CUDA
    kernel B3's block entry (``fir_decimate_block``) over the rotated
    block and the carried rotated tail on the card, its plain version on
    the CPU."""
    from grbaz_tpu_torch.ops.demod import FMDeemphasis
    from grbaz_tpu_torch.ops.fir import low_pass_taps, prepare_taps

    N = cfg.block_size
    decim = cfg.decim
    nq = N // decim
    fs = cfg.sample_rate
    quad_rate = fs / decim
    ratio = quad_rate / cfg.audio_rate
    cap = int(math.ceil(nq / (ratio * 0.5))) + 1
    if cap + 1 > N:
        raise ValueError("block too small for the audio capacity lane")

    taps = low_pass_taps(1.0, fs, cfg.channel_width / 2 + cfg.transition / 2,
                         cfg.transition)
    h_rev_pad = torch.from_numpy(prepare_taps(taps, decim)).to(device)
    hist = h_rev_pad.shape[0] - 1
    demod_gain = float(np.float32(quad_rate / (2 * np.pi * cfg.max_deviation)))
    lo_inc = scalar(int(exact.freq_to_turns_u32(-cfg.center_freq, fs)),
                    torch.int64, device)
    rs_ip, rs_fr = exact.ratio_to_fixed(ratio)
    rs_ip = scalar(int(rs_ip), torch.int32, device)
    rs_fr = scalar(int(rs_fr), torch.int64, device)
    taps_table = torch.from_numpy(TAPS_TABLE).to(device)
    deemph = FMDeemphasis(cfg.audio_rate, cfg.deemph_tau, device=device)
    de_b0, de_b1 = float(np.float32(deemph.b[0])), float(np.float32(deemph.b[1]))
    de_a = float(np.float32(deemph.a))
    lanes = torch.arange(cap, dtype=torch.int32, device=device)

    # plane 0 / plane 1 = re / im (complex stages) or data / aux (real
    # stages); the audio count rides in buf[1, N-1] as a float
    buf_shape = (2, N)

    def blank():
        return torch.zeros(buf_shape, dtype=torch.float32, device=device)

    def stage_channel(state, buf):
        x = torch.complex(buf[0], buf[1])
        lo, phase2 = exact.oscillator(N, state["phase"], lo_inc)
        xr = x * lo
        y = fir_decimate_block(xr, state["tail"], h_rev_pad, decim)
        out = blank()
        out[0, :nq] = y.real
        out[1, :nq] = y.imag
        return dict(tail=xr[-(hist + 1):], phase=phase2), out

    squelch_thr = None
    if cfg.squelch_db is not None:
        squelch_thr = float(np.float32(10.0 ** (float(cfg.squelch_db) / 10.0)))
        squelch_alpha = np.float32(1e-4)

    def stage_demod(state, buf):
        y = torch.complex(buf[0, :nq], buf[1, :nq])
        st = {}
        if squelch_thr is not None:
            # power squelch before the discriminator (the serial chain's
            # order: channel -> squelch -> demod)
            p = y.real * y.real + y.imag * y.imag
            avg = onepole_scan(p * float(squelch_alpha),
                               float(1.0 - squelch_alpha), state["sq_avg"])
            y = torch.where(avg >= squelch_thr, y, torch.zeros_like(y))
            st["sq_avg"] = avg[-1]
        shifted = torch.cat([state["prev"].reshape(1), y[:-1]])
        prod = y * torch.conj(shifted)
        quad = torch.atan2(prod.imag, prod.real) * demod_gain
        out = blank()
        out[0, :nq] = quad
        st["prev"] = y[-1]
        return st, out

    def stage_resample(state, buf):
        frame = torch.cat([state["tail"], buf[0, :nq]])
        y, n_out, mu_i, mu_f = resample_block(
            frame, state["mu_int"], state["mu_frac"], rs_ip, rs_fr, cap,
            taps_table)
        out = blank()
        out[0, :cap] = y
        out[1, N - 1] = n_out.to(torch.float32)
        return dict(tail=frame[-RS_HIST:], mu_int=mu_i, mu_frac=mu_f), out

    def stage_deemph(state, buf):
        xd = buf[0, :cap]
        n_out = buf[1, N - 1].to(torch.int32)
        x_sh = torch.cat([state["x_prev"].reshape(1), xd[:-1]])
        ff = de_b0 * xd + de_b1 * x_sh
        # causality keeps the valid prefix exact despite the unmasked
        # drive past the count
        yv = onepole_scan(ff, de_a, state["y_prev"])
        st = dict(y_prev=state_at_count(yv, n_out, state["y_prev"]),
                  x_prev=state_at_count(xd, n_out, state["x_prev"]))
        out = blank()
        out[0, :cap] = torch.where(lanes < n_out, yv, 0.0)
        out[1, N - 1] = n_out.to(torch.float32)
        return st, out

    demod_state = dict(prev=np.complex64(1.0 + 0.0j))
    if squelch_thr is not None:
        demod_state["sq_avg"] = np.float32(0.0)
    init_states = (
        dict(tail=np.zeros(hist + 1, np.complex64), phase=np.uint32(0)),
        demod_state,
        dict(tail=np.zeros(RS_HIST, np.float32),
             mu_int=np.int32(RS_HIST), mu_frac=np.uint32(0)),
        dict(y_prev=np.float32(0.0), x_prev=np.float32(0.0)),
    )
    return ([stage_channel, stage_demod, stage_resample, stage_deemph],
            init_states, buf_shape)


def build_wbfm_pipeline(cfg, mesh: DeviceMesh, stage_axis: str = "stage",
                        data_axis: str | None = None):
    """The WBFM receive chain split into 4 pipeline stages over the mesh
    dim ``stage_axis`` (which must have 4 ranks): channelize | FM demod |
    fractional resample | deemphasis.

    Returns ``(pipeline, encode, decode)``: ``encode(iq[N]) -> buf``
    packs an input microbatch on the mesh's device and ``decode(buf) ->
    (audio, count)`` unpacks the last stage's output on the host. cfg is
    a ``models.wbfm.WBFMConfig``.
    """
    device = mesh_device(mesh)
    fns, init_states, buf_shape = _wbfm_stages(cfg, device)
    pipe = StagePipeline(fns, init_states, buf_shape, mesh,
                         stage_axis=stage_axis, data_axis=data_axis)
    N = cfg.block_size

    def encode(iq) -> torch.Tensor:
        iq = torch.as_tensor(iq).to(device)
        return torch.stack([iq.real, iq.imag]).to(torch.float32)

    def decode(buf):
        buf = torch.as_tensor(buf).cpu()
        n = int(buf[1, N - 1])
        return buf[0, :n].numpy(), n

    return pipe, encode, decode
