#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``grbaz_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA card and the CUDA toolkit (``nvcc``); the first run builds
the kernels from ``grbaz_tpu_torch/csrc`` (one ``nvcc`` per source, all
started together). Imports nothing of JAX or ``grbaz_tpu``. Phases, any
failure of which exits non-zero:

1. report the card, its power limit and the versions; build the kernels;
2. hold every kernel against its plain PyTorch version at the main
   path's shapes (max-abs error < 1e-5 * max|plain|); K3 at every
   constraint length from 2 to 12 and 15 (``viterbi_lengths_phase``),
   and viterbi_decode, ViterbiDecoder and AutoFEC at K = 2 and 10 on the
   card against the CPU;
3. the main path: the cascade WBFM receiver at 2^20-sample blocks,
   8 chained blocks of a synthesized FM station through the Flowgraph
   step with the kernels, launch counts set to 0 just before and read
   just after; the same run on the plain backend must agree, and the
   1 kHz test tone must come back (frequency and SINAD);
4. the host-fed StreamExecutor with a retune and a partial last block;
5. the fused path: ``WBFMConfig(fused=True)`` (WBFMFrontend on the
   rotated-taps kernel B2) over the same 8 blocks, without and with a
   squelch, counted like phase 3; against its plain backend, the tone,
   and the unfused fractional chain (B1) on ``quad``;
6. StreamPump over the fused chain, 16 host blocks at ``inflight`` 1 and
   3, against the Flowgraph run; ``dispatch`` returning while the card
   is busy; a checkpoint after block 8 restored into a fresh executor;
7. times from CUDA events after warm-up: each kernel, its plain version
   and the one-call library equivalent where there is one, beside its
   bound and the launch floor (a back-to-back empty kernel); the WBFM
   chains' step times and torch.profiler breakdowns (``chiprun_out/``);
   the resampler's two forms;
8. the other BASELINE configurations, each driven through its entry
   points over several blocks, its launches counted like phase 3, its
   first block(s) run again by the port on the CPU and held to the card
   at the CPU tests' tolerances: config 1 (resampler 250e3/48e3 -> AGC,
   2^20-sample blocks; |out| settles to the reference), config 3
   (``build_spectrum`` at 4096 bins with and without the waterfall, a
   tone in its bin at 0 dBFS; ``build_fac`` at its defaults;
   ``PeakDetector(min_diff=0.1)`` marking planted peaks), config 4
   (``MusicDOA(8, 1, 512)`` over 256 frames, planted angles found within
   1 degree) and config 5 (the 16-slot ``DynamicChannelBank`` at 2^17
   blocks on the bank's kernel ``csrc/channel_bank.cu``, one launch a
   step and no LO computed on the host, against its plain backend, with
   an add, a removal and a retune mid-run, and an FM tone that comes back
   on its slot), then timed and profiled like the chains;
9. the burst path (``burst_path``): TimeKeeper, Gate (retriggerable and
   not), RadarDetector, BurstTagger -> BurstBuffer, Burster -> Merge,
   two Correlators (127-tap FFT and 63-tap direct) and the lockout
   PeakDetector on the FSM kernel (``csrc/peak_fsm.cu``, one launch a
   block), over 8 blocks of 2^20 samples with planted pulses and syncs
   from absolute sample 2^32 - 2^19 (the limb carry mid-run); every
   pulse and sync found at its exact absolute start, no peak marked in
   the pulses planted inside a lockout, blocks 0-1 held to
   the port on the CPU (event rows, limbs, lengths, marks, idx_diff and
   the gated signal bit for bit; correlation surfaces within 1e-5 of the
   max; radar sums within 1e-5 relative), then timed and profiled.

10. the AM receiver (``am_path``, ``apps/am_fft.py``'s graph): 8 blocks
    of 2^20 samples at 1.024 Msamp/s through the channel block (B1 at
    decim 16, 493 taps), AMDemod and the ratio-stream
    VariableRatioResampler (kernel ``csrc/vrr_walk.cu``, one launch a
    block) fed a 64/48 ratio stream into 48 kHz audio, with a spectrum of
    the channel; the tone back within 5 Hz above 30 dB SINAD, the station
    in its bin, blocks 0-1 against the CPU (counts, q_int and mu_frac
    equal, audio within 1e-5 of the max), and an overrun raised as on the
    CPU; then timed and profiled;
11. the FasTrak decoder (``fastrak_path``): 8 blocks of 2^20 samples of
    a tag's OOK replies at 4 Msamp/s (24 frames a block, IDs in runs, a
    bad CRC, a near-sync decoy, a frame across a block boundary) through
    the envelope, a matched filter of the sync word (B3 at decim 1), an
    alignment delay and FastrakDecoder (kernel ``csrc/fastrak_fsm.cu``,
    one launch a block); every passing ID and count found, K1 bit-equal
    to its plain version on blocks 0-1's card-computed inputs, the CPU
    path the same IDs; then timed and profiled;
12. the FEC path (``fec_path``): AutoFEC over blocks of 2^16 QPSK
    symbols of a K=7 (171, 133) coded stream that the channel rotated and
    conjugated: the search steps to the transform that undoes it and
    locks, then 8 blocks decode (kernel ``csrc/viterbi.cu``, one launch a
    block) to the planted bits up to the code's complement;
    ViterbiDecoder(overlap=96) over the same soft pairs in 8 blocks, blocks
    0-1 bit-equal to the CPU; fec_eval on 2^14 symbols card against CPU
    (bits and BER equal); GLFSRSource -> 1% flips -> PNBERv at 2^20 bits a
    block (no kernel), its estimate inside the JAX test's bar and within
    1e-6 of the CPU's; then timed and profiled;
13. the decoders path (``decoders_path``): ACARSDecoder
    (``csrc/acars_fsm.cu``), ManchesterDecode (``csrc/manchester_fsm.cu``)
    and two DPLLBitSyncs (``csrc/dpll_walk.cu``), each a one-block graph
    over 8 blocks of 2^14: every planted ACARS packet with its bytes (one
    across a block boundary, one printed through ``utils/acars.py``), the
    Manchester bits after a dropped chip's resync, the DPLL estimates at
    periods 100.3 and 16.0; blocks 0-1 bit-equal to the CPU; timed and
    profiled;
14. every block of ``ops/basic.py`` and ``ops/misc.py`` in a one-block
    graph on the card against the CPU (``small_blocks_phase``);
15. the P25 receiver (``p25_path``): 8 blocks of 2^19 samples at 1.536
    Msamp/s (an RTL dongle) holding wire LDUs from ``make_wire_ldu``
    (clear, and DES-OFB under two KIDs) between random dibits,
    C4FM-modulated at the wideband rate at +200 kHz with noise, through
    the channel block (B1 at decim 32, 768 taps, one launch a block) in
    front of ``build_p25_rx`` at its defaults; every LDU found at its
    index (plus the chain's one-symbol delay) with its NAC and DUID,
    ``P25WireVoiceDecoder`` recovering every codeword's bits with the
    right keys and garbling the encrypted ones with the keys swapped;
    blocks 0-1 against the CPU (the channel and the soft symbols within
    1e-5 of their max, dibits and frame events equal); timed in Msamp/s
    of wideband input and profiled;
16. the Audio FMCW radar (``fmcw_path``): ``build_fmcw`` at the demo's
    widths (48 kHz, 2-8 kHz sweeps of 1024) over 4 blocks of 2^20
    samples of two echoes plus noise (no kernel): both echoes in their
    beat bins, ``tx`` equal to ``chirp_iq``'s real part, block 0 against
    the CPU (``beat`` and ``tx`` within 1e-6, the range magnitudes within
    1e-5 of each sweep's full scale), a run across the deramp counter's
    2^32 wrap whose counters equal the CPU's; timed and profiled;
17. the multi-device patterns (``parallel_path``) on a one-rank NCCL
    process group (a file rendezvous, destroyed after the phase), each
    module on a one-rank "cuda" ``DeviceMesh``: the ``(chan, time)``
    ``ShardedWBFMBank`` (8 channels of 2^20 at 3.2 Msamp/s, an FM
    station with a 1 kHz tone on each at linspace(-1.2, 1.2) MHz, 8
    blocks; B3's block entry a channel row) against the serial chain on
    the card (above 80 dB, tones within 5 Hz) and blocks 0-1 against the
    port on a gloo "cpu" mesh (audio within 1e-5 of the max; counts,
    ``lo_phase`` and mu equal); ``TPFIRDecimator`` at tp = 1 (1025 taps,
    decim 4, 8 blocks of 2^20 real samples; B3's frame entry) within 1e-6
    of ``FIRDecimator``; ``sharded_music_spectrum`` at dev = 1 (8
    antennas, 512 snapshots, 360 angles, two sources) within 0.2 dB of
    ``music_spectrum``, peaks within 1 degree; ``StagePipeline`` of one
    stage chaining the four WBFM stage functions (8 microbatches of
    2^20; B3's block entry) above 100 dB against ``build_wbfm``, the tone
    back; each timed (Mchansamp/s, Msamp/s, scans/s) and profiled;
18. the main path fed from the wire (``ingest_path``): an FM station
    quantized to BorIP ishort and sent over loopback UDP at the RTL rate
    (3.2 Msamp/s, 2 s, packets of DEFAULT_PAYLOAD) in this process to the
    port's UDPSampleReceiver (its native engine asserted), whose
    ``WireSource`` keeps every read until it holds a 2^20 block and hands
    on the partial last one with its count, through
    ``StreamPump(drop=True, inflight=3)`` into the cascade chain (B1, B3);
    no packet dropped, no pump overrun, every block out, the audio
    bit-equal to the Flowgraph over the same samples, the tone within 5
    Hz above 40 dB; prints the wall-clock rate, each block's latency (its
    last packet sent to its audio delivered), the card's idle share (a
    profiled rerun), then a sweep of faster and unpaced sends (the
    highest rate that arrived with no drop, the drops at the fastest);
19. every ported app through its ``main(argv)`` (``apps_phase``) with
    ``--device cuda`` and again with ``--device cpu`` on the same argv:
    ``rtl_fm`` from ``--synth``, ``--borip`` (the port's BorIPServer
    serving a FileDevice of the station paced at 3.2 Msamp/s; the
    client's drops read) and ``--input``, ``am_fft``, ``realtime_fft
    --synth``, ``fac``, ``scanner`` and ``papr`` at their defaults; the
    outputs agree with the CPU's (WAVs within 3 LSB, dB CSVs within a
    printed LSB or 1e-4 of the frame's peak, images within a gradient
    level, stdout equal), the tones, carrier and stations found; each
    app's wall time and step time (CUDA events around each dispatch).

The FSM kernel's cases run at the burst path's [1, 2^20] (its row) and
at the decoder-bank shape [64, 2^14], the latter also with a smoothed
average and a look-ahead; each is held to its plain version over two
chained calls (marks, idx_diff and the carried state equal) on pulses
that fall inside lockouts, with a lockout that crosses the calls. A
fourth case forces a miss in every chunk of the speculative walk
(sawtooth ramps that span many chunks, a lockout longer than the
warm-up): the kernel's worst case, held to the same checks. Each case
prints the chunks the kernel walked again; its bound is its bytes.

The FasTrak kernel's cases run at its path's [1, 2^20], at the decoder
bank's [64, 2^14] and with the sync stream held high (nearly every chunk
walked again, its worst case); the ratio-stream kernel at the AM path's
2^16-sample f32 block, its walk's chain bound printed beside it.

The decoders' kernels: K3 (Viterbi) at [2^16, 2] (an AutoFEC block) and
[2^16 + 96, 2] (a ViterbiDecoder block with its overlap), bits and final
path metrics; K4-K6 (ACARS, Manchester, DPLL) at [1, 2^14] and at the JAX
benchmark's bank [64, 2^14], outputs and the whole state; K4 also on
noise at threshold 8 and on edge rows (packets open across the calls at
every bit of a byte, syncs found only with the carried register, DEL at
etx + 2, a candidate on a packet's last bit); K5 also on random chips at
windows 1 and 31, thresholds 0 and window + 1, both ``original`` (a row
of alternating chips past the capacity); K6 also on the decoders path's
two pulse trains and on edge rows (no pulse, a pulse at sample 0, past
512 events, pulses at tile edges) with and without the fused gain
product; each bit-equal to its plain version over two chained calls, and
printed beside its chain bound (timed alone by each source's probes:
K3's steps times one dependent step; K4's staging bytes plus its syncs
times a packet of the least length; K5's 64-sample head plus a map
lookup a chunk; K6's samples times a fadd plus its pulses times a pulse
step).

B1's row counts the launches of the cascade chain, the P25 path, the
ingest path and the apps (rtl_fm's three runs, am_fft); the bank's those
of config 5 and the scanner app;
its cases also run at the AM shape (decim 16) and the P25 shape (decim
32, 768 taps, 2^14 outputs). B3's row counts the launches of both its
entry points, over the cascade chain, the parallel path (the bank's
64, the TP FIR's 8 and the pipeline's 8) and the ingest path, and times
the block entry
point, which the cascade chain's
``FIRDecimator`` launches; the frame entry point is timed on the
``time`` lines only.

The last lines are the kernel table as JSON, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from grbaz_tpu_torch.apps import (am_fft, fac, papr, realtime_fft, rtl_fm,
                                  scanner)
from grbaz_tpu_torch.core.block import FnBlock
from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.pump import StreamPump
from grbaz_tpu_torch.core.stream import (Stream, StreamMeta, decode_abs_index,
                                         decode_i32, stream_flags)
from grbaz_tpu_torch.models.auto_fec import (_ROTATIONS, AutoFEC, fec_eval,
                                             reencode)
from grbaz_tpu_torch.models.fmcw import (FMCWConfig, build_fmcw, chirp_iq,
                                         simulate_echo)
from grbaz_tpu_torch.models.p25 import P25Config, build_p25_rx, c4fm_modulate
from grbaz_tpu_torch.models.p25_voice import (ALGID_CLEAR, ALGID_DES_OFB,
                                              WIRE_LDU_DIBITS,
                                              P25WireVoiceDecoder,
                                              make_wire_ldu)
from grbaz_tpu_torch.models.spectral import (FACConfig, SpectralConfig,
                                             build_fac, build_spectrum)
from grbaz_tpu_torch.models.wbfm import WBFMConfig, WBFMFrontend, build_wbfm
from grbaz_tpu_torch.ops import basic, decode, doa, exact, fec, fir, misc
from grbaz_tpu_torch.ops.agc import AGC
from grbaz_tpu_torch.ops.burst import (BurstBuffer, Burster, BursterConfig,
                                       BurstTagger, Gate, Merge, TimeKeeper,
                                       decode_abs_events)
from grbaz_tpu_torch.net import borip_client, udp
from grbaz_tpu_torch.net.borip_server import BorIPServer
from grbaz_tpu_torch.ops.colour import Colouriser, thermal_gradient
from grbaz_tpu_torch.ops.detect import Correlator, PeakDetector, RadarDetector
from grbaz_tpu_torch.ops.cuda import acars_fsm as af
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.cuda import channel_bank as cb
from grbaz_tpu_torch.ops.cuda import dpll_walk as dw
from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff
from grbaz_tpu_torch.ops.cuda import fir_decimate as fd
from grbaz_tpu_torch.ops.cuda import manchester_fsm as mf
from grbaz_tpu_torch.ops.cuda import peak_fsm as pf
from grbaz_tpu_torch.ops.cuda import tiling
from grbaz_tpu_torch.ops.cuda import viterbi as vt
from grbaz_tpu_torch.ops.cuda import vrr_walk as vw
from grbaz_tpu_torch.ops.cuda import xlating_fir as xf
from grbaz_tpu_torch.ops.cuda import xlating_fir_ctaps as xc
from grbaz_tpu_torch.ops.wbfm_frontend import rotated_taps
from grbaz_tpu_torch.ops.demod import AMDemod, QuadratureDemod
from grbaz_tpu_torch.ops.fec import GLFSRSource, PNBERv, ViterbiDecoder
from grbaz_tpu_torch.ops.fir import FIRDecimator, FreqXlatingFIRDecimator
from grbaz_tpu_torch.ops.fsk4 import P25_SYMBOL_RATE
from grbaz_tpu_torch.ops.misc import FastrakDecoder
from grbaz_tpu_torch.ops.mmse import NTAPS as NTAPS_MMSE
from grbaz_tpu_torch.ops.resampler import (FractionalResampler,
                                           VariableRatioResampler,
                                           resample_block,
                                           resample_block_rational)
from grbaz_tpu_torch.ops.spectral import PowerSpectrum, Vectorize
from grbaz_tpu_torch.parallel.channel_bank import DynamicChannelBank
from grbaz_tpu_torch.parallel.doa import (sharded_music_spectrum,
                                          simulate_snapshots)
from grbaz_tpu_torch.parallel.pipeline import StagePipeline, _wbfm_stages
from grbaz_tpu_torch.parallel.tp import TPFIRDecimator
from grbaz_tpu_torch.parallel.wbfm_bank import BankConfig, ShardedWBFMBank
from grbaz_tpu_torch.utils import acars

FS = 3.2e6
BLOCK = 1 << 20
DECIM = 8
N_BLOCKS = 8
STATION_HZ = 250e3
TONE_HZ = 1000.0
DEVIATION_HZ = 75e3
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OUT_DIR = "chiprun_out"

KERNELS = {  # row -> (wrappers whose launches it counts, source, TPU kernel)
    "xlating_fir_block": (
        (xf.xlating_fir_block,), "grbaz_tpu_torch/csrc/xlating_fir.cu",
        "grbaz_tpu/ops/pallas/wbfm_frontend.py:621"),
    "xlating_fir_frame_rtf": (
        (xf.xlating_fir_frame_rtf,), "grbaz_tpu_torch/csrc/xlating_fir.cu",
        "grbaz_tpu/ops/pallas/wbfm_frontend.py:403"),
    # B3's two entry points: the frame (the JAX signature) and the block
    # with the carried tail read in place (FIRDecimator's)
    "fir_decimate_frame": (
        (fd.fir_decimate_frame, fd.fir_decimate_block),
        "grbaz_tpu_torch/csrc/fir_decimate.cu",
        "grbaz_tpu/ops/pallas/fir_kernel.py:113"),
    "xlating_fir_ctaps_block": (
        (xc.xlating_fir_ctaps_block,),
        "grbaz_tpu_torch/csrc/xlating_fir_ctaps.cu",
        "grbaz_tpu/ops/pallas/wbfm_frontend.py:218"),
    # the channel bank's channelizer: the JAX bank's per-slot rotate,
    # filter and decimate (XLA there; B1's math), every slot in one launch
    "channel_bank": (
        (cb.channel_bank,), "grbaz_tpu_torch/csrc/channel_bank.cu",
        "grbaz_tpu/parallel/channel_bank.py:107"),
    # the lockout / look-ahead PeakDetector's serial FSM (the JAX package's
    # per-sample lax.scan, not a Pallas kernel)
    "peak_fsm": (
        (pf.peak_fsm,), "grbaz_tpu_torch/csrc/peak_fsm.cu",
        "grbaz_tpu/ops/detect.py:236"),
    # FastrakDecoder's serial FSM (a per-sample lax.scan in the JAX package)
    "fastrak_fsm": (
        (ff.fastrak_fsm,), "grbaz_tpu_torch/csrc/fastrak_fsm.cu",
        "grbaz_tpu/ops/misc.py:72"),
    # VariableRatioResampler's position walk and interpolation (a
    # per-output lax.scan in the JAX package)
    "vrr_walk": (
        (vw.vrr_walk,), "grbaz_tpu_torch/csrc/vrr_walk.cu",
        "grbaz_tpu/ops/resampler.py:315"),
    # the decoders' and the Viterbi decoder's per-sample scans
    "viterbi": (
        (vt.viterbi,), "grbaz_tpu_torch/csrc/viterbi.cu",
        "grbaz_tpu/ops/fec.py:244"),
    "acars_fsm": (
        (af.acars_fsm,), "grbaz_tpu_torch/csrc/acars_fsm.cu",
        "grbaz_tpu/ops/decode.py:204"),
    "manchester_fsm": (
        (mf.manchester_fsm,), "grbaz_tpu_torch/csrc/manchester_fsm.cu",
        "grbaz_tpu/ops/decode.py:44"),
    "dpll_walk": (
        (dw.dpll_walk,), "grbaz_tpu_torch/csrc/dpll_walk.cu",
        "grbaz_tpu/ops/decode.py:118"),
}
# kernels each path launches; xlating_fir_frame_rtf is the
# frame-convention entry point of the channelizer kernel, which the JAX
# package calls only from its tests
MAIN_PATH_KERNELS = ("xlating_fir_block", "fir_decimate_frame")
FUSED_PATH_KERNELS = ("xlating_fir_ctaps_block",)
BANK_PATH_KERNELS = ("channel_bank",)
BURST_PATH_KERNELS = ("peak_fsm",)
# the device functions of the FSM kernel's three passes, as the profiler
# names them
FSM_PASSES = ("speculate_kernel", "chain_kernel", "apply_kernel")
PUMP_BLOCKS = 16
# BASELINE config 5 (benchmarks.py: bench_bank): 16 slots over 2^17-sample
# blocks, channels at linspace(-1.2 MHz, 1.2 MHz, 16), an FM station on
# each at BANK_DEV_HZ deviation; slot BANK_TONE_SLOT's carries TONE_HZ
BANK_SLOTS = 16
BANK_BLOCK = 1 << 17
BANK_TONE_SLOT = 10
BANK_DEV_HZ = 5e3
PATH_BLOCKS = 4       # blocks of each config-1, -3 and -4 path
BANK_BLOCKS = 8
# the burst path: the stream starts 2^19 samples before the low limb
# wraps; pulses of PULSE_LEN samples at amplitude 1.5 (power 2.25: above
# the gate's 0.5 and the radar's 1.0) behind a two-sample ramp, and syncs
# at amplitude 0.4 (power below 0.36 with the noise: under both)
BURST_ABS0 = 2 ** 32 - 2 ** 19
PULSE_LEN = 24
BURST_WINDOW = 4096     # the correlators' window and the buffer's max_len
FSM_CONFIG = dict(min_diff=0.5, lockout=64)
# a second FSM case: a smoothed average (alpha < 1 takes the kernel's
# fused multiply-add through every step) and a look-ahead
FSM_SMOOTHED = dict(min_diff=0.5, lockout=64, alpha=0.3, drop=0.2,
                    look_ahead=8)
# a second pulse this many samples after a first starts inside the
# first's 64-sample lockout (its emission comes after the first's
# peak) and after the retriggerable gate's 55 open samples
LOCKED_GAP = 60
# the forced-miss FSM case: sawtooth ramps of FSM_TOOTH samples (many
# chunks each), a drop FSM_TOOTH_AT samples before each block's end, a
# two-sample bump inside the lockout after each drop, and a lockout longer
# than the kernel's warm-up and chunk: every guess inside a ramp has the
# wrong start of the rise, every guess inside a lockout the wrong count
FSM_TOOTH = 4096
FSM_TOOTH_AT = 100
FSM_RAMP = dict(min_diff=0.5, lockout=4 * pf.WARM)


def reset_launches() -> None:
    for fns, _, _ in KERNELS.values():
        for fn in fns:
            fn.launches = 0


def launch_counts() -> dict:
    return {name: sum(fn.launches for fn in fns)
            for name, (fns, _, _) in KERNELS.items()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# signal helpers (also rehearsed on the CPU by tests/test_torch_wbfm.py)
# ---------------------------------------------------------------------------

def synth_fm(n: int, device: torch.device, seed: int = 0) -> torch.Tensor:
    """A broadcast FM station at +STATION_HZ carrying a TONE_HZ tone at
    DEVIATION_HZ, with complex noise 40 dB down; complex64 [n]."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    turns = torch.frac(t * (STATION_HZ / FS))
    phase = 2 * np.pi * turns + (DEVIATION_HZ / TONE_HZ) * torch.sin(
        2 * np.pi * torch.frac(t * (TONE_HZ / FS)))
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(n, 2, generator=gen, device=device,
                        dtype=torch.float32) * 0.01
    return (torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
            + torch.view_as_complex(noise))


def tone_sinad(audio: np.ndarray, rate: float, band_hz: float = None):
    """(peak frequency, SINAD dB) with a Blackman-Harris window; the
    signal is the peak bin +-8, the rest above DC (and below ``band_hz``,
    where given) is noise+distortion."""
    n = len(audio)
    k = np.arange(n)
    w = (0.35875 - 0.48829 * np.cos(2 * np.pi * k / (n - 1))
         + 0.14128 * np.cos(4 * np.pi * k / (n - 1))
         - 0.01168 * np.cos(6 * np.pi * k / (n - 1)))
    p = np.abs(np.fft.rfft((audio - audio.mean()) * w)) ** 2
    if band_hz is not None:
        p = p[: int(band_hz * n / rate)]
    p[:9] = 0.0
    pk = int(np.argmax(p))
    sig = p[max(pk - 8, 0):pk + 9].sum()
    return pk * rate / n, 10 * np.log10(sig / (p.sum() - sig))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int) -> float:
    """Device time per call of ``fn(i)``, from CUDA events, after warm-up.

    The card first runs a sleep kernel long enough for the host to queue
    every call, so the events time the card's work and not the host's
    launch rate (unless the host cannot keep up even then)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * host_s, 2.0) * 2e9))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(make, nbytes: int):
    """Enough independent inputs that cycling through them overflows the
    50 MB L2 cache, as the main path's fresh blocks would."""
    return [make() for _ in range(max(1, -(-160_000_000 // nbytes)))]


def bound_ms(nbytes: int, flops: int):
    """The larger of bytes over the memory rate and operations over the
    f32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them;
    printed beside every time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def report():
    smi = card()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return smi


def kernel_cases(dev):
    """Inputs at the main path's shapes, and the work each call does."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def cn(n):
        return torch.view_as_complex(torch.randn(n, 2, generator=gen,
                                                 device=dev))

    h_chan = torch.from_numpy(fir.prepare_taps(
        fir.low_pass_taps(1.0, FS, 112.5e3, 75e3), DECIM)).to(dev)
    h_aa = torch.from_numpy(fir.prepare_taps(
        fir.low_pass_taps(1.0, FS / DECIM, 0.45 * 48e3, 0.2 * 48e3,
                          window="blackmanharris"), DECIM)).to(dev)
    tpad, tpad_aa = h_chan.shape[0], h_aa.shape[0]
    phase0 = torch.tensor(0xDEADBEEF, device=dev)
    inc = torch.tensor(int(exact.freq_to_turns_u32(-STATION_HZ, FS)),
                       device=dev)
    n_out = BLOCK // DECIM
    tail = cn(tpad)
    xs = copies(lambda: cn(BLOCK), 8 * BLOCK)
    frames = copies(lambda: cn(tpad - 1 + BLOCK), 8 * BLOCK)
    # the anti-alias FIR sees the channel's n_out samples per block
    aa_frames = copies(lambda: torch.randn(tpad_aa - 1 + n_out, generator=gen,
                                           device=dev), 4 * n_out)
    n_aa = n_out // DECIM
    # the same shape through the block entry point the cascade chain uses
    aa_xs = copies(lambda: torch.randn(n_out, generator=gen, device=dev),
                   4 * n_out)
    aa_tail = torch.randn(tpad_aa, generator=gen, device=dev)

    def conv_real(frame, h):
        return torch.nn.functional.conv1d(frame[None, None], h[None, None],
                                          stride=DECIM)

    planar = [torch.view_as_real(f).T.contiguous()[:, None]
              for f in frames]
    rot_flops = 6 * BLOCK + 4 * tpad * n_out
    # B1 at the AM path's shape: decim 16 and its channel filter
    h_am = torch.from_numpy(fir.prepare_taps(am_channel_taps(),
                                             AM_DECIM)).to(dev)
    tpad_am, n_am = h_am.shape[0], BLOCK // AM_DECIM
    inc_am = torch.tensor(int(exact.freq_to_turns_u32(-AM_STATION_HZ, AM_FS)),
                          device=dev)
    tail_am = cn(tpad_am)
    # B1 at the P25 path's shape: 2^19 samples at 1.536 Msamp/s, decim 32
    h_p25 = torch.from_numpy(fir.prepare_taps(p25_channel_taps(),
                                              P25_DECIM)).to(dev)
    tpad_p25, n_p25 = h_p25.shape[0], P25_BLOCK // P25_DECIM
    inc_p25 = torch.tensor(int(exact.freq_to_turns_u32(-P25_OFFSET_HZ,
                                                       P25_FS)), device=dev)
    tail_p25 = cn(tpad_p25)
    xs_p25 = copies(lambda: cn(P25_BLOCK), 8 * P25_BLOCK)
    # B3 at the FasTrak path's shape: float32 at decim 1 through the sync
    # stream's matched filter; each block is the end of a frame
    h_sync = torch.from_numpy(fir.prepare_taps(fastrak_sync_taps(),
                                               1)).to(dev)
    tpad_sync = h_sync.shape[0]
    sync_frames = copies(lambda: torch.randn(tpad_sync - 1 + BLOCK,
                                             generator=gen, device=dev),
                         4 * BLOCK)
    sync_xs = [f[tpad_sync - 1:] for f in sync_frames]
    sync_tail = torch.randn(tpad_sync, generator=gen, device=dev)
    # B3 at the parallel path's TP FIR shape: float32 frames at decim 4
    h_tp = torch.from_numpy(fir.prepare_taps(TP_TAPS, TP_DECIM)).to(dev)
    tpad_tp, n_tp = h_tp.shape[0], BLOCK // TP_DECIM
    tp_frames = copies(lambda: torch.randn(tpad_tp - 1 + BLOCK,
                                           generator=gen, device=dev),
                       4 * BLOCK)
    return [ctaps_case(h_chan, inc, tail, xs),
        dict(name="xlating_fir_block",
             kernel=lambda i: xf.xlating_fir_block(
                 xs[i % len(xs)], tail, h_chan, DECIM, phase0, inc),
             plain=lambda i: xf.xlating_fir_block_plain(
                 xs[i % len(xs)], tail, h_chan, DECIM, phase0, inc),
             library=None, geometry=tiling.for_tensor(xs[0], n_out, tpad,
                                                     DECIM, 8),
             nbytes=8 * BLOCK + 12 * tpad + 8 * n_out + 16, flops=rot_flops),
        dict(name="xlating_fir_frame_rtf",
             kernel=lambda i: xf.xlating_fir_frame_rtf(
                 frames[i % len(frames)], h_chan, DECIM, phase0, inc),
             plain=lambda i: xf.xlating_fir_frame_rtf_plain(
                 frames[i % len(frames)], h_chan, DECIM, phase0, inc),
             library=None, geometry=tiling.for_tensor(xs[0], n_out, tpad,
                                                     DECIM, 8),
             nbytes=8 * (tpad - 1 + BLOCK) + 4 * tpad + 8 * n_out + 16,
             flops=rot_flops),
        dict(name="xlating_fir_block",
             shape=f"AM channel, decim {AM_DECIM}, {tpad_am} taps",
             kernel=lambda i: xf.xlating_fir_block(
                 xs[i % len(xs)], tail_am, h_am, AM_DECIM, phase0, inc_am),
             plain=lambda i: xf.xlating_fir_block_plain(
                 xs[i % len(xs)], tail_am, h_am, AM_DECIM, phase0, inc_am),
             library=None, geometry=tiling.for_tensor(xs[0], n_am, tpad_am,
                                                     AM_DECIM, 8),
             nbytes=8 * BLOCK + 12 * tpad_am + 8 * n_am + 16,
             flops=6 * BLOCK + 4 * tpad_am * n_am),
        dict(name="xlating_fir_block",
             shape=f"P25 channel, decim {P25_DECIM}, {tpad_p25} taps",
             kernel=lambda i: xf.xlating_fir_block(
                 xs_p25[i % len(xs_p25)], tail_p25, h_p25, P25_DECIM, phase0,
                 inc_p25),
             plain=lambda i: xf.xlating_fir_block_plain(
                 xs_p25[i % len(xs_p25)], tail_p25, h_p25, P25_DECIM, phase0,
                 inc_p25),
             library=None, geometry=tiling.for_tensor(
                 xs_p25[0], n_p25, tpad_p25, P25_DECIM, 8),
             nbytes=8 * P25_BLOCK + 12 * tpad_p25 + 8 * n_p25 + 16,
             flops=6 * P25_BLOCK + 4 * tpad_p25 * n_p25),
        # B3's row: the block entry point at audio_aa, what the cascade
        # chain's FIRDecimator launches; the frame entry point's cases
        # after it are timed for the record
        dict(name="fir_decimate_frame", shape="audio_aa f32, block entry",
             kernel=lambda i: fd.fir_decimate_block(
                 aa_xs[i % len(aa_xs)], aa_tail, h_aa, DECIM),
             plain=lambda i: fd.fir_decimate_block_plain(
                 aa_tail, aa_xs[i % len(aa_xs)], h_aa, DECIM),
             library=lambda i: conv_real(aa_frames[i % len(aa_frames)], h_aa),
             geometry=tiling.for_tensor(aa_xs[0], n_aa, tpad_aa, DECIM, 4),
             nbytes=4 * (tpad_aa - 1 + n_out) + 4 * tpad_aa + 4 * n_aa,
             flops=2 * tpad_aa * n_aa),
        dict(name="fir_decimate_frame", shape="audio_aa f32, frame entry",
             kernel=lambda i: fd.fir_decimate_frame(
                 aa_frames[i % len(aa_frames)], h_aa, DECIM),
             plain=lambda i: fd.fir_decimate_frame_plain(
                 aa_frames[i % len(aa_frames)], h_aa, DECIM),
             library=lambda i: conv_real(aa_frames[i % len(aa_frames)], h_aa),
             geometry=tiling.for_tensor(aa_frames[0], n_aa, tpad_aa, DECIM, 4),
             nbytes=4 * (tpad_aa - 1 + n_out) + 4 * tpad_aa + 4 * n_aa,
             flops=2 * tpad_aa * n_aa),
        dict(name="fir_decimate_frame", shape="channel c64",
             kernel=lambda i: fd.fir_decimate_frame(
                 frames[i % len(frames)], h_chan, DECIM),
             plain=lambda i: fd.fir_decimate_frame_plain(
                 frames[i % len(frames)], h_chan, DECIM),
             library=lambda i: torch.nn.functional.conv1d(
                 planar[i % len(planar)], h_chan[None, None], stride=DECIM),
             geometry=tiling.for_tensor(frames[0], n_out, tpad, DECIM, 4),
             nbytes=8 * (tpad - 1 + BLOCK) + 4 * tpad + 8 * n_out,
             flops=4 * tpad * n_out),
        dict(name="fir_decimate_frame",
             shape=f"FasTrak sync f32, decim 1, {tpad_sync} taps",
             kernel=lambda i: fd.fir_decimate_block(
                 sync_xs[i % len(sync_xs)], sync_tail, h_sync, 1),
             plain=lambda i: fd.fir_decimate_block_plain(
                 sync_tail, sync_xs[i % len(sync_xs)], h_sync, 1),
             library=lambda i: torch.nn.functional.conv1d(
                 sync_frames[i % len(sync_frames)][None, None],
                 h_sync[None, None]),
             geometry=tiling.for_tensor(sync_xs[0], BLOCK, tpad_sync, 1, 4),
             nbytes=4 * (tpad_sync - 1 + BLOCK) + 4 * tpad_sync + 4 * BLOCK,
             flops=2 * tpad_sync * BLOCK),
        dict(name="fir_decimate_frame",
             shape=f"TP FIR f32, frame entry, decim {TP_DECIM}, "
             f"{tpad_tp} taps",
             kernel=lambda i: fd.fir_decimate_frame(
                 tp_frames[i % len(tp_frames)], h_tp, TP_DECIM),
             plain=lambda i: fd.fir_decimate_frame_plain(
                 tp_frames[i % len(tp_frames)], h_tp, TP_DECIM),
             library=lambda i: torch.nn.functional.conv1d(
                 tp_frames[i % len(tp_frames)][None, None],
                 h_tp[None, None], stride=TP_DECIM),
             rel=TP_REL,
             geometry=tiling.for_tensor(tp_frames[0], n_tp, tpad_tp,
                                        TP_DECIM, 4),
             nbytes=4 * (tpad_tp - 1 + BLOCK) + 4 * tpad_tp + 4 * n_tp,
             flops=2 * tpad_tp * n_tp),
        bank_case(dev, gen, h_chan),
        fsm_case(dev, 3, 1, BLOCK, "burst path"),
        fsm_case(dev, 4, 64, 1 << 14, "decoder bank"),
        fsm_case(dev, 5, 64, 1 << 14, "decoder bank, smoothed, look-ahead",
                 FSM_SMOOTHED),
        fsm_case(dev, 6, 1, BLOCK, "forced miss", FSM_RAMP, ramp_block,
                 all_miss=True),
        fastrak_case(dev, 7, 1, BLOCK, "FasTrak path", gap=FT_PATH_GAP),
        fastrak_case(dev, 8, 64, 1 << 14, "decoder bank"),
        fastrak_case(dev, 10, 1, BLOCK, "frames back to back", gap=(1, 200)),
        fastrak_case(dev, 9, 1, BLOCK, "forced miss: sync held high",
                     held=True),
        vrr_case(dev),
        *decode_kernel_cases(dev),
    ]


def fsm_block(rng, rows, n):
    """[rows, n] float32 power rows for the FSM cases: a noise floor at
    2e-3 with pulses (a ramp of 1-4 samples up to 0.2-1.5, then 0-20
    samples held within 3%) after gaps of 12-100 samples, so that many
    start inside the previous pulse's lockout; then a quiet stretch and a
    two-sample bump (0.1, 1.0) at n-31, which emits at n-29 and leaves 36
    samples of a 64-sample lockout to the next block; and the same bump at
    5, which that lockout swallows when the blocks are chained."""
    x = 2e-3 * rng.random((rows, n))
    for r in range(rows):
        p = 100
        while p < n - 250:
            ramp, hold = int(rng.integers(1, 5)), int(rng.integers(0, 21))
            h = rng.uniform(0.2, 1.5)
            x[r, p:p + ramp] = h * np.arange(1, ramp + 1) / ramp
            x[r, p + ramp:p + ramp + hold] = h * rng.uniform(0.97, 1.03, hold)
            p += ramp + hold + int(rng.integers(12, 101))
        x[r, [5, 6, n - 31, n - 30]] = (0.1, 1.0, 0.1, 1.0)
    return x.astype(np.float32)


def ramp_block(rng, rows, n):
    """[rows, n] sawtooth ramps for the forced-miss case: teeth of
    FSM_TOOTH samples rising from 0 to 1, the last drop FSM_TOOTH_AT
    samples before the end, a bump (0.1, 1.0) 5 samples after each drop."""
    x = np.tile((np.arange(n) + FSM_TOOTH_AT) % FSM_TOOTH / FSM_TOOTH,
                (rows, 1))
    for d in range((-FSM_TOOTH_AT) % FSM_TOOTH, n - 6, FSM_TOOTH):
        x[:, d + 5:d + 7] = (0.1, 1.0)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# FasTrak frames (also rehearsed on the CPU by tests/test_torch_misc.py)
# ---------------------------------------------------------------------------

FT_OS = 8               # samples a bit: 500 kbit/s at 4 Msamp/s
# gaps between frames of the kernel case at the FasTrak path's density
# (24 frames a 2^20-sample block)
FT_PATH_GAP = (40000, 46000)
FT_IDS = (0x12345678, 0xCAFEBABE, 0x0BADF00D)


def fastrak_bits(tag_id: int, crc_ok: bool = True, word: int = 0xAAC,
                 ptype: int = 0x0001) -> list:
    """A FasTrak frame's 76 bits: sync word, type, ID, and the CRC16 that
    leaves the decoder's CRC at 0 (``crc_ok``), else a wrong one."""
    body = f"{ptype:016b}{tag_id:032b}"
    crc = 0
    for i in range(0, 48, 8):
        crc = misc._crc16_ccitt_update(crc, int(body[i:i + 8], 2))
    if not crc_ok:
        crc ^= 0x5A5A
    return [int(b) for b in f"{word:012b}{body}{crc:016b}"]


def fastrak_rows(rng, rows, n, os_=FT_OS, gap=(1, 200)):
    """[rows, n] float32 (metric, sync) rows for the FSM cases: frames of
    +-1 bits held ``os_`` samples (noise 0.2 rms) after gaps of ``gap``
    samples (-1 between them), the sync stream 5.0 at each frame's first
    sample and 0 else;
    IDs from FT_IDS in runs; one frame in 8 with a bad CRC, one in 10 with
    a bad sync word, one in 12 with a bad type; a decoy sync (5.0) inside
    one frame in 6 and in one gap in 5. A frame cut by the row's end
    carries on where the next block would."""
    metric = np.full((rows, n), -1.0, np.float32)  # idle: the off level
    sync = np.zeros((rows, n), np.float32)
    for r in range(rows):
        p, f = int(rng.integers(0, gap[1])), 0
        bits = []
        while p < n:
            bits = fastrak_bits(FT_IDS[(f // 3) % len(FT_IDS)],
                                crc_ok=f % 8 != 5,
                                word=0xAAC if f % 10 != 7 else 0xAAD,
                                ptype=1 if f % 12 != 9 else 2)
            wave = np.repeat(np.array(bits, np.float32) * 2 - 1, os_)
            end = min(n, p + wave.size)
            metric[r, p:end] = wave[:end - p]
            sync[r, p] = 5.0
            if f % 6 == 2 and p + 300 < n:
                sync[r, p + 300] = 5.0
            p = end + int(rng.integers(*gap))
            if f % 5 == 1 and p - 2 < n and p - 2 > end:
                sync[r, p - 2] = 5.0
            f += 1
        metric[r] += 0.2 * rng.standard_normal(n).astype(np.float32)
    return metric, sync


def fsm_case(dev, seed, rows, n, shape, config=FSM_CONFIG, block=fsm_block,
             all_miss=False):
    """The FSM kernel of ``PeakDetector(**config)`` on ``rows`` power
    streams of ``n`` samples (``block``, :func:`fsm_block` by default),
    chained from the stream start: the kernel and plain functions each
    walk one block; the check walks two chained blocks with both and
    holds marks, idx_diff and the carried state equal, and prints the
    chunks the kernel walked again in each. It also checks that the data
    exercise the config: the lockout crosses the blocks in every row, and
    with the lockout (and look-ahead, where set) at 0 the kernel marks
    otherwise; with ``all_miss``, that every chunk but each row's first
    was walked again. Its bytes: the input and both outputs once, the
    state in and out."""
    cfg = PeakDetector(**config, device="cpu").fsm_config()
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(block(rng, rows, n)).to(dev) for _ in range(2)]
    chunks = rows * -(-n // pf.CHUNK)
    st0 = {k: v.reshape(1).expand(rows).contiguous()
           for k, v in PeakDetector(device=dev).init_state().items()}
    thr = torch.full((1,), float("-inf"), device=dev)
    label = f"peak_fsm [{shape}]"

    def chain(fn, **over):
        st, out, repairs = st0, [], []
        for x in xs:
            m, i, st = fn(x, st, thr, **dict(cfg, **over))
            out.append((m, i, st))
            repairs.append(pf.peak_fsm.last_repairs)
        return out, repairs

    def repaired():
        return (f"repaired {int(pf.peak_fsm.last_repairs.sum())} of "
                f"{chunks} chunks (chunk {pf.CHUNK}, warm {pf.WARM})")

    def held():
        (kern, repairs), (plain, _) = (chain(pf.peak_fsm),
                                       chain(pf.peak_fsm_plain))
        torch.cuda.synchronize()
        print(f"{label}: repaired "
              + " and ".join(str(int(r.sum())) for r in repairs)
              + f" of {chunks} chunks in the two calls (chunk {pf.CHUNK}, "
              f"warm {pf.WARM})")
        for (mk, ik, st_k), (mp, ip, st_p) in zip(kern, plain):
            same = torch.equal(mk, mp) and torch.equal(ik, ip) and all(
                torch.equal(st_k[k], st_p[k]) for k in st_p)
            check(same, f"{label} differs from its plain version")
            check(int(mk.sum()) > 0, f"{label} marked nothing")
        if all_miss:
            check(all(int(r.sum()) == chunks - rows for r in repairs),
                  f"{label}: a guess hit")
        check(bool((kern[0][2]["lockout_count"] > 0).all()),
              f"{label}: the lockout does not cross the blocks")
        for knob in ("lockout", "look_ahead"):
            if cfg[knob]:
                off, _ = chain(pf.peak_fsm, **{knob: 0})
                check(any(not torch.equal(a[0], b[0])
                          for a, b in zip(kern, off)),
                      f"{label}: the data do not exercise {knob}")
        return kern[-1][0], plain[-1][0]

    return dict(name="peak_fsm", shape=f"{shape}, [{rows}, {n}]",
                kernel=lambda i: pf.peak_fsm(xs[i % 2], st0, thr, **cfg)[0],
                plain=lambda i: pf.peak_fsm_plain(xs[i % 2], st0, thr,
                                                  **cfg)[0],
                check=held, iters=10, plain_iters=1, library=None,
                nbytes=12 * rows * n + 2 * 40 * rows + 4, flops=0,
                after=repaired)


def fastrak_case(dev, seed, rows, n, shape, os_=FT_OS, gap=(1, 200),
                 held=False):
    """The FasTrak FSM kernel on ``rows`` streams of ``n`` samples of
    :func:`fastrak_rows` (``held``: the sync stream above the threshold
    everywhere, so that nearly every guess of the speculative walk misses:
    the kernel's worst case). The check walks two chained calls with the
    kernel and the plain version and holds events, counts and the whole
    state equal, and prints the chunks the kernel walked again. Its bytes:
    metric and sync read once, events, counts and the state."""
    rng = np.random.default_rng(seed)
    metric, sync = fastrak_rows(rng, rows, 2 * n, os_, gap)
    if held:
        sync[:] = 5.0
    xs = [(torch.from_numpy(np.ascontiguousarray(metric[:, c * n:(c + 1) * n]))
           .to(dev), torch.from_numpy(np.ascontiguousarray(
               sync[:, c * n:(c + 1) * n])).to(dev)) for c in range(2)]
    st0 = {k: v.reshape(1).expand(rows).contiguous() for k, v in
           FastrakDecoder(device=dev).init_state().items()}
    thr = torch.ones(1, device=dev)
    chunks = rows * -(-n // ff.CHUNK)
    label = f"fastrak_fsm [{shape}]"

    def chain(fn):
        st, out, repairs = st0, [], []
        for m, y in xs:
            ev, c, st = fn(m, y, st, thr, os_)
            out.append((ev, c, st))
            repairs.append(ff.fastrak_fsm.last_repairs)
        return out, repairs

    def held_check():
        (kern, repairs), (plain, _) = (chain(ff.fastrak_fsm),
                                       chain(ff.fastrak_fsm_plain))
        torch.cuda.synchronize()
        print(f"{label}: repaired "
              + " and ".join(str(int(r.sum())) for r in repairs)
              + f" of {chunks} chunks in the two calls (chunk {ff.CHUNK}, "
              f"warm {ff.WARM}); frames {[int(p[1].sum()) for p in plain]}")
        for (ek, ck, sk), (ep, cp, sp) in zip(kern, plain):
            check(same_bits(ek, ep) and torch.equal(ck.cpu(), cp.cpu())
                  and all(torch.equal(sk[k].cpu(), sp[k].cpu()) for k in sp),
                  f"{label} differs from its plain version")
        if held:
            check(all(int(r.sum()) >= 0.8 * (chunks - rows) for r in repairs),
                  f"{label}: too few misses for the worst case")
        else:
            check(all(int(p[1].sum()) > 0 for p in plain),
                  f"{label}: no frame passed")
        return kern[-1][0], plain[-1][0]

    def repaired():
        return (f"repaired {int(ff.fastrak_fsm.last_repairs.sum())} of "
                f"{chunks} chunks (chunk {ff.CHUNK}, warm {ff.WARM})")

    return dict(name="fastrak_fsm", shape=f"{shape}, [{rows}, {n}]",
                kernel=lambda i: ff.fastrak_fsm(*xs[i % 2], st0, thr,
                                                os_)[0],
                plain=lambda i: ff.fastrak_fsm_plain(*xs[i % 2], st0, thr,
                                                     os_)[0],
                check=held_check, iters=20, plain_iters=1, library=None,
                nbytes=8 * rows * n + rows * (4 * 3 * 32 + 4 + 2 * 48) + 4,
                flops=0, after=repaired)


def vrr_case(dev):
    """The ratio-stream resampler's kernel at the AM path's audio shape: a
    float32 block of 2^16 at 64 kHz into 48 kHz (the ratio stream AM_RATIO
    * (1 + 2e-4 sin)), capacity 2^17 + 1. The check chains two blocks
    through the kernel and the plain version: counts, positions, flags and
    tails equal, outputs within 1e-5 of the max. Its bytes: x and rr read
    once, the capacity's outputs written once. The walk's own bound, its
    outputs times one dependent step from shared memory (timed alone by
    ``vrr_walk.chain_step_ns``), is printed beside it."""
    n = BLOCK // AM_DECIM
    blk = VariableRatioResampler(n, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    k = torch.arange(2 * n, dtype=torch.float64, device=dev)
    rr = (AM_RATIO * (1 + 2e-4 * torch.sin(k * 0.001))).to(torch.float32)
    xs = copies(lambda: torch.randn(n, generator=gen, device=dev), 12 * n)
    st0 = blk.init_state()
    full = torch.tensor(n, dtype=torch.int32, device=dev)
    label = f"vrr_walk [{n} f32, capacity {blk.capacity}]"

    def call(fn, x, r, st):
        return fn(x, st["tail"], r, st["rr_tail"], st["q_int"],
                  st["mu_frac"], full, blk.capacity, blk.taps_table)

    def chain(fn):
        st, out = st0, []
        for c in range(2):
            res = call(fn, xs[c], rr[c * n:(c + 1) * n], st)
            out.append(res)
            st = dict(tail=res[5], rr_tail=res[6], q_int=res[2],
                      mu_frac=res[3])
        return out

    def held():
        kern, plain = chain(vw.vrr_walk), chain(vw.vrr_walk_plain)
        torch.cuda.synchronize()
        for g, p in zip(kern, plain):
            check(all(torch.equal(g[i].cpu(), p[i].cpu()) for i in range(1, 7)),
                  f"{label}: counts, positions, flags or tails differ")
        print(f"{label}: {int(kern[0][1])} and {int(kern[1][1])} outputs, "
              "counts, q_int, mu_frac, flags and tails equal to the plain "
              "version's")
        return (torch.cat([g[0] for g in kern]),
                torch.cat([p[0] for p in plain]))

    def chain_bound():
        step_ns = vw.chain_step_ns()
        outs = int(call(vw.vrr_walk, xs[0], rr[:n], st0)[1])
        return (f"the walk's chain: {outs} outputs x {step_ns:.3f} ns a "
                f"dependent shared-memory step = {outs * step_ns / 1e6:.4f} "
                "ms")

    return dict(name="vrr_walk", shape=f"AM audio, {n} f32",
                kernel=lambda i: call(vw.vrr_walk, xs[i % len(xs)], rr[:n],
                                      st0)[0],
                plain=lambda i: call(vw.vrr_walk_plain, xs[i % len(xs)],
                                     rr[:n], st0)[0],
                check=held, iters=50, plain_iters=3, library=None,
                nbytes=8 * n + 4 * blk.capacity + 2 * 4 * 7 + 32,
                flops=2 * NTAPS_MMSE * int(round(n / AM_RATIO)),
                after=chain_bound)


def bank_case(dev, gen, h_chan):
    """The bank's kernel at the channel bank's shape (16 slots, 2^17
    samples in). The check chains two blocks through the kernel and the
    plain version, the second call on the first's new tail, once with the
    same increments and once with half the slots retuned (their tails
    then rotated under the old increments), and holds y and the new tail
    of every call within 1e-5 of the plain version's max; then a
    narrow-band plan the same way (4 slots, 1544 taps, which the kernel
    takes in several slabs of taps), retuned. Its work is
    B1's function per slot, as B1's row counts it: rotate the block (6
    FLOP a sample), then a real-tap FIR (4 FLOP a tap an output); not
    the 3xTF32 product the kernel happens to compute. Its bytes: the
    shared block once, each slot's tail in and out, phase and increment,
    and the outputs. The library yardstick is the real-form filter of
    every slot, ``torch.matmul`` of the overlapping-row view of the block
    with the packed rotated taps (fp32 cuBLAS, TF32 off), without the
    head outputs, the output rotation and the tail."""
    tpad, c = h_chan.shape[0], BANK_SLOTS
    hist, n_out = tpad - 1, BANK_BLOCK // DECIM
    xs = copies(lambda: torch.view_as_complex(torch.randn(
        BANK_BLOCK, 2, generator=gen, device=dev)), 8 * BANK_BLOCK)
    tail = torch.view_as_complex(torch.randn(c, hist, 2, generator=gen,
                                             device=dev)).contiguous()
    ph = torch.randint(0, 2 ** 32, (c,), generator=gen, device=dev)
    inc = torch.tensor([int(exact.freq_to_turns_u32(-f, FS))
                        for f in BANK_FREQS], device=dev)
    # half the slots retuned onto their neighbour's channel
    retuned = torch.where(torch.arange(c, device=dev) % 2 == 0,
                          inc.roll(1), inc)
    label = f"channel_bank [{c} slots]"

    def chain(fn, inc2):
        y0, t0 = fn(xs[0], tail, h_chan, DECIM, ph, inc)
        y1, t1 = fn(xs[1], t0, h_chan, DECIM,
                    (ph + BANK_BLOCK * inc) & 0xFFFFFFFF, inc2)
        return (y0, t0, y1, t1)

    def compare(what, got, ref):
        torch.cuda.synchronize()
        for part, g, r in zip(("y0", "tail0", "y1", "tail1"), got, ref):
            err = float((g - r).abs().max())
            bar = 1e-5 * float(r.abs().max())
            print(f"{what} {part}: max_abs_err {err:.3e} (bar {bar:.3e})")
            check(g.shape == r.shape and err < bar,
                  f"{what} {part} disagrees with its plain version")

    def held():
        for what, inc2 in (("chained", inc), ("retuned", retuned)):
            got, ref = chain(cb.channel_bank, inc2), chain(
                cb.channel_bank_plain, inc2)
            compare(f"{label} {what}", got, ref)
        # a narrow-band plan (NBFM: 12.5 kHz channels, 5 kHz transition,
        # 1544 taps) whose taps the kernel takes in several slabs
        nb = torch.from_numpy(fir.prepare_taps(fir.low_pass_taps(
            1.0, FS, 6.25e3 + 2.5e3, 5e3), DECIM)).to(dev)
        nt = torch.view_as_complex(torch.randn(
            4, nb.shape[0] - 1, 2, generator=gen, device=dev)).contiguous()

        def narrow(fn):
            y0, t0 = fn(xs[2], nt, nb, DECIM, ph[:4], inc[:4])
            y1, t1 = fn(xs[3], t0, nb, DECIM,
                        (ph[:4] + BANK_BLOCK * inc[:4]) & 0xFFFFFFFF,
                        retuned[:4])
            return (y0, t0, y1, t1)
        compare(f"channel_bank [4 slots, {nb.shape[0]} taps] retuned",
                narrow(cb.channel_bank), narrow(cb.channel_bank_plain))
        return (torch.cat([g.reshape(-1) for g in got]),
                torch.cat([r.reshape(-1) for r in ref]))

    k_head = -(-hist // DECIM)
    views = [torch.view_as_real(x).reshape(-1).as_strided(
        (n_out - k_head, 2 * tpad), (2 * DECIM, 1),
        2 * (k_head * DECIM - hist)) for x in xs]
    g = h_chan * exact.lo_at(torch.zeros((), dtype=torch.int64, device=dev),
                             inc[:, None], torch.arange(-hist, 1, device=dev))
    b = torch.empty(tpad, 2, c, 2, device=dev)  # (tap, re/im row, slot, col)
    b[:, 0, :, 0], b[:, 0, :, 1] = g.real.T, g.imag.T
    b[:, 1, :, 0], b[:, 1, :, 1] = -g.imag.T, g.real.T
    b = b.reshape(2 * tpad, 2 * c)
    return dict(name="channel_bank", shape=f"{c} slots",
                kernel=lambda i: cb.channel_bank(
                    xs[i % len(xs)], tail, h_chan, DECIM, ph, inc),
                plain=lambda i: cb.channel_bank_plain(
                    xs[i % len(xs)], tail, h_chan, DECIM, ph, inc),
                check=held,
                library=lambda i: torch.matmul(views[i % len(views)], b),
                library_label="torch.matmul of the real-form view, fp32 "
                "cuBLAS, no head, rotation or tail",
                nbytes=8 * BANK_BLOCK + 2 * 8 * c * hist + 4 * tpad
                + 16 * c + 8 * c * n_out,
                flops=c * (6 * BANK_BLOCK + 4 * tpad * n_out))


def ctaps_case(h_chan, inc, tail, xs):
    """B2 at the fused path's shape; its library yardstick is one
    complex ``conv1d`` (stride decim) with the rotated taps."""
    tpad = h_chan.shape[0]
    n_out = BLOCK // DECIM
    g = rotated_taps(h_chan, inc)
    frames = [torch.cat([tail[1:], x])[None, None] for x in xs]

    def library(i):
        return torch.nn.functional.conv1d(frames[i % len(frames)],
                                          g[None, None], stride=DECIM)

    return dict(name="xlating_fir_ctaps_block",
                kernel=lambda i: xc.xlating_fir_ctaps_block(
                    xs[i % len(xs)], tail, h_chan, DECIM, inc),
                plain=lambda i: xc.xlating_fir_ctaps_block_plain(
                    xs[i % len(xs)], tail, h_chan, DECIM, inc),
                library=library,
                geometry=tiling.for_tensor(xs[0], n_out, tpad, DECIM, 8),
                nbytes=8 * BLOCK + 12 * tpad + 8 * n_out + 8,
                flops=8 * tpad * n_out)


def check_kernels(cases):
    for c in cases:
        got, ref = c["check"]() if "check" in c else (c["kernel"](0),
                                                       c["plain"](0))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bar = c.get("rel", 1e-5) * float(ref.abs().max())
        c["max_abs_err"] = err
        label = c["name"] + (f" [{c['shape']}]" if "shape" in c else "")
        print(f"kernel {label}: max_abs_err {err:.3e} (bar {bar:.3e}), "
              f"shape {tuple(got.shape)} {got.dtype}"
              + (f", {c['geometry']}" if "geometry" in c else ""))
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{label} shape/dtype")
        check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got).all()), f"{label} finite")
        check(err < bar, f"{label} disagrees with its plain version")


def run_chain(cfg, dev, iq, n_blocks):
    """The WBFM chain of ``cfg`` over the first ``n_blocks`` blocks of
    ``iq`` (see :func:`run_graph`)."""
    return run_graph(build_wbfm(cfg, device=dev)[0],
                     [iq[b * BLOCK:(b + 1) * BLOCK] for b in range(n_blocks)],
                     FS)


def valid(outs, port):
    return [d[: int(c)] for d, c in (o[port] for o in outs)]


def main_path(dev, iq):
    cfg = WBFMConfig(block_size=BLOCK, audio_chain="cascade",
                     center_freq=STATION_HZ)
    kern, launches = counted("main path", MAIN_PATH_KERNELS, N_BLOCKS,
                             lambda: run_chain(cfg, dev, iq, N_BLOCKS))
    plain, _ = counted(
        "main path (plain backend)", (), N_BLOCKS,
        lambda: run_chain(dataclasses.replace(cfg, chan_backend="plain"),
                          dev, iq, N_BLOCKS))
    for port in ("audio", "quad"):
        a, b = valid(kern, port), valid(plain, port)
        check([len(v) for v in a] == [len(v) for v in b], f"{port} counts")
        ka, pb = torch.cat(a), torch.cat(b)
        check(bool(torch.isfinite(ka).all()), f"{port} finite")
        err = float((ka - pb).abs().max())
        scale = float(pb.abs().max())
        print(f"main path {port}: {ka.numel()} samples, kernel vs plain "
              f"max_abs_err {err:.3e} (bar {1e-4 * scale:.3e})")
        check(err < 1e-4 * scale, f"{port}: kernel and plain backends differ")
    audio = torch.cat(valid(kern, "audio")[1:]).cpu().numpy()
    f, sinad = tone_sinad(audio, cfg.audio_rate)
    print(f"main path tone: {f:.2f} Hz, SINAD {sinad:.2f} dB "
          f"over {len(audio)} audio samples")
    check(abs(f - TONE_HZ) < 5.0, "tone frequency")
    check(sinad > 40.0, "tone SINAD")
    return cfg, kern, launches


def executor_phase(dev, iq, cfg, kern):
    fg, _ = build_wbfm(cfg, device=dev)
    ex = StreamExecutor(fg, {"iq": InputSpec((BLOCK,), "complex64", FS)},
                        device=dev)
    host = iq[:4 * BLOCK].cpu().numpy()
    ref_quad = valid(kern, "quad")
    blocks = [host[b * BLOCK:(b + 1) * BLOCK] for b in range(4)]
    for b in range(2):
        q, c = ex.step({"iq": blocks[b]})["quad"]
        check(c == BLOCK // DECIM, "executor quad count")
        check(np.array_equal(q[:c], ref_quad[b].cpu().numpy()),
              f"executor block {b} differs from the Flowgraph run")
    ex.params["channel"] = FreqXlatingFIRDecimator.freq_params(0.0, FS)
    q, c = ex.step({"iq": blocks[2]})["quad"]
    off = float(np.abs(q[:c] - ref_quad[2].cpu().numpy()).max())
    check(off > 0.1, "mistuning through params changed nothing")
    ex.params["channel"] = FreqXlatingFIRDecimator.freq_params(STATION_HZ,
                                                               FS)
    part = BLOCK // 2 + 8
    out = ex.step({"iq": blocks[3]}, counts={"iq": part})
    q, c = out["quad"]
    check(c == part // DECIM, "partial block quad count")
    # the demod is blind to the constant phase offset the mistuned block
    # left behind; skip the outputs whose 104-tap filter history reaches
    # into that block (13 outputs, plus the demod's previous sample)
    skip = 16
    back = float(np.abs(q[skip:c] - ref_quad[3].cpu().numpy()[skip:c]).max())
    check(back < 1e-3, "retune back did not restore the channel")
    a, ac = out["audio"]
    check(0 < ac < len(a) and np.isfinite(a[:ac]).all(), "partial audio")
    print(f"executor: 4 host-fed blocks, retune off ({off:.3f} away) and "
          f"back ({back:.2e}), partial block quad {c} audio {ac}, "
          f"{ex.throughput() / 1e6:.2f} Msamp/s host-observed")


def gate_flips(got, ref, rel, limit=8):
    """Samples of ``got`` that differ from ``ref`` beyond ``rel`` of its
    peak must be squelch-gate flips (zero on one side), at most
    ``limit``; returns (max-abs error, number of flips)."""
    diff = (got - ref).abs()
    bad = torch.nonzero(diff > rel * float(ref.abs().max())).flatten()
    check(len(bad) <= limit, f"{len(bad)} samples differ (bar {limit} flips)")
    check(all(float(got[i]) == 0.0 or float(ref[i]) == 0.0 for i in bad),
          "a sample differs beyond the bar and is not a gate flip")
    return float(diff.max()), len(bad)


def fused_path(dev, iq):
    """The fused chain over the main path's blocks, squelch off and on."""
    launches = {}
    for squelch in (None, -20.0):
        cfg = WBFMConfig(block_size=BLOCK, fused=True, center_freq=STATION_HZ,
                         squelch_db=squelch)
        what = f"fused path (squelch {squelch})"
        kern, counts = counted(what, FUSED_PATH_KERNELS, N_BLOCKS,
                               lambda: run_chain(cfg, dev, iq, N_BLOCKS))
        if squelch is None:
            launches = counts
        plain, _ = counted(
            what + " (plain backend)", (), N_BLOCKS,
            lambda: run_chain(dataclasses.replace(cfg, fused_backend="plain"),
                              dev, iq, N_BLOCKS))
        for port in ("audio", "quad"):
            a, b = valid(kern, port), valid(plain, port)
            check([len(v) for v in a] == [len(v) for v in b],
                  f"fused {port} counts")
            ka, pb = torch.cat(a), torch.cat(b)
            check(bool(torch.isfinite(ka).all()), f"fused {port} finite")
            if squelch is None:
                err, flips = float((ka - pb).abs().max()), 0
                check(err < 1e-4 * float(pb.abs().max()),
                      f"fused {port}: kernel and plain backends differ")
            else:
                err, flips = gate_flips(ka, pb, 1e-4)
            print(f"fused path (squelch {squelch}) {port}: {ka.numel()} "
                  f"samples, kernel vs plain max_abs_err {err:.3e} "
                  f"(bar {1e-4 * float(pb.abs().max()):.3e}), "
                  f"{flips} gate flips")
        audio = torch.cat(valid(kern, "audio")[1:]).cpu().numpy()
        f, sinad = tone_sinad(audio, cfg.audio_rate)
        print(f"fused path (squelch {squelch}) tone: {f:.2f} Hz, SINAD "
              f"{sinad:.2f} dB over {len(audio)} audio samples")
        check(abs(f - TONE_HZ) < 5.0, "fused tone frequency")
        check(sinad > 40.0, "fused tone SINAD")
        if squelch is None:
            fused_quad = torch.cat(valid(kern, "quad"))
    # B2 against B1: the unfused fractional chain's quad
    unfused = run_chain(WBFMConfig(block_size=BLOCK, center_freq=STATION_HZ),
                           dev, iq, N_BLOCKS)
    uq = torch.cat(valid(unfused, "quad"))
    check(uq.shape == fused_quad.shape, "fused and unfused quad counts")
    err = float((fused_quad[1:] - uq[1:]).abs().max())
    print(f"fused quad vs unfused (B1) quad after the first sample: "
          f"max_abs_err {err:.3e} (bar 1e-4)")
    check(err < 1e-4, "the fused and unfused chains differ on quad")
    return launches


def pump_phase(dev):
    """StreamPump over the fused chain at two depths, the async dispatch,
    and checkpoint / resume, all against the Flowgraph run."""
    cfg = WBFMConfig(block_size=BLOCK, fused=True, center_freq=STATION_HZ)
    iq = synth_fm(PUMP_BLOCKS * BLOCK, dev, seed=2)
    ref = run_chain(cfg, dev, iq, PUMP_BLOCKS)
    ref_q = [q.cpu().numpy() for q in valid(ref, "quad")]
    ref_a = [a.cpu().numpy() for a in valid(ref, "audio")]
    host = iq.cpu().numpy()
    blocks = [{"iq": host[b * BLOCK:(b + 1) * BLOCK]}
              for b in range(PUMP_BLOCKS)]
    del iq, ref

    def executor():
        fg, _ = build_wbfm(cfg, device=dev)
        return StreamExecutor(fg, {"iq": InputSpec((BLOCK,), "complex64", FS)},
                              device=dev)

    for inflight in (1, 3):
        ex = executor()
        ex.step(blocks[0])  # warm-up, not counted
        ex.reset()
        feed = list(blocks)
        got = dict(quad=[], audio=[])
        pump = StreamPump(
            ex, lambda: feed.pop(0) if feed else None,
            {p: (lambda p: lambda d, c: got[p].append(d[:c]))(p)
             for p in got}, inflight=inflight)
        t0 = time.perf_counter()
        pump.start()
        deadline = t0 + 120.0
        while pump.stats()["blocks_out"] < PUMP_BLOCKS \
                and time.perf_counter() < deadline:
            time.sleep(0.001)
        secs = time.perf_counter() - t0
        pump.stop()
        st = pump.stats()
        print(f"pump inflight={inflight}: {st}, {secs:.4f} s, "
              f"{PUMP_BLOCKS * BLOCK / secs / 1e6:.2f} Msamp/s host-observed")
        check(st["blocks_in"] == st["blocks_out"] == PUMP_BLOCKS,
              f"pump inflight={inflight} block counts")
        check(st["overruns"] == 0 and st["underruns"] == 0, "pump overruns")
        check(all(np.array_equal(a, b) for a, b in zip(got["quad"], ref_q))
              and all(np.array_equal(a, b)
                      for a, b in zip(got["audio"], ref_a)),
              f"pump inflight={inflight} differs from the Flowgraph run")

    # dispatch must not wait for the card, even with a retune written
    # into ex.params as host (numpy) values
    ex = executor()
    ex.params["frontend"] = dict(ex.params["frontend"],
                                 **WBFMFrontend.freq_params(STATION_HZ, FS))
    ex.step(blocks[0])
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))  # ~0.5 s of card time
    t0 = time.perf_counter()
    outs = ex.dispatch(blocks[1])
    host_ms = (time.perf_counter() - t0) * 1e3
    done = torch.cuda.Event()
    done.record()
    busy = not done.query()
    ex.fetch(outs)
    print(f"dispatch returned in {host_ms:.3f} ms with the step still "
          f"queued on the card: {busy}")
    check(busy, "dispatch waited for the card")

    # checkpoint after block 8, resumed in a fresh executor
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "pump_checkpoint.npz")
    half = PUMP_BLOCKS // 2
    ex = executor()
    for b in blocks[:half]:
        ex.step(b)
    ex.save(path, extra=dict(blocks_done=half))
    cont = [ex.step(b) for b in blocks[half:]]
    fresh = executor()
    extra = fresh.restore(path)
    os.remove(path)
    check(int(extra["blocks_done"]) == half, "checkpoint extra")
    resumed = [fresh.step(b) for b in blocks[half:]]
    same = all(np.array_equal(a[p][0], b[p][0]) and a[p][1] == b[p][1]
               for a, b in zip(cont, resumed) for p in ("quad", "audio"))
    check(same, "resumed blocks differ from the uninterrupted run")
    check(all(np.array_equal(r["quad"][0][:r["quad"][1]], q)
              for r, q in zip(resumed, ref_q[half:])),
          "resumed blocks differ from the Flowgraph run")
    print(f"checkpoint after block {half}: blocks {half + 1}-{PUMP_BLOCKS} "
          f"of a fresh executor bit-equal to the uninterrupted run")


# ---------------------------------------------------------------------------
# the other BASELINE configurations
# ---------------------------------------------------------------------------

def one_block_graph(block):
    """A Flowgraph of one block, so every path runs through a step: inputs
    ``iq`` (port 0), ``in1``, ``in2``...; outputs ``out``, ``out1``..."""
    fg = Flowgraph(block.name)
    fg.input("iq", block)
    for p in range(1, block.n_in):
        fg.input(f"in{p}", (block, p))
    fg.output("out", (block, 0))
    for p in range(1, block.n_out):
        fg.output(f"out{p}", (block, p))
    return fg


def run_inputs(fg, feeds, rate, control=None, abs_index=None):
    """Steps of ``fg`` over ``feeds`` (one dict of tensors by input a
    step): ``[{port: (data, count)}]``, the output streams' flags ``[{port:
    int}]`` and the states after every step. ``control(params, b)`` runs
    before step b. With ``abs_index`` the stream's absolute index starts
    there and advances step by step (else each step starts at 0)."""
    step = fg.compile().step
    states, params = fg.init_states(), fg.init_params()
    first = next(iter(feeds[0].values()))
    meta = None if abs_index is None else StreamMeta.start(
        rate, abs_index=abs_index, device=first.device)
    outs, flags, after = [], [], []
    for b, feed in enumerate(feeds):
        if control is not None:
            control(params, b)
        states, o = step(states, params, {
            p: Stream.full(v, meta=meta, sample_rate=rate)
            for p, v in feed.items()})
        outs.append({k: (v.data, v.count) for k, v in o.items()})
        flags.append({k: v.meta.flags for k, v in o.items()})
        after.append(states)
        if meta is not None:
            meta = meta.advanced(first.shape[0])
    if first.is_cuda:
        torch.cuda.synchronize()
    flags = [{k: int(v) for k, v in f.items()} for f in flags]
    return outs, flags, after


def run_graph(fg, blocks, rate, control=None, abs_index=None):
    """:func:`run_inputs` over ``blocks`` into ``fg``'s one input: the
    outputs."""
    port = next(iter(fg.in_ports))
    return run_inputs(fg, [{port: x} for x in blocks], rate, control,
                      abs_index)[0]


def counted(what, kernels, n_blocks, fn, per_block=1):
    """Run ``fn()`` with every launch count set to 0 just before it; each
    kernel of ``kernels`` must launch ``per_block`` times a block, every
    other none."""
    reset_launches()
    out = fn()
    counts = launch_counts()
    print(f"{what} launches over {n_blocks} blocks: {counts}")
    for name, n in counts.items():
        want = n_blocks * per_block if name in kernels else 0
        check(n == want, f"{what} launched {name} {n} times, not {want}")
    return out, counts


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.complex128)
    err = np.mean(np.abs(ref - np.asarray(got, np.complex128)) ** 2)
    return float("inf") if err == 0 else \
        10 * np.log10(np.mean(np.abs(ref) ** 2) / err)


def close_spectra(got, want, scale, what):
    """dB spectra in linear power (``scale`` 10, or 20 for magnitudes)
    within 1e-5 of each frame's max, the CPU tests' bar."""
    pg = 10.0 ** (got.astype(np.float64) / scale)
    pw = 10.0 ** (want.astype(np.float64) / scale)
    fmax = pw.max(axis=-1, keepdims=True)
    err = float((np.abs(pg - pw) / fmax).max())
    check(got.shape == want.shape and err <= 1e-5,
          f"{what}: card and CPU spectra differ ({err:.3e} of frame max)")
    return err


def graph_timer(fg, xs, rate, params=None, ports=None, bits_ports=()):
    """``run(steps)``: CUDA-event ms per step of ``fg`` over ``xs`` in
    turn (tensors into its one input, or dicts of tensors by input), the
    outputs ``ports`` (default every output) summed into a
    checksum that must stay finite; ``bits_ports`` (event rows with
    bitcast fields, which may hold NaN patterns) are summed as their
    int32 bit patterns."""
    step = fg.compile().step
    params = fg.init_params() if params is None else params
    port = next(iter(fg.in_ports))
    first = next(iter(xs[0].values())) if isinstance(xs[0], dict) else xs[0]
    carry = dict(states=fg.init_states(),
                 acc=torch.zeros((), device=first.device), i=0)

    def run(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            x = xs[carry["i"] % len(xs)]
            feed = x if isinstance(x, dict) else {port: x}
            states, o = step(carry["states"], params, {
                p: Stream.full(v, sample_rate=rate) for p, v in feed.items()})
            acc = carry["acc"]
            for p in (o if ports is None else ports):
                d = o[p].data
                if p in bits_ports:
                    d = d.view(torch.int32)
                elif d.is_complex():
                    d = d.real
                acc = acc + d.to(torch.float32).sum()
            carry.update(states=states, i=carry["i"] + 1, acc=acc)
        end.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(carry["acc"])), "path checksum")
        return start.elapsed_time(end) / steps

    run(3)  # warm-up
    return run


def time_path(label, fg, xs, rate, per_step, unit, scale=1e6, params=None,
              steps=10, bits_ports=(), kernels=()):
    """Median CUDA-event step time over 3 rounds, the rate (``per_step``
    items a step, in units of ``scale`` a second), and the profiled kernel
    time and idle share (and that of the named ``kernels``); the card's
    name and power limit are printed beside the time."""
    return time_run(label, graph_timer(fg, xs, rate, params,
                                       bits_ports=bits_ports),
                    per_step, unit, scale, steps, kernels)


def time_run(label, run, per_step, unit, scale=1e6, steps=10, kernels=()):
    """:func:`time_path` for any ``run(steps)`` timer (``graph_timer``,
    ``step_timer``)."""
    ms = statistics.median(run(steps) for _ in range(3))
    print(f"path {label}: step {ms:.4f} ms (events, median of 3 rounds of "
          f"{steps}) = {per_step / (ms / 1e3) / scale:.2f} {unit} "
          f"({card()})")
    profile_chain(run, ms, label, kernels)
    return ms


def config1_path(dev):
    """BASELINE config 1 (benchmarks.py: bench_resampler_agc): the
    fractional resampler 250e3/48e3 into AGC(1e-4, 1.0) at 2^20-sample
    blocks, on a tone at 0.3 with noise."""
    def graph(device):
        fg = Flowgraph("cfg1")
        rs = FractionalResampler(BLOCK, 250e3 / 48e3, name="rs",
                                 device=device)
        ag = AGC(1e-4, 1.0, name="agc", device=device)
        fg.input("iq", rs)
        fg.chain(rs, ag)
        fg.output("out", ag)
        return fg

    n = PATH_BLOCKS * BLOCK
    gen = torch.Generator(device=dev).manual_seed(11)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = (0.3 * torch.polar(torch.ones_like(t), 0.01 * t).to(torch.complex64)
         + 0.003 * torch.view_as_complex(torch.randn(
             n, 2, generator=gen, device=dev)))
    xs = [x[b * BLOCK:(b + 1) * BLOCK] for b in range(PATH_BLOCKS)]
    outs, _ = counted("config 1", (), PATH_BLOCKS,
                      lambda: run_graph(graph(dev), xs, 250e3))
    y, c = outs[-1]["out"]
    mag = y[: int(c)].abs()
    check(bool(torch.isfinite(mag).all()), "config 1 finite")
    settled = float(mag[-10000:].mean())
    print(f"config 1: {sum(int(o['out'][1]) for o in outs)} outputs over "
          f"{PATH_BLOCKS} blocks; last block |out| mean {settled:.6f} "
          f"(reference 1.0)")
    check(abs(settled - 1.0) < 0.01, "config 1 AGC did not settle to 1.0")
    cpu = run_graph(graph("cpu"), [xs[0].cpu()], 250e3)
    (gy, gc), (cy, cc) = outs[0]["out"], cpu[0]["out"]
    check(int(gc) == int(cc), "config 1 card and CPU counts")
    snr = snr_db(cy[: int(cc)].numpy(), gy[: int(gc)].cpu().numpy())
    print(f"config 1 block 0, card vs CPU: SNR {snr:.2f} dB (bar 90)")
    check(snr > 90.0, "config 1 card and CPU differ")
    time_path("config1", graph(dev), xs, 250e3, BLOCK, "Msamp/s")


def spectral_path(dev):
    """BASELINE config 3: build_spectrum at 4096 bins with and without the
    waterfall, on a unit tone on bin TONE_BIN (0 dBFS) with noise."""
    size, tone_bin = 4096, 300
    gen = torch.Generator(device=dev).manual_seed(12)

    def blocks(block, k):
        t = torch.arange(k * block, dtype=torch.float64, device=dev)
        x = (torch.polar(torch.ones_like(t), 2 * np.pi * torch.frac(
            t * tone_bin / size)).to(torch.complex64)
            + 1e-3 * torch.view_as_complex(torch.randn(
                k * block, 2, generator=gen, device=dev)))
        return [x[b * block:(b + 1) * block] for b in range(k)]

    xs = blocks(BLOCK, PATH_BLOCKS)
    for waterfall in (False, True):
        cfg = SpectralConfig(fft_size=size, block_size=BLOCK,
                             waterfall=waterfall)
        label = "spectrum" + ("_waterfall" if waterfall else "")
        outs, _ = counted(label, (), PATH_BLOCKS, lambda: run_graph(
            build_spectrum(cfg, device=dev)[0], xs, 250e3))
        spec, c = outs[-1]["spectra"]
        check(int(c) == BLOCK // size and spec.shape == (BLOCK // size, size),
              f"{label} shape")
        last = spec[-1].cpu().numpy()
        pk = int(np.argmax(last))
        print(f"{label}: peak bin {pk} at {last[pk]:.4f} dBFS (want bin "
              f"{tone_bin + size // 2} at 0), floor "
              f"{float(np.median(last)):.1f} dB")
        check(pk == tone_bin + size // 2 and abs(last[pk]) < 0.05,
              f"{label}: the tone is not in its bin at 0 dBFS")
        cpu = run_graph(build_spectrum(cfg, device="cpu")[0],
                           [xs[0].cpu()], 250e3)
        err = close_spectra(outs[0]["spectra"][0].cpu().numpy(),
                            cpu[0]["spectra"][0].numpy(), 10.0, label)
        msg = f"{label} block 0, card vs CPU: {err:.3e} of frame max"
        if waterfall:
            raster = outs[0]["raster"][0].cpu().numpy()
            col = Colouriser(cfg.vmin, cfg.vmax, device="cpu")
            _, (ref,) = col.apply(None, col.init_params(), Stream.full(
                outs[0]["spectra"][0].cpu()))
            check(np.array_equal(raster, ref.data.numpy()),
                  "waterfall bytes differ from the CPU colouriser's")
            msg += "; raster bytes equal the CPU colouriser's"
        print(msg)
        time_path(label, build_spectrum(cfg, device=dev)[0], xs, 250e3,
                  BLOCK, "Msamp/s")

    cfg = FACConfig()
    fblock = cfg.block_size
    fxs = blocks(fblock, 8)
    outs, _ = counted("fac", (), len(fxs), lambda: run_graph(
        build_fac(cfg, device=dev)[0], fxs, cfg.sample_rate))
    kept = [int(o["fac"][1]) for o in outs]
    check(sum(kept) >= 5, f"fac kept {kept} frames")
    cpu = run_graph(build_fac(cfg, device="cpu")[0],
                       [f.cpu() for f in fxs[:2]], cfg.sample_rate)
    errs = []
    for g, c in zip(outs[:2], cpu):
        k = int(c["fac"][1])
        check(int(g["fac"][1]) == k, "fac card and CPU counts")
        if k:
            d = g["fac"][0][:k].cpu().numpy()
            check(bool(np.isfinite(d).all()), "fac finite")
            errs.append(close_spectra(d, c["fac"][0][:k].numpy(), 20.0,
                                      "fac"))
    print(f"fac: kept {kept} frames over {len(fxs)} blocks of {fblock}; "
          f"blocks 0-1, card vs CPU: {max(errs):.3e} of frame max")
    time_path("fac", build_fac(cfg, device=dev)[0], fxs, cfg.sample_rate,
              fblock, "Msamp/s")


def peak_path(dev):
    """PeakDetector(min_diff=0.1) over a 2^20-sample power stream: a
    noise floor with planted bumps (some across block boundaries); marks
    exactly at the bumps' apexes."""
    n = PATH_BLOCKS * BLOCK
    gen = torch.Generator(device=dev).manual_seed(13)
    x = 1e-3 * torch.rand(n, generator=gen, device=dev)
    apex = torch.arange(1000, n - 8, 4099, device=dev)
    bump = torch.tensor([0.2, 0.5, 0.8, 1.0, 0.8, 0.5, 0.2], device=dev)
    x[apex[:, None] + torch.arange(-3, 4, device=dev)] += bump
    xs = [x[b * BLOCK:(b + 1) * BLOCK] for b in range(PATH_BLOCKS)]

    def graph(device):
        return one_block_graph(PeakDetector(min_diff=0.1, name="peak",
                                            device=device))

    outs, _ = counted("peak detector", (), PATH_BLOCKS,
                      lambda: run_graph(graph(dev), xs, 1.0))
    marks = torch.cat([o["out"][0] for o in outs])
    found = torch.nonzero(marks).flatten()
    print(f"peak detector: {len(found)} marks over {PATH_BLOCKS} blocks, "
          f"{len(apex)} planted")
    check(torch.equal(found, apex), "peak marks are not at the planted apexes")
    diffs = torch.cat([o["out1"][0] for o in outs])[found[1:]]
    check(bool((diffs == 4099).all()), "peak idx_diff")
    cpu = run_graph(graph("cpu"), [xs[0].cpu()], 1.0)
    for port in ("out", "out1"):
        check(torch.equal(outs[0][port][0].cpu(), cpu[0][port][0]),
              f"peak detector {port}: card and CPU differ")
    print("peak detector block 0, card vs CPU: marks and idx_diff equal")
    time_path("peak_detector", graph(dev), xs, 1.0, BLOCK, "Msamp/s")


def music_path(dev):
    """BASELINE config 4: MusicDOA(8, 1, 512) over 256 frames of 512
    snapshots (one 2^20-sample block of 8 antennas), one source a frame
    at a planted angle on the 0.5-degree grid, 10 dB SNR. The package's
    covariance is x^H x of snapshot rows, so a source reads at angle
    theta when its rows are s * conj(a(theta)) (rows s * a(theta) read
    at pi - theta; the JAX package's tests plant mirror-symmetric angle
    sets, where the two agree)."""
    m, navg, frames = 8, 512, BLOCK // (8 * 512)
    steer = torch.from_numpy(doa.ula_steering_vectors(m, 360)).to(dev)
    bins = 40 + (torch.arange(frames, device=dev) * 3) % 280
    xs = []
    for b in range(PATH_BLOCKS):
        gen = torch.Generator(device=dev).manual_seed(20 + b)
        s = torch.view_as_complex(torch.randn(frames, navg, 2, generator=gen,
                                              device=dev)) / np.sqrt(2)
        noise = torch.view_as_complex(torch.randn(
            frames, navg, m, 2, generator=gen, device=dev)) / np.sqrt(2)
        x = s[..., None] * steer[bins].conj()[:, None, :] + 0.316 * noise
        xs.append(x.reshape(frames, navg * m).contiguous())

    def graph(device):
        return one_block_graph(doa.MusicDOA(m, 1, navg, name="music",
                                            device=device))

    syncs = doa.signal_subspace.host_syncs
    outs, _ = counted("music", (), PATH_BLOCKS,
                      lambda: run_graph(graph(dev), xs, 1.0))
    syncs = (doa.signal_subspace.host_syncs - syncs) / PATH_BLOCKS
    got = torch.stack([o["out1"][0][:, 0] for o in outs])
    off = (got - bins[None]).abs()
    print(f"music: {PATH_BLOCKS} x {frames} frames; peaks off the planted "
          f"angle by at most {float(off.max()) * 0.5:.1f} degrees; "
          f"{syncs:.1f} host syncs a call")
    check(int(off.max()) <= 2, "music peaks more than 1 degree off")
    cpu = run_graph(graph("cpu"), [xs[0].cpu()], 1.0)
    gs, cs = outs[0]["out"][0].cpu().numpy(), cpu[0]["out"][0].numpy()
    check(np.array_equal(outs[0]["out1"][0].cpu().numpy(),
                         cpu[0]["out1"][0].numpy()), "music card/CPU peaks")
    # the whole spectrum, peaks included, as the JAX package's bar
    db = np.abs(10 * np.log10(gs / cs))
    near = np.abs(np.arange(360)[None] - bins.cpu().numpy()[:, None]) <= 2
    print(f"music block 0, card vs CPU: peaks equal, spectra within "
          f"{db.max():.4f} dB (bar 0.2; {db[near].max():.4f} dB within "
          f"1 degree of the planted peaks)")
    check(db.max() < 0.2, "music card and CPU spectra differ")
    time_path("music", graph(dev), xs, 1.0, frames, "scans/s", scale=1.0)


def bank_graph(device, backend="auto"):
    bank = DynamicChannelBank(BANK_SLOTS, FS, DECIM, 150e3, 75e3,
                              backend=backend, name="bank", device=device)
    return one_block_graph(bank), bank


BANK_FREQS = np.linspace(-1.2e6, 1.2e6, BANK_SLOTS)


def bank_control(bank):
    """Host control of the bank between blocks: every channel added
    before block 0, one removed before block 3, one retuned onto another
    station before block 4, and the freed slot reused at a new station
    before block 5."""
    def control(params, b):
        pr = params["bank"]
        if b == 0:
            for f in BANK_FREQS:
                bank.add_channel(pr, float(f))
        elif b == 3:
            bank.remove_channel(pr, 5)
        elif b == 4:
            bank.retune(pr, 2, float(BANK_FREQS[12]))
        elif b == 5:
            check(bank.add_channel(pr, float(BANK_FREQS[13])) == 5,
                  "bank slot reuse")
    return control


def bank_path(dev):
    """BASELINE config 5 (benchmarks.py: bench_bank): the 16-slot bank at
    2^17-sample blocks over an FM station on every channel (slot k's
    tone at 3 kHz + k*100 Hz, slot BANK_TONE_SLOT's at TONE_HZ) and
    noise 50 dB down. Every slot then demodulates a signal: a channel
    with nothing in it demodulates the phase of its stopband leakage,
    where f32 rounding flips angles by 2 pi."""
    n = BANK_BLOCKS * BANK_BLOCK
    t = torch.arange(n, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    x = 0.003 * torch.view_as_complex(torch.randn(n, 2, generator=gen,
                                                  device=dev))
    for k, f in enumerate(BANK_FREQS):
        tone = TONE_HZ if k == BANK_TONE_SLOT else 3e3 + 100 * k
        ph = 2 * np.pi * torch.frac(t * (f / FS)) + 0.7 * k \
            + (BANK_DEV_HZ / tone) * torch.sin(2 * np.pi * torch.frac(
                t * (tone / FS)))
        x = x + torch.polar(torch.ones_like(t), ph).to(torch.complex64)
    xs = [x[b * BANK_BLOCK:(b + 1) * BANK_BLOCK] for b in range(BANK_BLOCKS)]
    fg, bank = bank_graph(dev)
    # the kernel arm takes the rotated tails as they are carried: it must
    # compute no LO on the host (the plain arm's exact.lo_at)
    lo_calls, lo_at = [], exact.lo_at
    exact.lo_at = lambda *a, **k: lo_calls.append(1) or lo_at(*a, **k)
    try:
        kern, counts = counted("bank", BANK_PATH_KERNELS, BANK_BLOCKS,
                               lambda: run_graph(fg, xs, FS,
                                                 bank_control(bank)))
    finally:
        exact.lo_at = lo_at
    check(not lo_calls, f"the bank's kernel arm called exact.lo_at "
          f"{len(lo_calls)} times")
    fg, bank = bank_graph(dev, "plain")
    plain, _ = counted("bank (plain backend)", (), BANK_BLOCKS,
                       lambda: run_graph(fg, xs, FS, bank_control(bank)))
    kq = torch.cat([o["out"][0] for o in kern], dim=1)
    pq = torch.cat([o["out"][0] for o in plain], dim=1)
    check(bool(torch.isfinite(kq).all()), "bank quad finite")
    err, scale = float((kq - pq).abs().max()), float(pq.abs().max())
    print(f"bank: {BANK_SLOTS} slots x {kq.shape[1]} outputs, kernel vs "
          f"plain max_abs_err {err:.3e} (bar {1e-4 * scale:.3e})")
    check(err < 1e-4 * scale, "bank kernel and plain backends differ")
    act = kern[-1]["out1"][0].cpu().numpy()
    check(act.tolist() == [1] * BANK_SLOTS, "bank active flags")
    check(not kq[5, 3 * (BANK_BLOCK // DECIM):5 * (BANK_BLOCK // DECIM)]
          .any(), "a removed slot's output is not zero")
    audio = kq[BANK_TONE_SLOT, BANK_BLOCK // DECIM:].cpu().numpy()
    # the neighbours' leakage beats at the 160 kHz channel spacing, far
    # above the audio band, where a receiver's audio filter takes it out
    f, sinad = tone_sinad(audio, FS / DECIM, band_hz=15e3)
    print(f"bank slot {BANK_TONE_SLOT} tone: {f:.2f} Hz, SINAD {sinad:.2f} "
          f"dB below 15 kHz over {len(audio)} samples")
    check(abs(f - TONE_HZ) < 5.0 and sinad > 30.0, "bank tone")
    fg_cpu, bank_cpu = bank_graph("cpu")
    cpu = run_graph(fg_cpu, [xs[0].cpu()], FS, bank_control(bank_cpu))
    g, c = kern[0]["out"][0].cpu(), cpu[0]["out"][0]
    cerr = float((g - c).abs().max())
    print(f"bank block 0, card vs CPU: max_abs_err {cerr:.3e} "
          f"(bar {1e-4 * float(c.abs().max()):.3e})")
    check(cerr < 1e-4 * float(c.abs().max()), "bank card and CPU differ")
    fg, bank = bank_graph(dev)
    params = fg.init_params()
    bank_control(bank)(params, 0)
    ms = time_path("bank", fg, xs, FS, BANK_BLOCK, "Msamp/s wideband",
                   params=params)
    print(f"bank: {BANK_SLOTS * BANK_BLOCK / ms / 1e3:.2f} Mchan-samp/s")
    return counts


# ---------------------------------------------------------------------------
# the burst path
# ---------------------------------------------------------------------------

def burst_scene(dev):
    """(iq [8 * 2^20] complex64, pulse starts, the starts of pulses inside
    a lockout, sync starts {L: starts}, syncs {L: complex64}): noise at
    0.05 rms; per block 12 pulses of PULSE_LEN samples (random phases,
    amplitude 1.5, behind a ramp of 0.25 and 0.45) and a 13th LOCKED_GAP
    samples after the first, inside its peak lockout; one pulse that
    straddles the first block boundary; a pair LOCKED_GAP apart whose
    second pulse opens the third block, so that the lockout crosses the
    boundary; 6 syncs of 127 and 6 of 63 random-phase samples at
    amplitude 0.4, each far from the pulses and in its own window."""
    n = N_BLOCKS * BLOCK
    rng = np.random.default_rng(15)
    x = (0.05 / np.sqrt(2)) * (rng.standard_normal(n)
                               + 1j * rng.standard_normal(n))
    locked = [b * BLOCK + 40000 + LOCKED_GAP for b in range(N_BLOCKS)] \
        + [2 * BLOCK]
    pulses = sorted([b * BLOCK + 40000 + 85000 * k for b in range(N_BLOCKS)
                     for k in range(12)]
                    + [BLOCK - 10, 2 * BLOCK - LOCKED_GAP] + locked)
    for p in pulses:
        x[p - 2:p] += np.array([0.25, 0.45]) * np.exp(0.3j)
        x[p:p + PULSE_LEN] += 1.5 * np.exp(2j * np.pi * rng.random(PULSE_LEN))
    syncs, sync_at = {}, {}
    for L, first in ((127, 10000), (63, 95000)):
        syncs[L] = np.exp(2j * np.pi * rng.random(L)).astype(np.complex64)
        sync_at[L] = [b * BLOCK + first + 170000 * k
                      for b in range(N_BLOCKS) for k in range(6)]
        for p in sync_at[L]:
            x[p:p + L] += 0.4 * syncs[L]
    iq = torch.from_numpy(x.astype(np.complex64)).to(dev)
    return iq, pulses, locked, sync_at, syncs


def burst_graph(device, syncs):
    """TimeKeeper -> (power, gates, radar, tagger -> buffer, burster ->
    merge, two correlators, the lockout peak detector)."""
    fg = Flowgraph("burst")
    tk = TimeKeeper(name="time", device=device)
    power = FnBlock(lambda x: x.real * x.real + x.imag * x.imag,
                    name="power")
    over = FnBlock(lambda p: (p > 0.5).to(torch.uint8), name="over")
    zeros = FnBlock(torch.zeros_like, name="zeros")
    lo_field = FnBlock(lambda e: e[:, 1].contiguous(), name="lo_field")
    gate = Gate(threshold=0.5, trigger_length=32, name="gate", device=device)
    fixed = Gate(threshold=0.5, trigger_length=32, retriggerable=False,
                 name="fixed", device=device)
    radar = RadarDetector(base_level=0.1, threshold_db=10.0, name="radar",
                          device=device)
    tagger = BurstTagger(BURST_WINDOW, name="tagger", device=device)
    bbuf = BurstBuffer(BURST_WINDOW, name="bbuf", device=device)
    burster = Burster(BursterConfig(burst_length=1024, interval=32768,
                                    sample_interval=True, max_bursts=32),
                      name="burster", device=device)
    merge = Merge(1024, name="merge")
    corr = {L: Correlator(s, BURST_WINDOW, 0.7 * 0.4 * L, 16,
                          name=f"corr{L}", device=device)
            for L, s in syncs.items()}
    peak = PeakDetector(**FSM_CONFIG, name="peak", device=device)
    fg.input("iq", tk)
    fg.connect(tk, power)
    for blk in (gate, fixed):
        fg.connect(tk, (blk, 0))
        fg.connect(power, (blk, 1))
    fg.chain(power, radar)
    fg.chain(power, over, tagger)
    fg.connect(tk, (bbuf, 0))
    fg.connect((tagger, 0), (bbuf, 1))
    fg.connect((tagger, 1), (bbuf, 2))
    fg.connect(tk, burster)
    fg.chain(tk, zeros)
    fg.connect(zeros, (merge, 0))
    fg.connect((burster, 0), (merge, 1))
    fg.connect((burster, 1), lo_field)
    fg.connect(lo_field, (merge, 2))
    for c in corr.values():
        fg.connect(tk, c)
    fg.chain(power, peak)
    outs = dict(report=(tk, 1), gated=gate, gate_ev=(gate, 1),
                fixed_gated=fixed, fixed_ev=(fixed, 1), radar=radar,
                frames=bbuf, lens=(bbuf, 1), bursts=burster,
                burst_ev=(burster, 1), merged=merge, marks=peak,
                idx_diff=(peak, 1))
    for L, c in corr.items():
        outs[f"surf{L}"], outs[f"trig{L}"] = c, (c, 1)
    for name, ep in outs.items():
        fg.output(name, ep)
    return fg


def events(outs, port, decode=decode_abs_events):
    return np.concatenate([decode(o[port][0].cpu(), int(o[port][1]))
                           for o in outs])


def check_burst_outputs(outs, iq, pulses, locked, sync_at, syncs):
    """Every planted pulse and sync at its exact absolute start; a buffer
    frame from each pulse that does not fall in an earlier frame; a peak
    mark in each pulse but those inside a lockout."""
    want = BURST_ABS0 + np.array(pulses, np.float64)
    for port, length in (("gate_ev", PULSE_LEN + 31), ("fixed_ev", 32)):
        ev = events(outs, port)
        check(np.array_equal(ev[:, 0], want) and (ev[:, 1] == length).all(),
              f"{port}: starts or lengths are not the planted pulses'")
    rad = events(outs, "radar", RadarDetector.decode_events)
    check(np.array_equal(rad[:, 0], np.array(pulses, np.float64))
          and (rad[:, 1] == PULSE_LEN).all() and (rad[:, 2] > 1.0).all(),
          "radar events are not the planted pulses")
    x = iq.cpu().numpy()
    frames = [(o["frames"][0][k].cpu().numpy(), int(o["lens"][0][k]))
              for o in outs for k in range(int(o["frames"][1]))]
    opened = []
    for p in pulses:
        if not opened or p >= opened[-1] + BURST_WINDOW:
            opened.append(p)
    check(len(frames) == len(opened) and all(
        ln == BURST_WINDOW and np.array_equal(f, x[p:p + BURST_WINDOW])
        for (f, ln), p in zip(frames, opened)),
        "burst buffer frames are not the samples from each pulse on")
    bev = events(outs, "burst_ev")
    grid = np.arange(0, N_BLOCKS * BLOCK, 32768, dtype=np.float64)
    check(np.array_equal(bev[:, 0], BURST_ABS0 + grid)
          and (bev[:, 1] == 1024).all(), "burster events off the grid")
    merged = torch.cat([o["merged"][0] for o in outs]).cpu().numpy()
    win = (np.arange(len(x)) % 32768) < 1024
    check(np.array_equal(merged[win], x[win]) and not merged[~win].any(),
          "merged stream differs from the input inside the windows")
    reports = [decode_abs_index(o["report"][0][0, 0].cpu().numpy(),
                                o["report"][0][0, 1].cpu().numpy())
               for o in outs]
    check(reports == [BURST_ABS0 + b * BLOCK for b in range(N_BLOCKS)],
          "time keeper reports")
    marks = torch.cat([o["marks"][0] for o in outs]).cpu().numpy()
    at = np.nonzero(marks)[0]
    marked = [p for p in pulses if p not in locked]
    check(len(at) == len(marked) and all(
        p <= a < p + PULSE_LEN for a, p in zip(at, marked)),
        "peak marks are not one in each pulse outside a lockout")
    diffs = torch.cat([o["idx_diff"][0] for o in outs]).cpu().numpy()
    check(np.array_equal(diffs[at[1:]], np.diff(at)), "peak idx_diff")
    extra = {}
    for L, starts in sync_at.items():
        hist = L - 1 + 8
        trig = torch.stack([o[f"trig{L}"][0] for o in outs]).cpu().numpy()
        surf = torch.stack([o[f"surf{L}"][0] for o in outs]).cpu().numpy()
        planted = set()
        for p in starts:
            b, w = p // BLOCK, (p % BLOCK + hist) // BURST_WINDOW
            planted.add((b, w))
            direct = abs(np.vdot(syncs[L].astype(np.complex128),
                                 x[p:p + L].astype(np.complex128)))
            check(trig[b, w] > 0 and abs(surf[b, w, 8] - direct)
                  <= 1e-5 * direct, f"sync {L} at {p} not found there")
        others = {(int(b), int(w)) for b, w in zip(*np.nonzero(trig))} \
            - planted
        # windows where a sync start q overlapping a pulse would peak
        # (block and window of q + hist)
        near = {((q + hist) // BLOCK, (q + hist) % BLOCK // BURST_WINDOW)
                for p in pulses for q in (p - L + 1, p + PULSE_LEN - 1)}
        check(others <= near, f"correlator {L} fired away from the pulses")
        extra[L] = len(others)
    return len(at), extra


# outputs whose rows carry bitcast limbs or indices
BURST_EVENT_PORTS = ("report", "gate_ev", "fixed_ev", "radar", "burst_ev")


def same_bits(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def burst_vs_cpu(card, cpu):
    """Blocks 0-1 of the card against the port on the CPU."""
    worst = {}
    for g, c in zip(card, cpu):
        for port, (gd, gc) in g.items():
            cd, cc = c[port]
            check(int(gc) == int(cc), f"burst {port} counts, card and CPU")
            if port == "radar":
                check(same_bits(gd[:, :3], cd[:, :3]), "radar rows' fields")
                err = float(((gd[:, 3].cpu() - cd[:, 3]).abs()
                             / cd[:, 3].abs().clamp(min=1e-30)).max())
                check(err <= 1e-5, f"radar sums differ by {err:.3e}")
            elif port.startswith(("surf", "trig")):
                err = float((gd.cpu() - cd).abs().max()
                            / cd.abs().max().clamp(min=1e-30))
                check(err <= 1e-5, f"burst {port}: {err:.3e} of max")
            else:
                err = 0.0
                check(same_bits(gd, cd), f"burst {port}: card and CPU differ")
            worst[port] = max(worst.get(port, 0.0), err)
    return worst


def burst_path(dev):
    """The burst path over 8 blocks, counted like phase 3, checked against
    the planted scene and, over blocks 0-1, against the port on the CPU;
    then timed and profiled."""
    iq, pulses, locked, sync_at, syncs = burst_scene(dev)
    xs = [iq[b * BLOCK:(b + 1) * BLOCK] for b in range(N_BLOCKS)]
    outs, launches = counted(
        "burst path", BURST_PATH_KERNELS, N_BLOCKS,
        lambda: run_graph(burst_graph(dev, syncs), xs, FS,
                          abs_index=BURST_ABS0))
    n_marks, extra = check_burst_outputs(outs, iq, pulses, locked, sync_at,
                                         syncs)
    print(f"burst path: {len(pulses)} pulses (gates, radar, buffer frames, "
          f"{n_marks} peak marks, none in the {len(locked)} pulses inside a "
          f"lockout) and {sum(map(len, sync_at.values()))} "
          f"syncs at their exact absolute starts from {BURST_ABS0}; merge "
          f"equal to the input in every burster window; correlator "
          f"triggers near pulses besides the syncs: {extra}")
    cpu = run_graph(burst_graph("cpu", syncs), [x.cpu() for x in xs[:2]],
                    FS, abs_index=BURST_ABS0)
    worst = burst_vs_cpu(outs[:2], cpu)
    print("burst path blocks 0-1, card vs CPU: bit-equal "
          + ", ".join(p for p, e in worst.items() if e == 0.0)
          + "; within bars: " + ", ".join(f"{p} {e:.2e}" for p, e in
                                          worst.items() if e))
    time_path("burst", burst_graph(dev, syncs), xs, FS, BLOCK, "Msamp/s",
              bits_ports=BURST_EVENT_PORTS, kernels=FSM_PASSES)
    return launches


def to_cpu(feeds):
    return [{p: v.cpu() for p, v in f.items()} for f in feeds]


# ---------------------------------------------------------------------------
# the AM receiver (apps/am_fft.py's graph) with a ratio-stream resampler
# ---------------------------------------------------------------------------

AM_FS = 1.024e6
AM_DECIM = 16
AM_STATION_HZ = 200e3
AM_RATE = AM_FS / AM_DECIM          # 64 kHz into the resampler
AUDIO_RATE = 48e3
AM_RATIO = AM_RATE / AUDIO_RATE     # input samples an output sample
AM_FFT = 1024
AM_PATH_KERNELS = ("xlating_fir_block", "vrr_walk")


def am_scene(dev):
    """8 blocks of 2^20 samples at 1.024 Msamp/s: an AM station at
    +AM_STATION_HZ, 80% depth on a TONE_HZ tone, with complex noise; and
    the ratio stream of a sound card disciplined to 48 kHz, AM_RATIO * (1
    + 2e-4 sin) with a 2 s period, 2^16 samples a block."""
    n = N_BLOCKS * BLOCK
    t = torch.arange(n, dtype=torch.float64, device=dev)
    msg = 0.8 * torch.sin(2 * np.pi * torch.frac(t * (TONE_HZ / AM_FS)))
    carrier = torch.polar(0.5 * (1 + msg), 2 * np.pi * torch.frac(
        t * (AM_STATION_HZ / AM_FS)))
    gen = torch.Generator(device=dev).manual_seed(21)
    iq = (carrier.to(torch.complex64) + 0.005 * torch.view_as_complex(
        torch.randn(n, 2, generator=gen, device=dev)))
    m = BLOCK // AM_DECIM
    k = torch.arange(N_BLOCKS * m, dtype=torch.float64, device=dev)
    rr = (AM_RATIO * (1 + 2e-4 * torch.sin(2 * np.pi * k / (2 * AM_RATE)))
          ).to(torch.float32)
    return [dict(iq=iq[b * BLOCK:(b + 1) * BLOCK], ratio=rr[b * m:(b + 1) * m])
            for b in range(N_BLOCKS)]


def am_channel_taps():
    """The AM channel's low-pass: 493 taps, 10 kHz cut-off, 5 kHz wide."""
    return fir.low_pass_taps(1.0, AM_FS, 10e3, 5e3)


def am_graph(device, per_input=2.0, channel=False):
    """channel (B1 at decim 16, 493 taps) -> AMDemod -> the ratio-stream
    resampler (kernel K2); Vectorize -> PowerSpectrum off the channel.
    With ``channel`` the channel's output is an output too."""
    fg = Flowgraph("am")
    chan = FreqXlatingFIRDecimator(
        am_channel_taps(), AM_DECIM, AM_STATION_HZ,
        AM_FS, name="channel", device=device)
    am = AMDemod(1e-3, 2.0, name="am", device=device)
    rs = VariableRatioResampler(BLOCK // AM_DECIM, per_input,
                                dtype=torch.float32, nominal_ratio=AM_RATIO,
                                name="audio_rs", device=device)
    framer = Vectorize(AM_FFT, name="framer")
    psd = PowerSpectrum(AM_FFT, "blackmanharris", 0.25, name="psd",
                        device=device)
    fg.input("iq", chan)
    fg.input("ratio", (rs, 1))
    fg.chain(chan, am, rs)
    fg.chain(chan, framer, psd)
    fg.output("audio", rs)
    fg.output("spectra", psd)
    if channel:
        fg.output("channel", chan)
    return fg


def am_path(dev):
    """The AM receiver over 8 blocks, counted like phase 3: the tone back
    in the 48 kHz audio, the station in its spectrum bin, blocks 0-1
    against the port on the CPU (the channel, B1's output, within 1e-5 of
    its max; audio counts and the resampler's q_int and mu_frac equal,
    audio within 1e-5 of the max), too small an output
    budget raising BUFFER_OVERRUN on the card as on the CPU; then timed and
    profiled."""
    feeds = am_scene(dev)
    (outs, flags, states), launches = counted(
        "AM path", AM_PATH_KERNELS, N_BLOCKS,
        lambda: run_inputs(am_graph(dev, channel=True), feeds, AM_FS))
    check(not any(f["audio"] for f in flags), "AM path: an overrun flag")
    audio = torch.cat(valid(outs, "audio")[1:]).cpu().numpy()
    check(bool(np.isfinite(audio).all()), "AM audio finite")
    f, sinad = tone_sinad(audio, AUDIO_RATE)
    n_audio = sum(int(o["audio"][1]) for o in outs)
    spec = outs[-1]["spectra"][0][: int(outs[-1]["spectra"][1])]
    peak = int(spec.mean(dim=0).argmax())
    print(f"AM path: {n_audio} audio samples from {N_BLOCKS * BLOCK} IQ "
          f"({n_audio / (N_BLOCKS * BLOCK / AM_FS):.1f} a second); tone "
          f"{f:.2f} Hz, SINAD {sinad:.2f} dB; station at spectrum bin "
          f"{peak} of {AM_FFT} (carrier at DC: {AM_FFT // 2})")
    check(abs(f - TONE_HZ) < 5.0, "AM tone frequency")
    check(sinad > 30.0, "AM tone SINAD")
    check(peak == AM_FFT // 2, "AM station not in its spectrum bin")
    cpu, cflags, cstates = run_inputs(am_graph("cpu", channel=True),
                                      to_cpu(feeds[:2]), AM_FS)
    worst, worst_chan = 0.0, 0.0
    for b in range(2):
        gz, cz = outs[b]["channel"][0].cpu(), cpu[b]["channel"][0]
        err = float((gz - cz).abs().max() / cz.abs().max())
        worst_chan = max(worst_chan, err)
        check(gz.shape == cz.shape and err <= 1e-5,
              f"AM channel block {b}: card and CPU differ {err:.3e}")
        (gy, gc), (cy, cc) = outs[b]["audio"], cpu[b]["audio"]
        check(int(gc) == int(cc), "AM audio counts, card and CPU")
        for k in ("q_int", "mu_frac"):
            check(int(states[b]["audio_rs"][k]) == int(cstates[b]["audio_rs"][k]),
                  f"AM resampler {k}, card and CPU")
        err = float((gy.cpu() - cy).abs().max() / cy.abs().max())
        worst = max(worst, err)
        check(err <= 1e-5, f"AM audio block {b}: card and CPU differ {err:.3e}")
        check(flags[b]["audio"] == cflags[b]["audio"], "AM flags")
    print(f"AM path blocks 0-1, card vs CPU: channel within "
          f"{worst_chan:.3e} of the max (bar 1e-5); audio counts, q_int, "
          f"mu_frac equal; audio within {worst:.3e} of the max (bar 1e-5)")
    over = [run_inputs(am_graph(d, per_input=0.5), fs, AM_FS)
            for d, fs in ((dev, feeds[:1]), ("cpu", to_cpu(feeds[:1])))]
    (go, gf, gs), (co, cf, cs) = over
    check(gf[0]["audio"] & stream_flags.BUFFER_OVERRUN
          and gf[0]["audio"] == cf[0]["audio"]
          and int(go[0]["audio"][1]) == int(co[0]["audio"][1])
          and int(gs[0]["audio_rs"]["q_int"]) == int(cs[0]["audio_rs"]["q_int"]),
          "AM overrun: the card and the CPU differ or no flag")
    print(f"AM path, 0.5 outputs an input: BUFFER_OVERRUN on the card and "
          f"the CPU, {int(go[0]['audio'][1])} outputs each")
    time_path("am", am_graph(dev), feeds, AM_FS, BLOCK, "Msamp/s",
              kernels=("vrr_kernel",))
    return launches


# ---------------------------------------------------------------------------
# the FasTrak decoder
# ---------------------------------------------------------------------------

FT_FS = 4e6
FT_OFF, FT_ON = 0.4, 1.0            # the tag's two envelope levels
FT_DELAY = 12 * FT_OS - 1 - FT_OS // 2   # sync peak -> the first bit's middle
FT_SYNC_THR = 0.75 * (FT_ON - FT_OFF) / 2   # of the matched filter's peak
FT_FRAMES = 24                       # a block
FASTRAK_PATH_KERNELS = ("fastrak_fsm", "fir_decimate_frame")
# the device functions of the FasTrak kernel's four passes
FASTRAK_PASSES = ("speculate_kernel", "chain_kernel", "apply_kernel",
                  "last_row_kernel")


def fastrak_scene(dev):
    """(iq [8 * 2^20] complex64 at 4 Msamp/s, the passing (id, count)
    sequence): a tag's OOK replies in noise, FT_FRAMES frames a block (its
    envelope FT_ON for a 1 bit and FT_OFF for a 0 bit and between
    replies, a random carrier phase a frame); IDs of FT_IDS in runs, so
    that the repeat count climbs; one frame with a bad CRC, a near-sync
    decoy (the sync word with its last bit flipped) alone, and one frame
    across the boundary of blocks 3 and 4."""
    rng = np.random.default_rng(23)
    n = N_BLOCKS * BLOCK
    env = np.full(n, FT_OFF, np.float32)
    phase = np.zeros(n, np.float32)
    starts = [b * BLOCK + 20000 + 43000 * k for b in range(N_BLOCKS)
              for k in range(FT_FRAMES)] + [4 * BLOCK - 300]
    starts.sort()
    run_id, left, expect, last, count = 0, 0, [], None, 0
    for i, p in enumerate(starts):
        if left == 0:
            run_id, left = (run_id + 1) % len(FT_IDS), int(rng.integers(1, 6))
        left -= 1
        ok = i != 50
        bits = fastrak_bits(FT_IDS[run_id], crc_ok=ok)
        wave = np.repeat(np.where(np.array(bits) == 1, FT_ON, FT_OFF), FT_OS)
        env[p:p + wave.size] = wave
        phase[p:p + wave.size] = rng.uniform(0, 2 * np.pi)
        if ok:
            count = count + 1 if FT_IDS[run_id] == last else 1
            last = FT_IDS[run_id]
            expect.append((last, count))
    decoy = np.repeat(np.where(np.array(fastrak_bits(0, word=0xAAD)[:12])
                               == 1, FT_ON, FT_OFF), FT_OS)
    env[BLOCK + 41000:BLOCK + 41000 + decoy.size] = decoy
    x = env * np.exp(1j * phase) + (0.05 / np.sqrt(2)) * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return torch.from_numpy(x.astype(np.complex64)).to(dev), expect


def fastrak_sync_taps():
    """The matched filter of the os-8 sync word's waveform (+-1 a bit),
    reversed and divided by its 96 taps."""
    wave = np.repeat(np.array(fastrak_bits(0)[:12], np.float32) * 2 - 1,
                     FT_OS)
    return wave[::-1] / wave.size


def fastrak_graph(device):
    """|iq| - the level midway between the tag's two (the bit metric); a
    matched filter of the os-8 sync word's waveform (FIRDecimator, B3 at
    decim 1) as the sync stream; VariableDelay aligning the metric so that
    bits are sampled mid-bit; FastrakDecoder on kernel K1."""
    fg = Flowgraph("fastrak")
    mag = basic.complex_to_mag()
    level = basic.add_const(-(FT_ON + FT_OFF) / 2)
    match = FIRDecimator(fastrak_sync_taps(), 1, dtype=torch.float32,
                         name="match", device=device)
    align = basic.VariableDelay(128, FT_DELAY, dtype=torch.float32,
                                name="align", device=device)
    dec = FastrakDecoder(FT_SYNC_THR, FT_OS, name="fastrak", device=device)
    fg.input("iq", mag)
    fg.chain(mag, level, match)
    fg.chain(level, align)
    fg.connect(align, (dec, 0))
    fg.connect(match, (dec, 1))
    fg.output("events", dec)
    fg.output("metric", align)
    fg.output("sync", match)
    return fg


def fastrak_ids(outs):
    return [(int(r[0]) << 16 | int(r[1]), int(r[2]))
            for o in outs for r in o["events"][0][: int(o["events"][1])].cpu()]


def fastrak_path(dev):
    """The FasTrak path over 8 blocks, counted like phase 3: every passing
    ID with its repeat count, the bad CRC and the decoy not; K1's events
    and whole state over blocks 0-1 bit for bit its plain version's on the
    same card-computed metric and sync; the path on the CPU over blocks
    0-1 the same IDs and counts, and its metric and sync (B3's output)
    within 1e-5 of their max; then timed and profiled."""
    iq, expect = fastrak_scene(dev)
    feeds = [dict(iq=iq[b * BLOCK:(b + 1) * BLOCK]) for b in range(N_BLOCKS)]
    (outs, _, states), launches = counted(
        "FasTrak path", FASTRAK_PATH_KERNELS, N_BLOCKS,
        lambda: run_inputs(fastrak_graph(dev), feeds, FT_FS))
    got = fastrak_ids(outs)
    print(f"FasTrak path: {len(got)} IDs over {N_BLOCKS} blocks (planted "
          f"{len(expect)} passing, 1 bad CRC, 1 decoy); counts "
          f"{[c for _, c in got[:12]]} ...; events a block "
          f"{[int(o['events'][1]) for o in outs]}")
    check(got == expect, "FasTrak IDs and counts are not the planted ones")
    st = {k: v.reshape(1) for k, v in FastrakDecoder(
        device="cpu").init_state().items()}
    for b in range(2):
        m = outs[b]["metric"][0].reshape(1, -1).cpu()
        y = outs[b]["sync"][0].reshape(1, -1).cpu()
        ev, c, st = misc.fastrak_fsm_plain(m, y, st, torch.tensor([FT_SYNC_THR]),
                                           FT_OS)
        check(same_bits(outs[b]["events"][0], ev[0])
              and int(outs[b]["events"][1]) == int(c[0]),
              f"FasTrak block {b}: K1's events differ from its plain version")
        card = states[b]["fastrak"]
        check(all(torch.equal(card[k].cpu().reshape(1), st[k]) for k in st),
              f"FasTrak block {b}: K1's state differs from its plain version")
    cpu, _, _ = run_inputs(fastrak_graph("cpu"), to_cpu(feeds[:2]), FT_FS)
    check(fastrak_ids(cpu) == fastrak_ids(outs[:2]),
          "FasTrak path on the CPU: other IDs or counts")
    worst = {}
    for port in ("metric", "sync"):
        for b in range(2):
            g, c = outs[b][port][0].cpu(), cpu[b][port][0]
            err = float((g - c).abs().max() / c.abs().max())
            worst[port] = max(worst.get(port, 0.0), err)
            check(g.shape == c.shape and err <= 1e-5,
                  f"FasTrak {port} block {b}: card and CPU differ {err:.3e}")
    print(f"FasTrak path blocks 0-1: K1's events and state bit-equal to its "
          f"plain version on the card's metric and sync; the CPU path finds "
          f"the same {len(fastrak_ids(cpu))} IDs and counts; card vs CPU "
          f"metric within {worst['metric']:.3e}, sync within "
          f"{worst['sync']:.3e} of the max (bar 1e-5)")
    time_path("fastrak", fastrak_graph(dev), feeds, FT_FS, BLOCK, "Msamp/s",
              kernels=FASTRAK_PASSES)
    return launches


# ---------------------------------------------------------------------------
# the decoders and FEC (ops/decode.py, ops/fec.py, models/auto_fec.py)
# ---------------------------------------------------------------------------

DEC_BLOCK = 1 << 14      # the JAX benchmark's decoder block (benchmarks.py)
DEC_BANK = 64            # and its bank of streams
FEC_BLOCK = 1 << 16      # QPSK symbols a block: ~0.9 s at LRPT's 72 ksym/s
FEC_OVERLAP = 96
FEC_NOISE = 0.4          # per component, on +-1 symbols: ~0.6% hard errors
FEC_ROTATION = 3         # the channel's rotation (with a conjugation)
FEC_LOCKED = (1, True)   # the transform that undoes it
PN_BLOCK = 1 << 20
PN_FLIP = 0.01
DECODE_KERNELS = ("acars_fsm", "manchester_fsm", "dpll_walk")
# the decoders path's pulse trains: (period, the DPLL's start, its gain)
DPLL_TRAINS = ((100.3, 97.0, 0.1), (16.0, 15.5, 0.05))
SOH, STX, ETX, DEL = 0x01, 0x02, 0x03, 0x7F


def acars_payload(rng, text: bytes):
    """One downlink's bytes: SOH, mode, address, ack, label, block id,
    STX, sequence number and flight, ``text``, ETX, two CRC bytes, DEL
    (the layout ``utils/acars.py`` parses)."""
    addr = b".N%05d" % int(rng.integers(0, 100000))
    flight = b"XA%04d" % int(rng.integers(0, 10000))
    return ([SOH] + list(b"2") + list(addr) + [0x15] + list(b"H1")
            + list(b"5") + [STX] + list(b"M01A") + list(flight) + list(text)
            + [ETX] + [int(v) for v in rng.integers(0x20, 0x7F, 2)] + [DEL])


def acars_air(payload) -> np.ndarray:
    """Air bits of one packet: the preamble 0x3FFE5C5C, then each byte LSB
    first with an odd-parity bit, differentially encoded (a 1 where the
    bit changes)."""
    tx = []
    for byte in payload:
        bits = [(byte >> i) & 1 for i in range(7)]
        tx += bits + [1 - sum(bits) % 2]
    pre = [(0x3FFE5C5C >> (31 - i)) & 1 for i in range(32)]
    return np.array(pre + list(np.abs(np.diff([0] + tx))), np.int64)


def acars_rows(rng, rows, n, gap=(40, 400)):
    """[rows, n] float32 bit metrics (> 0: air bit 0) of ACARS packets
    after gaps of ``gap`` air bits, amplitudes 0.5-1.5 with no sign
    error; and each row's payloads in order."""
    out = np.empty((rows, n), np.float32)
    sent = []
    for r in range(rows):
        air, pays = [], []
        while sum(map(len, air)) < n:
            air.append(np.zeros(int(rng.integers(*gap)), np.int64))
            pays.append(acars_payload(rng, b"TEXT %d" % len(pays)))
            air.append(acars_air(pays[-1]))
        bits = np.concatenate(air)[:n]
        out[r] = np.where(bits == 1, -1.0, 1.0) * rng.uniform(0.5, 1.5, n)
        sent.append(pays)
    return out, sent


def acars_noise_rows(rng, rows, n):
    """[rows, n] float32 metrics of noise: at threshold 8 false syncs start
    packets that run to the 252-byte cap."""
    return rng.standard_normal((rows, n)).astype(np.float32)


def preamble_tail(pay):
    """``pay`` (247 bytes) and five bytes more: byte 247 and four whose air
    bits (each byte's 7 bits LSB first and its odd-parity bit, sent
    differentially) come nearest the preamble's 32, each bit solved in
    turn, a parity bit off by at most one air bit."""
    pre = [(0x3FFE5C5C >> (31 - i)) & 1 for i in range(32)]
    best = None
    for b247 in range(0x20, 0x7F):
        tx = []
        for byte in pay + [b247]:
            bits = [(byte >> i) & 1 for i in range(7)]
            tx += bits + [1 - sum(bits) % 2]
        prev, tail = tx[-1], []
        for k in range(4):
            data = []
            for i in range(7):
                prev ^= pre[8 * k + i]
                data.append(prev)
            prev = 1 - sum(data) % 2          # the parity bit, forced
            tail.append(sum(b << i for i, b in enumerate(data)))
        air = acars_air(pay + [b247] + tail)[-32:]
        wrong = int(np.sum(air != np.array(pre)))
        if best is None or wrong < best[0]:
            best = (wrong, pay + [b247] + tail)
    assert best[0] <= 4
    return best[1]


def acars_edge_rows(rng, n, calls=2):
    """[10, calls * n] float32 metrics at the ACARS walk's edges, for calls
    of n bits. Rows 0-7: at every call boundary a packet still open, the
    boundary falling o = 0..7 bits into its byte; row 8: a preamble across
    every boundary but the first, its sync 5-23 bits into the call (found
    only with the carried register); row 9: a packet with DEL at
    ``etx + 2`` and not at ``etx + 3``, which runs to 252 bytes, its last
    four bytes chosen so that its last 32 air bits are within 4 bits of
    the preamble (at threshold 4 its last bit is a candidate, which the
    search must not take). Packets after gaps of 10-60 bits fill the rest
    of every row."""
    total = calls * n
    out = np.empty((10, total), np.float32)
    for r in range(10):
        fixed = []
        for c in range(calls):
            b = c * n
            if r < 8 and c:
                # the sync bit s: b - (s + 1) = 8 * 6 + r
                fixed.append(b - 1 - 48 - r - 31)
            elif r == 8 and c:
                fixed.append(b + 5 + 9 * (c % 3) - 31)
            elif r == 9:
                fixed.append(b + 100)
        air, at = [], 0
        for start in fixed + [total]:
            while True:      # packets up to the next fixed one
                gap = int(rng.integers(10, 60))
                pay = acars_payload(rng, b"EDGE %d" % len(air))
                bits = acars_air(pay)
                if at + gap + len(bits) + 10 > start:
                    break
                air += [np.zeros(gap, np.int64), bits]
                at += gap + len(bits)
            if start >= total:
                break
            air.append(np.zeros(start - at, np.int64))
            pay = acars_payload(rng, b"EDGE %d" % len(air))
            if r == 9:
                pay[-2], pay[-1] = DEL, 0x41
                pay = preamble_tail(pay + [0x41] * (247 - len(pay)))
            air.append(acars_air(pay))
            at = start + len(air[-1])
        bits = np.concatenate(air + [np.zeros(max(0, total - at), np.int64)])
        out[r] = (np.where(bits[:total] == 1, -1.0, 1.0)
                  * rng.uniform(0.5, 1.5, total))
    return out


def manchester_rows(rng, rows, n):
    """[rows, n] uint8 Manchester chips (a 1 as 0 then 1) of random bits,
    each row with one chip dropped at a random place (the decoder must
    slip to resync) and a few chips flipped; and each row's bits."""
    out = np.empty((rows, n), np.uint8)
    sent = []
    for r in range(rows):
        bits = rng.integers(0, 2, n // 2 + 8).astype(np.uint8)
        chips = np.stack([1 - bits, bits], 1).reshape(-1)
        drop = int(rng.integers(n // 8, n - n // 8))
        chips = np.delete(chips, drop)[:n]
        chips[rng.integers(0, n, 3)] ^= 1
        out[r] = chips
        sent.append(bits)
    return out, sent


def pulse_rows(rng, rows, n, period=(12.0, 130.0)):
    """[rows, n] uint8 pulse trains, each row at its own period with
    +-0.4 samples of jitter, a few pulses missing and a few strays."""
    out = np.zeros((rows, n), np.uint8)
    for r in range(rows):
        p = rng.uniform(*period)
        pos = np.arange(rng.uniform(0, p), n, p) + rng.uniform(-0.4, 0.4)
        pos = np.clip(pos, 0, n - 1).astype(np.int64)
        pos = pos[rng.random(len(pos)) > 0.02]
        out[r, pos] = 1
        out[r, rng.integers(0, n, 3)] = 1
    return out


def dpll_edge_rows(rng, n, calls=2):
    """[6, calls * n] uint8 pulse rows at the DPLL walk's edges, for calls
    of n samples: no pulse at all; a pulse at each call's sample 0, then
    every 47 samples; a pulse every 3 samples (past 512 events a call);
    pulses at each call's tile edges (1023, 1024, 2047, 2048) and last
    sample over a period-100 train; the decoders path's period-16 train;
    a jittered train with missing and stray pulses."""
    total = calls * n
    out = np.zeros((6, total), np.uint8)
    for c in range(calls):
        out[1, c * n:(c + 1) * n:47] = 1
        for j in (1023, 1024, 2047, 2048, n - 1):
            if j < n:
                out[3, c * n + j] = 1
    out[2, ::3] = 1
    out[3, 50::100] = 1
    out[4, np.arange(0.0, total, 16.0).astype(np.int64)] = 1
    out[5] = pulse_rows(rng, 1, total, period=(20.0, 60.0))[0]
    return out


def rows_state(block, rows, dev):
    """``block``'s initial state as [rows] tensors (ACARS's packet [rows,
    252])."""
    return {k: v.reshape(1, -1).expand(rows, -1).contiguous() if v.dim()
            else v.reshape(1).expand(rows).contiguous()
            for k, v in block.init_state().items()}


def same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)


def serial_case(name, shape, rows, n, xs, st0, call, plain, nbytes, probe,
                outputs):
    """A serial FSM kernel on ``rows`` streams: ``call(fn, x, st)`` runs the
    wrapper (or its plain version ``plain``) on one [rows, n] input from
    state ``st`` and returns (outputs..., new state). The check chains the
    two inputs ``xs`` through both and holds every output and the whole
    state bit for bit; ``outputs(res)`` is the float tensor the error line
    reads. Its bytes: inputs read once, outputs written once. Its chain
    bound, printed beside it: n steps of the kernel's step alone (timed by
    ``probe()``, ns)."""
    label = f"{name} [{shape}, [{rows}, {n}]]"

    def chain(fn):
        st, out = st0, []
        for x in xs:
            res = call(fn, x, st)
            out.append(res)
            st = res[-1]
        return out

    def held():
        kern, ref = chain(KERNELS[name][0][0]), chain(plain)
        torch.cuda.synchronize()
        for c, (g, p) in enumerate(zip(kern, ref)):
            check(all(same_bits(a, b) for a, b in zip(g[:-1], p[:-1]))
                  and same_state(g[-1], p[-1]),
                  f"{label} call {c}: outputs or state differ from the "
                  "plain version")
        print(f"{label}: two chained calls, outputs and state bit-equal to "
              "the plain version")
        return outputs(kern[-1]), outputs(ref[-1])

    def chain_bound():
        step_ns = probe()
        return (f"the walk's chain: {n} steps x {step_ns:.3f} ns a dependent "
                f"step = {n * step_ns / 1e6:.4f} ms")

    return dict(name=name, shape=f"{shape}, [{rows}, {n}]",
                kernel=lambda i: call(KERNELS[name][0][0], xs[i % 2], st0),
                plain=lambda i: call(plain, xs[i % 2], st0),
                check=held, iters=20, plain_iters=1, library=None,
                nbytes=nbytes, flops=0, after=probe and chain_bound)


def acars_syncs(m, thr):
    """Syncs the ACARS walk takes in each row of one call ``m`` [rows, n]
    (a lower bound of the packets it walks: the register starts empty and
    a carried packet is not counted). A numpy walk: the candidates, then
    from each sync the packet's bytes by the running parity."""
    out = []
    for row in m:
        bits = (~(row > 0)).astype(np.int64)
        win = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([np.zeros(31, np.int64), bits]), 32)
        shifts = (win << np.arange(31, -1, -1)).sum(1)
        wrong = sum(np.unpackbits(((shifts ^ 0x3FFE5C5C) >> s & 0xFF)
                                  .astype(np.uint8)[:, None], axis=1).sum(1)
                    for s in (0, 8, 16, 24))
        cand = np.flatnonzero(wrong <= thr)
        px = np.cumsum(bits) & 1
        pos, count = 0, 0
        while True:
            j = np.searchsorted(cand, pos)
            if j == len(cand):
                break
            s = int(cand[j])
            count += 1
            dec = px[s + 1:s + 1 + 8 * 252] ^ px[s]
            nb = len(dec) // 8
            val = (dec[:8 * nb].reshape(nb, 8)[:, :7] << np.arange(7)).sum(1)
            etx = np.flatnonzero((np.arange(nb) > 13) & (val == 3))
            end = 251
            if len(etx) and etx[0] + 3 < nb and val[etx[0] + 3] == 0x7F:
                end = int(etx[0]) + 3
            if end >= nb:
                break          # open at the call's end
            pos = s + 8 * (end + 1) + 1
        out.append(count)
    return out


def acars_case(dev, seed, rows, shape, metrics=None, thr=2):
    """K4 on ``metrics`` [rows, 2 * DEC_BLOCK] (by default ``acars_rows``,
    gaps of 10-60 bits) at threshold ``thr`` as two chained calls. Its
    chain bound, printed beside it: the row's bytes at the card's rate
    (staging) plus the busiest row's syncs (the mean of the two calls)
    times one packet of the walk alone (``af.packet_ns``)."""
    rng = np.random.default_rng(seed)
    m = (acars_rows(rng, rows, 2 * DEC_BLOCK, gap=(10, 60))[0]
         if metrics is None else metrics)
    xs = [torch.from_numpy(np.ascontiguousarray(
        m[:, c * DEC_BLOCK:(c + 1) * DEC_BLOCK])).to(dev) for c in range(2)]
    n_fields = len(decode.ACARS_FIELDS)
    case = serial_case(
        "acars_fsm", shape, rows, DEC_BLOCK, xs,
        rows_state(decode.ACARSDecoder(device=dev), rows, dev),
        lambda fn, x, st: fn(x, st, thr), decode.acars_plain,
        rows * (4 * DEC_BLOCK + 4 * 4 * 254 + 4 + 2 * 4 * (n_fields + 252)),
        None, lambda res: res[0])
    most = float(np.mean([max(acars_syncs(m[:, c * DEC_BLOCK:
                                            (c + 1) * DEC_BLOCK], thr))
                          for c in range(2)]))

    def chain_bound():
        pk = af.packet_ns()
        stage = 4 * DEC_BLOCK * rows / PEAK_BYTES * 1e3
        return (f"the walk's chain: staging {stage:.5f} ms + {most:.1f} "
                f"syncs x {pk:.1f} ns a packet = "
                f"{stage + most * pk / 1e6:.4f} ms")
    case["after"] = chain_bound
    return case


def manchester_case(dev, seed, rows, shape, chips=None, original=False,
                    window=16, thr=8):
    """K5 on ``chips`` [rows, 2 * DEC_BLOCK] (by default
    ``manchester_rows``) as two chained calls, the second's counts partial
    on every third row. Its chain bound, printed beside it: the head's 64
    steps (``mf.chain_step_ns``) and one map lookup a chunk
    (``mf.compose_step_ns``)."""
    rng = np.random.default_rng(seed)
    if chips is None:
        chips, _ = manchester_rows(rng, rows, 2 * DEC_BLOCK)
    xs = [torch.from_numpy(np.ascontiguousarray(
        chips[:, c * DEC_BLOCK:(c + 1) * DEC_BLOCK])).to(dev)
        for c in range(2)]
    # the second call's rows end early, the padding walked but not emitted
    counts = torch.tensor([DEC_BLOCK] * rows, dtype=torch.int32, device=dev)
    counts[::3] = DEC_BLOCK - 1001

    def call(fn, x, st):
        return fn(x, counts if x is xs[1] else counts.clamp(min=DEC_BLOCK),
                  st, original, window, thr)
    case = serial_case(
        "manchester_fsm", shape, rows, DEC_BLOCK, xs,
        rows_state(decode.ManchesterDecode(device=dev), rows, dev), call,
        decode.manchester_plain,
        rows * (DEC_BLOCK + DEC_BLOCK // 2 + 1 + 4 + 4 + 2 * 16), None,
        lambda res: res[0].to(torch.float32))
    chunks = -(-(DEC_BLOCK - mf.HEAD) // mf.CHUNK)

    def chain_bound():
        step, look = mf.chain_step_ns(), mf.compose_step_ns()
        ms = (mf.HEAD * step + chunks * look) / 1e6
        return (f"the walk's chain: {mf.HEAD} head steps x {step:.3f} ns + "
                f"{chunks} chunks x {look:.3f} ns (a map lookup) = "
                f"{ms:.4f} ms")
    case["after"] = chain_bound
    return case


def manchester_noise(rng, rows, n):
    """[rows, n] uint8 random chips (slips everywhere), the last row
    alternating 0, 1 (at threshold 0 it emits at every sample, past the
    n / 2 + 1 slots)."""
    chips = rng.integers(0, 2, (rows, n)).astype(np.uint8)
    chips[-1] = np.arange(n) % 2
    return chips


def dpll_case(dev, shape, pulses, period0, gain=0.05, rel=0.05, ign=0.5):
    """K6 on the rows ``pulses`` [rows, 2 * DEC_BLOCK] uint8 as two
    chained calls, from the periods ``period0`` [rows]. Its chain bound,
    printed beside it: DEC_BLOCK fadd latencies plus the busiest row's
    pulses (the mean of the two calls) times a pulse step, each timed
    alone by its probe (``dw.fadd_step_ns``, ``dw.pulse_step_ns``)."""
    rows = pulses.shape[0]
    xs = [torch.from_numpy(np.ascontiguousarray(
        pulses[:, c * DEC_BLOCK:(c + 1) * DEC_BLOCK])).to(dev)
        for c in range(2)]
    st0 = rows_state(decode.DPLLBitSync(16.0, device=dev), rows, dev)
    st0["period"] = torch.as_tensor(np.asarray(period0, np.float32)).to(dev)
    case = serial_case(
        "dpll_walk", shape, rows, DEC_BLOCK, xs, st0,
        lambda fn, x, st: fn(x, st, gain, rel, ign), decode.dpll_plain,
        rows * (6 * DEC_BLOCK + 512 * 12 + 4 + 2 * 20), None,
        lambda res: res[1])
    most = float(np.mean([(pulses[:, c * DEC_BLOCK:(c + 1) * DEC_BLOCK] != 0)
                          .sum(1).max() for c in range(2)]))

    def chain_bound():
        fadd, pulse = dw.fadd_step_ns(), dw.pulse_step_ns()
        ms = (DEC_BLOCK * fadd + most * pulse) / 1e6
        return (f"the walk's chain: {DEC_BLOCK} samples x {fadd:.3f} ns "
                f"(fadd) + {most:.1f} pulses x {pulse:.3f} ns (pulse step) "
                f"= {ms:.4f} ms")
    case["after"] = chain_bound
    return case


def dpll_cases(dev):
    """K6 at the decoders path's [1, 2^14] (a random train, PR 10's row;
    the path's two trains), the JAX benchmark's bank [64, 2^14] and the
    edge rows (``dpll_edge_rows``) with and without the fused gain
    product."""
    cases = []
    for seed, rows, shape in ((37, 1, "decoders path"),
                              (38, DEC_BANK, "decoder bank")):
        rng = np.random.default_rng(seed)
        pulses = pulse_rows(rng, rows, 2 * DEC_BLOCK)
        cases.append(dpll_case(dev, shape, pulses,
                               rng.uniform(11.0, 140.0, rows)))
    for period, start, gain in DPLL_TRAINS:
        train = np.zeros((1, 2 * DEC_BLOCK), np.uint8)
        train[0, np.arange(0.0, 2 * DEC_BLOCK, period).astype(np.int64)] = 1
        cases.append(dpll_case(dev, f"the path's train, period {period}",
                               train, [start], gain))
    edge = dpll_edge_rows(np.random.default_rng(39), DEC_BLOCK)
    starts = [16.0, 47.0, 3.0, 100.0, 16.0, 40.0]
    cases.append(dpll_case(dev, "edge rows, gain = limit = 0.05 (fused)",
                           edge, starts))
    cases.append(dpll_case(dev, "edge rows, gain 0.3, limit 0.4", edge,
                           starts, 0.3, 0.4, 0.3))
    return cases


def fec_bits(rng, n):
    """(bits [n] uint8, code [n, 2] int64): random bits through the
    rate-1/2 K=7 (171, 133) encoder from the zero state."""
    bits = rng.integers(0, 2, n).astype(np.uint8)
    return bits, reencode(torch.from_numpy(bits), 7, (0o171, 0o133)).numpy()


def soft_pairs(rng, n, noise=FEC_NOISE):
    """(bits, [n, 2] float32 soft pairs of their code, +-1 plus noise)."""
    bits, code = fec_bits(rng, n)
    soft = code.astype(np.float32) * 2 - 1
    return bits, soft + noise * rng.standard_normal((n, 2)).astype(np.float32)


def viterbi_case(dev, seed, overlap, shape):
    """K3 on one stream of FEC_BLOCK + ``overlap`` soft pairs (K = 7,
    171/133). Two chained calls: with an overlap, the second call's first
    pairs are the first call's last (a ViterbiDecoder's blocks); bits and
    final path metrics bit-equal to the plain version. Its bytes: the
    pairs read once, the bits and path metrics written once."""
    rng = np.random.default_rng(seed)
    _, soft = soft_pairs(rng, 2 * FEC_BLOCK + overlap)
    soft = torch.from_numpy(soft).to(dev)
    t_len = FEC_BLOCK + overlap
    xs = [soft[:t_len].contiguous(),
          soft[FEC_BLOCK:FEC_BLOCK + t_len].contiguous()]
    exp = torch.from_numpy(fec.expected_outputs(7, (0o171, 0o133))).to(dev)
    label = f"viterbi [{shape}, [{t_len}, 2]]"

    def held():
        out = []
        for x in xs:
            (bk, pk), (bp, pp) = vt.viterbi(x, exp), fec.viterbi_plain(x, exp)
            torch.cuda.synchronize()
            check(same_bits(bk, bp) and same_bits(pk, pp),
                  f"{label}: bits or path metrics differ from the plain "
                  "version")
            out.append((bk, bp))
        print(f"{label}: two chained calls, bits and final path metrics "
              "bit-equal to the plain version")
        return out[-1][0].to(torch.float32), out[-1][1].to(torch.float32)

    def chain_bound():
        step_ns = vt.chain_step_ns()
        return (f"the add-compare-select chain: {t_len} steps x {step_ns:.3f}"
                f" ns a warp step = {t_len * step_ns / 1e6:.4f} ms")

    return dict(name="viterbi", shape=f"{shape}, [{t_len}, 2]",
                kernel=lambda i: vt.viterbi(xs[i % 2], exp)[0],
                plain=lambda i: fec.viterbi_plain(xs[i % 2], exp)[0],
                check=held, iters=10, plain_iters=1, library=None,
                nbytes=9 * t_len + 64 * 4 + 256 * 4, flops=0,
                after=chain_bound)


def decode_kernel_cases(dev):
    """K3 at an AutoFEC block and a ViterbiDecoder block; K4 and K5 at the
    decoders path's [1, 2^14] and the JAX benchmark's bank [64, 2^14]; K4
    on noise at threshold 8 and on ``acars_edge_rows`` at threshold 4; K5
    on random chips at windows 1 and 31, thresholds 0 and window + 1,
    both ``original``; K6 as ``dpll_cases``."""
    rng = np.random.default_rng(42)
    return [viterbi_case(dev, 31, 0, "AutoFEC block"),
            viterbi_case(dev, 32, FEC_OVERLAP, "ViterbiDecoder block"),
            acars_case(dev, 33, 1, "decoders path"),
            acars_case(dev, 34, DEC_BANK, "decoder bank"),
            acars_case(dev, 40, 1, "noise, threshold 8",
                       acars_noise_rows(rng, 1, 2 * DEC_BLOCK), thr=8),
            acars_case(dev, 41, 10, "edge rows, threshold 4",
                       acars_edge_rows(rng, DEC_BLOCK), thr=4),
            manchester_case(dev, 35, 1, "decoders path"),
            manchester_case(dev, 36, DEC_BANK, "decoder bank"),
            *[manchester_case(dev, 43, 4, f"random chips, window {w}, "
                              f"threshold {thr}, original {orig}",
                              manchester_noise(rng, 4, 2 * DEC_BLOCK), orig,
                              w, thr)
              for w, thr, orig in ((1, 0, False), (1, 2, True), (31, 0, True),
                                   (31, 32, False))],
            *dpll_cases(dev)]


# K3 at every constraint length: polynomials with bit K - 1 set
VITERBI_CODES = {2: (0o3, 0o2), 3: (0o7, 0o5), 4: (0o17, 0o13),
                 5: (0o23, 0o35), 6: (0o53, 0o75), 7: (0o171, 0o133),
                 8: (0o247, 0o371), 9: (0o561, 0o753), 10: (0o1167, 0o1545),
                 11: (0o2335, 0o3661), 12: (0o4335, 0o5723),
                 15: (0o46321, 0o51271)}


def coded_pairs(rng, t_len, k, polys, noise=0.7):
    """[t_len, 2] float32 soft pairs of random bits through the (k,
    polys) encoder with noise, every tenth pair erased (0, 0): ties."""
    bits = rng.integers(0, 2, t_len).astype(np.uint8)
    soft = fec.conv_encode(bits, k, polys).astype(np.float32) * 2 - 1
    soft = soft + noise * rng.standard_normal(soft.shape)
    soft[rng.random(t_len) < 0.1] = 0.0
    return soft.astype(np.float32)


def viterbi_lengths_phase(dev):
    """K3 at every K of VITERBI_CODES: one pair, and 3000 pairs (T not a
    multiple of the traceback chunk; 1000 at K = 15), bits and final path
    metrics bit-equal to the plain version, each launch timed. Then
    viterbi_decode, ViterbiDecoder (three blocks) and AutoFEC (two
    blocks) at K = 2 and 10 on the card, bit-equal to the port on the
    CPU."""
    rng = np.random.default_rng(53)
    for k, polys in VITERBI_CODES.items():
        exp = torch.from_numpy(fec.expected_outputs(k, polys))
        for t_len in (1, 1000 if k >= 15 else 3000):
            soft = torch.from_numpy(coded_pairs(rng, t_len, k, polys))
            (bk, pk), (bp, pp) = (vt.viterbi(soft.to(dev), exp.to(dev)),
                                  fec.viterbi_plain(soft, exp))
            torch.cuda.synchronize()
            check(same_bits(bk, bp) and same_bits(pk, pp),
                  f"viterbi K={k} T={t_len}: bits or path metrics differ "
                  "from the plain version")
        x, e = soft.to(dev), exp.to(dev)
        ms = time_ms(lambda i: vt.viterbi(x, e), 5)
        print(f"viterbi K={k} ({len(pk)} states): T=1 and T={t_len} "
              f"bit-equal to the plain version; {ms:.4f} ms a launch at "
              f"T={t_len} ({1e6 * ms / t_len:.1f} ns a step)")
    for k in (2, 10):
        polys = VITERBI_CODES[k]
        soft = coded_pairs(rng, 3 * 2000, k, polys, noise=0.5)
        got = fec.viterbi_decode(torch.from_numpy(soft).to(dev), k, polys)
        want = fec.viterbi_decode(torch.from_numpy(soft), k, polys)
        check(same_bits(got, want), f"viterbi_decode K={k}: card and CPU")
        blocks = [torch.from_numpy(soft[b * 2000:(b + 1) * 2000])
                  for b in range(3)]
        outs = {}
        for d in (dev, "cpu"):
            blk = ViterbiDecoder(k, polys, overlap=64, device=d)
            st, outs[d] = blk.init_state(), []
            for x in blocks:
                st, (o,) = blk.apply(st, None, Stream.full(x.to(d)))
                outs[d].append((o.data, st["tail"]))
        check(all(same_bits(a, b) for g, c in zip(outs[dev], outs["cpu"])
                  for a, b in zip(g, c)),
              f"ViterbiDecoder K={k}: card and CPU differ")
        sym = torch.complex(torch.from_numpy(soft[:, 0]),
                            torch.from_numpy(soft[:, 1]))
        fed = {}
        for d in (dev, "cpu"):
            afec = AutoFEC(k=k, polys=polys, device=d)
            fed[d] = [afec.feed(sym[b * 2000:(b + 1) * 2000])
                      for b in range(2)]
        check(all(same_bits(g[0], c[0]) and g[1:] == c[1:]
                  for g, c in zip(fed[dev], fed["cpu"])),
              f"AutoFEC K={k}: card and CPU differ")
        print(f"K={k} on the card: viterbi_decode (6000 pairs), "
              "ViterbiDecoder (3 blocks of 2000, overlap 64) and AutoFEC "
              f"(2 blocks, BER {[round(f[1], 5) for f in fed[dev]]}) "
              "bit-equal to the CPU")


def fec_scene(dev, blocks):
    """(symbols [blocks * FEC_BLOCK] complex64 on ``dev``, bits): a
    continuous K=7 coded bit stream as QPSK (code bits in the signs of
    real and imag) with noise, conjugated and rotated by the inverse of
    FEC_ROTATION's fixing rotation, as tests/test_autofec_fsk4.py's
    streams."""
    rng = np.random.default_rng(41)
    bits, code = fec_bits(rng, blocks * FEC_BLOCK)
    c = code.astype(np.float32) * 2 - 1
    sym = (c[:, 0] + 1j * c[:, 1]) + FEC_NOISE * (
        rng.standard_normal(len(c)) + 1j * rng.standard_normal(len(c)))
    sym = np.conj(sym) / _ROTATIONS[FEC_ROTATION]
    return torch.from_numpy(sym.astype(np.complex64)).to(dev), bits


def bit_errors(got, want):
    """Share of bits that differ, up to the code's 180-degree complement,
    past the first and last 16 (tests/test_autofec_fsk4.py:50-55)."""
    g = got[16:-16].astype(np.int64)
    w = want[16:-16].astype(np.int64)
    return min(float(np.mean(g != w)), float(np.mean(g != 1 - w)))


def fec_path(dev):
    """The FEC path: AutoFEC over blocks of FEC_BLOCK symbols steps to
    the channel's transform and locks, then decodes 8 blocks (one K3
    launch a block, counted like phase 3), the bits the planted ones up
    to the complement; ViterbiDecoder(overlap=96) over the same soft pairs
    in 8 blocks; the first block's first 2^14 symbols through fec_eval
    on the CPU, bits and BER equal; then GLFSRSource -> 1% flips ->
    PNBERv at 2^20 bits a block, its estimate inside the JAX test's bar
    and within 1e-6 of the CPU's. Timed and profiled."""
    search = 8
    sym, bits = fec_scene(dev, search + N_BLOCKS)
    afec = AutoFEC(device=dev)
    fed = []

    def feed_all():
        for b in range(search + N_BLOCKS):
            out = afec.feed(sym[b * FEC_BLOCK:(b + 1) * FEC_BLOCK])
            fed.append(out)
            if sum(f[2] for f in fed) == N_BLOCKS:
                return
    # counted like phase 3, but the run ends when N_BLOCKS blocks have
    # decoded under the lock, so its length is known only after it
    reset_launches()
    feed_all()
    launches = launch_counts()
    n_fed = len(fed)
    check(launches["viterbi"] == n_fed and sum(launches.values()) == n_fed,
          f"FEC path: {launches} launches over {n_fed} blocks")
    lock_at = next(i for i, f in enumerate(fed) if f[2])
    print(f"FEC path (AutoFEC, {FEC_BLOCK} symbols a block): locked after "
          f"block {lock_at} at step {afec.steps}, transform (rotation "
          f"{afec.rotation}, conjugate {afec.conjugate}); BER a block "
          f"{[round(f[1], 5) for f in fed]}; launches {launches['viterbi']} "
          f"over {n_fed} blocks")
    check((afec.rotation, afec.conjugate) in (FEC_LOCKED, (3, True))
          and not afec.vit_delay and not afec.vit_swap,
          "AutoFEC locked on another transform")
    worst = 0.0
    for b, (got, ber, locked) in enumerate(fed):
        if not locked:
            continue
        err = bit_errors(got.cpu().numpy(),
                         bits[b * FEC_BLOCK:(b + 1) * FEC_BLOCK])
        worst = max(worst, err)
        check(err < 0.01 and ber < 0.02,
              f"FEC block {b}: bit errors {err:.4f}, BER {ber:.4f}")
    print(f"FEC path: {sum(f[2] for f in fed)} locked blocks, bit errors "
          f"at most {worst:.2e} of the planted bits (up to the complement)")
    rot, conj = afec.rotation, afec.conjugate
    head = sym[:1 << 14]
    gb, gber = fec_eval(head, rot, conj, False, False)
    cb_, cber = fec_eval(head.cpu(), rot, conj, False, False)
    check(same_bits(gb, cb_) and same_bits(gber, cber),
          "fec_eval on the card and the CPU differ")
    print(f"FEC path, 2^14 symbols card vs CPU: bits and BER "
          f"({float(gber):.6f}) equal")
    # ViterbiDecoder over the fixed soft pairs
    fixed = torch.conj(sym) * torch.tensor(_ROTATIONS[rot], device=dev) \
        if conj else sym * torch.tensor(_ROTATIONS[rot], device=dev)
    soft = torch.stack([fixed.real, fixed.imag], 1)
    xs = [soft[(search + b) * FEC_BLOCK:(search + b + 1) * FEC_BLOCK]
          .contiguous() for b in range(N_BLOCKS)]
    vdec = ViterbiDecoder(overlap=FEC_OVERLAP, name="vdec", device=dev)
    outs, _ = counted("FEC path (ViterbiDecoder)", ("viterbi",), N_BLOCKS,
                      lambda: run_graph(one_block_graph(vdec), xs, 72e3))
    got = torch.cat(valid(outs, "out")).cpu().numpy()
    want = bits[search * FEC_BLOCK:(search + N_BLOCKS) * FEC_BLOCK]
    err = bit_errors(got, want)
    check(got.shape == want.shape and err < 0.01,
          f"ViterbiDecoder bit errors {err:.4f}")
    cpu = run_graph(one_block_graph(ViterbiDecoder(
        overlap=FEC_OVERLAP, name="vdec", device="cpu")),
        [x.cpu() for x in xs[:2]], 72e3)
    for b in range(2):
        check(same_bits(outs[b]["out"][0], cpu[b]["out"][0]),
              f"ViterbiDecoder block {b}: card and CPU differ")
    print(f"FEC path (ViterbiDecoder, overlap {FEC_OVERLAP}): bit errors "
          f"{err:.2e} over {N_BLOCKS} blocks; blocks 0-1 bit-equal to the "
          "CPU")
    pn_ber_phase(dev)
    time_path("viterbi_decoder", one_block_graph(vdec), xs, 72e3, FEC_BLOCK,
              "Mbit/s", kernels=("viterbi_warp", "trace_map", "trace_bits"))
    return launches


def pn_graph(device):
    """GLFSRSource(7, 0x60, 'pn') -> XOR with a flip stream -> PNBERv."""
    fg = Flowgraph("pn_ber")
    src = GLFSRSource(7, PN_BLOCK, mask=0x60, seed=0x5A, convention="pn",
                      name="pn", device=device)
    flip = FnBlock(lambda a, b: a ^ b, n_in=2, name="flip")
    ber = PNBERv(7, 0x60, 3e-4, name="ber", device=device)
    fg.add(src)
    fg.connect(src, (flip, 0))
    fg.input("flips", (flip, 1))
    fg.chain(flip, ber)
    fg.output("ber", ber)
    return fg


def pn_ber_phase(dev):
    """GLFSR -> 1% flips -> PNBERv over 4 blocks of 2^20 bits: the
    estimate inside tests/test_decode_fec.py's bar (0.01-0.06: each flip
    shows ~3 times), card against CPU within 1e-6; no kernel."""
    gen = torch.Generator(device=dev).manual_seed(43)
    feeds = [dict(flips=(torch.rand(PN_BLOCK, generator=gen, device=dev)
                         < PN_FLIP).to(torch.uint8)) for _ in range(4)]
    reset_launches()
    outs, _, _ = run_inputs(pn_graph(dev), feeds, 1.0)
    check(not any(launch_counts().values()), "PN BER path launched a kernel")
    ests = [float(o["ber"][0][-1]) for o in outs]
    check(all(0.01 < e < 0.06 for e in ests[1:]),
          f"PN BER estimates {ests} outside 0.01-0.06")
    cpu, _, _ = run_inputs(pn_graph("cpu"), to_cpu(feeds[:2]), 1.0)
    err = max(float((outs[b]["ber"][0].cpu() - cpu[b]["ber"][0]).abs().max())
              for b in range(2))
    check(err <= 1e-6, f"PN BER card vs CPU {err:.3e}")
    print(f"PN BER (GLFSR degree 7 'pn' -> {PN_FLIP:.0%} flips -> PNBERv, "
          f"{PN_BLOCK} bits a block): estimates {[round(e, 5) for e in ests]}"
          f"; card vs CPU within {err:.3e} (bar 1e-6)")


def decoder_graphs(device):
    """The decoders path's one-block graphs."""
    return dict(acars=one_block_graph(decode.ACARSDecoder(
                    name="acars", device=device)),
                manchester=one_block_graph(decode.ManchesterDecode(
                    name="manchester", device=device)),
                dpll=one_block_graph(decode.DPLLBitSync(
                    97.0, 0.1, name="dpll", device=device)),
                dpll16=one_block_graph(decode.DPLLBitSync(
                    15.5, name="dpll16", device=device)))


def decoder_scene(dev):
    """8 blocks of DEC_BLOCK samples for each decoder: ACARS packets (3 a
    block, one across the boundary of blocks 3 and 4), Manchester chips
    with a chip dropped in block 2, pulse trains of period 100.3 and
    16.0."""
    rng = np.random.default_rng(47)
    n = N_BLOCKS * DEC_BLOCK
    air, pays, at = [], [], 0
    starts = [b * DEC_BLOCK + 600 + 5200 * k for b in range(N_BLOCKS)
              for k in range(3)]
    starts[3 * 3 + 2] = 4 * DEC_BLOCK - 200      # across blocks 3 and 4
    for s in starts:
        air.append(np.zeros(s - at, np.int64))
        pays.append(acars_payload(rng, b"POS N47.4 W122.3 FL%03d" % len(pays)))
        air.append(acars_air(pays[-1]))
        at = s + len(air[-1])
    bits = np.concatenate(air + [np.zeros(n - at, np.int64)])
    metrics = (np.where(bits == 1, -1.0, 1.0) * rng.uniform(0.5, 1.5, n)
               ).astype(np.float32)
    data = rng.integers(0, 2, n // 2 + 8).astype(np.uint8)
    chips = np.stack([1 - data, data], 1).reshape(-1)
    chips = np.delete(chips, 2 * DEC_BLOCK + 777)[:n]
    pulses = {}
    for key, period in (("dpll", 100.3), ("dpll16", 16.0)):
        p = np.zeros(n, np.uint8)
        p[np.arange(0.0, n, period).astype(np.int64)] = 1
        pulses[key] = p

    def blocks(a):
        return [torch.from_numpy(np.ascontiguousarray(
            a[b * DEC_BLOCK:(b + 1) * DEC_BLOCK])).to(dev)
            for b in range(N_BLOCKS)]
    feeds = dict(acars=blocks(metrics), manchester=blocks(chips),
                 dpll=blocks(pulses["dpll"]), dpll16=blocks(pulses["dpll16"]))
    return feeds, pays, data


def check_decoder_outputs(outs, pays, data):
    """The decoders path's outputs (``outs[graph]``: outputs a block)
    against the scene: every ACARS packet with its bytes and no parity
    error, the Manchester bits after the resync the planted ones, both
    DPLL estimates within 1.0 of their period."""
    # ACARS: every packet, its bytes and no parity error
    acars_outs = outs["acars"]
    rows = [r for o in acars_outs
            for r in o["out"][0][: int(o["out"][1])].cpu().numpy()]
    got = [[int(v) for v in r[2:2 + int(r[0])]] for r in rows]
    check(got == pays and all(r[1] == 0 for r in rows),
          f"ACARS: {len(got)} packets, not the {len(pays)} planted")
    print(f"ACARS: {len(got)} packets over {N_BLOCKS} blocks, bytes and "
          f"parity as planted (one across blocks 3-4); a block "
          f"{[int(o['out'][1]) for o in acars_outs]}; the first:\n  "
          + acars.format_packet(rows[0]).replace("\n", "\n  "))
    # Manchester: the bits after the slip's resync equal the planted ones
    dec = torch.cat(valid(outs["manchester"], "out")).cpu().numpy()
    tail = dec[-8000:]
    offs = [o for o in range(len(data) - 8000)
            if np.array_equal(data[o:o + 8000], tail)]
    check(len(offs) == 1, "Manchester: the last 8000 bits are not the "
          "planted ones after the resync")
    print(f"Manchester: {len(dec)} bits from {N_BLOCKS * DEC_BLOCK} chips; "
          f"the last 8000 equal the planted bits from bit {offs[0]}")
    for key, period in (("dpll", 100.3), ("dpll16", 16.0)):
        per = outs[key][-1]["out1"][0][-1].item()
        ev = outs[key][-1]["out2"]
        check(abs(per - period) < 1.0 and int(ev[1]) > 0,
              f"DPLL {key}: estimate {per} for period {period}")
        print(f"DPLL at period {period}: estimate {per:.4f} after "
              f"{N_BLOCKS} blocks, {int(ev[1])} events in the last")


def decoders_path(dev):
    """The decoders path: each decoder a one-block graph over 8 blocks of
    2^14, counted like phase 3 (one launch a block each); every planted
    ACARS packet found with its bytes and no parity error (one printed
    through utils/acars.py), the Manchester bits after the resync equal
    to the planted ones, both DPLL estimates within 1.0 of their period;
    blocks 0-1 of each against the port on the CPU bit for bit. Timed and
    profiled."""
    feeds, pays, data = decoder_scene(dev)
    graphs = decoder_graphs(dev)
    runs = {}

    def run_all():
        for key, fg in graphs.items():
            runs[key] = run_inputs(fg, [dict(iq=x) for x in feeds[key]],
                                   DEC_RATE[key])
    reset_launches()
    run_all()
    launches = launch_counts()
    want = dict(acars_fsm=N_BLOCKS, manchester_fsm=N_BLOCKS,
                dpll_walk=2 * N_BLOCKS)
    print(f"decoders path launches over {N_BLOCKS} blocks a graph: "
          f"{launches}")
    for name, n in launches.items():
        check(n == want.get(name, 0),
              f"decoders path launched {name} {n} times")
    check_decoder_outputs({k: r[0] for k, r in runs.items()}, pays, data)
    # blocks 0-1 against the CPU
    cpu = decoder_graphs("cpu")
    for key, fg in cpu.items():
        co, _, cs = run_inputs(fg, [dict(iq=x.cpu()) for x in feeds[key][:2]],
                               DEC_RATE[key])
        go, _, gs = runs[key]
        for b in range(2):
            for port, (gd, gc) in go[b].items():
                cd, cc = co[b][port]
                check(int(gc) == int(cc) and same_bits(gd, cd),
                      f"{key} {port} block {b}: card and CPU differ")
            check(same_state(gs[b][key], cs[b][key]),
                  f"{key} block {b}: state, card and CPU differ")
    print("decoders path blocks 0-1, card vs CPU: outputs, counts and "
          "states bit-equal (ACARS, Manchester, both DPLLs)")
    for key, kern in (("acars", "acars_sync_walk"),
                      ("manchester", "manchester_class_walk"),
                      ("dpll", "dpll_kernel")):
        time_path(key, graphs[key], feeds[key], DEC_RATE[key], DEC_BLOCK,
                  "Msamp/s", kernels=(kern,))
    return launches


# sample rates of the decoders' inputs: ACARS's 2400 bit/s air interface,
# a Manchester chip stream, pulse trains
DEC_RATE = dict(acars=2400.0, manchester=1e6, dpll=1e6, dpll16=1e6)


# ---------------------------------------------------------------------------
# the small blocks of ops/basic.py and ops/misc.py
# ---------------------------------------------------------------------------

def small_cases(gen):
    """(label, factory(device) -> block, inputs per block (numpy), relative
    bar or None for bit-equal, control(params, b) or None)."""
    n = BLOCK

    def c64(*shape):
        return (gen.standard_normal(shape) + 1j * gen.standard_normal(shape)
                ).astype(np.complex64)

    def f32(*shape):
        return gen.standard_normal(shape).astype(np.float32)

    def blocks(make, k=2):
        return [make() for _ in range(k)]

    def delay_control(params, b):
        params["align"]["delay"].fill_((100, 3000, 5)[b])

    counter = np.arange(3 * n, dtype=np.float32)
    counter[n + 5000:] += 7.0                       # a jump in block 1
    marks = [(np.zeros(n, np.float32), np.zeros(n, np.float32))
             for _ in range(2)]
    for e, o in marks:
        e[gen.integers(0, n, 40)] = 1.0
        o[gen.integers(0, n, 40)] = 1.0
    bits = gen.integers(0, 2, (2, n)).astype(np.uint8)
    return [
        ("conjugate", lambda d: basic.conjugate(), blocks(lambda: (c64(n),)),
         None, None),
        ("complex_to_mag", lambda d: basic.complex_to_mag(),
         blocks(lambda: (c64(n),)), 1e-6, None),
        ("complex_to_mag_squared", lambda d: basic.complex_to_mag_squared(),
         blocks(lambda: (c64(n),)), None, None),
        ("complex_to_arg", lambda d: basic.complex_to_arg(),
         blocks(lambda: (c64(n),)), 1e-6, None),
        ("real_part", lambda d: basic.real_part(), blocks(lambda: (c64(n),)),
         None, None),
        ("imag_part", lambda d: basic.imag_part(), blocks(lambda: (c64(n),)),
         None, None),
        ("multiply_const", lambda d: basic.multiply_const(1.5),
         blocks(lambda: (f32(n),)), None, None),
        ("add_const", lambda d: basic.add_const(-0.7),
         blocks(lambda: (f32(n),)), None, None),
        ("multiply", lambda d: basic.multiply(),
         blocks(lambda: (f32(n), f32(n))), None, None),
        ("add", lambda d: basic.add(), blocks(lambda: (f32(n), f32(n))),
         None, None),
        ("float_to_complex", lambda d: basic.float_to_complex(),
         blocks(lambda: (f32(n), f32(n))), None, None),
        ("uchar_iq_to_complex (2^21 RTL bytes)",
         lambda d: basic.uchar_iq_to_complex(),
         blocks(lambda: (gen.integers(0, 256, 2 * n).astype(np.uint8),)),
         None, None),
        ("complex_to_ishort", lambda d: basic.complex_to_ishort(),
         blocks(lambda: (0.3 * c64(n),)), None, None),
        ("ishort_to_complex",
         lambda d: basic.ishort_to_complex(),
         blocks(lambda: (gen.integers(-32768, 32768, 2 * n)
                         .astype(np.int16),)), None, None),
        ("PowCC", lambda d: basic.PowCC(2.0, 0.5, device=d),
         blocks(lambda: (c64(n),)), 1e-6, None),
        ("SwapIQ", lambda d: basic.SwapIQ(device=d),
         blocks(lambda: (c64(n),)), None, None),
        ("VariableDelay, 100 -> 3000 -> 5",
         lambda d: basic.VariableDelay(4096, 100, name="align", device=d),
         blocks(lambda: (c64(n),), 3), None, delay_control),
        ("KeepOneInN(1000)",
         lambda d: basic.KeepOneInN(1000, n, device=d),
         blocks(lambda: (c64(n),), 3), None, None),
        ("UnpackedToPacked", lambda d: basic.UnpackedToPacked(device=d),
         [(b,) for b in bits], None, None),
        ("PackedToUnpacked", lambda d: basic.PackedToUnpacked(False,
                                                              device=d),
         [(b,) for b in bits], None, None),
        ("Hysteresis", lambda d: basic.Hysteresis(-0.5, 0.5, device=d),
         blocks(lambda: (np.repeat(gen.uniform(-1.5, 1.5, n // 16), 16)
                         .astype(np.float32),)), None, None),
        ("MatrixInterleaver(4, 8)", lambda d: misc.MatrixInterleaver(4, 8),
         blocks(lambda: (c64(n // 4, 4),)), None, None),
        ("TestCounter", lambda d: misc.TestCounter(name="counter", device=d),
         [(counter[b * n:(b + 1) * n],) for b in range(3)], None, None),
        ("SwapFF", lambda d: misc.SwapFF(device=d), blocks(lambda: (f32(n),)),
         None, None),
        ("FieldTracker", lambda d: misc.FieldTracker(device=d),
         [(f32(n), e, o) for e, o in marks], None, None),
        ("BlockStatus", lambda d: misc.BlockStatus(n + 1000, device=d),
         blocks(lambda: (f32(n),), 3), None, None),
    ]


def small_blocks_phase(dev):
    """Each block of ops/basic.py and ops/misc.py in a one-block graph on
    the card over 2-3 blocks of 2^20 samples, against the same graph on the
    CPU: counts, outputs (bit for bit, or within the JAX tests' 1e-6 of
    the max where libm rounding may differ) and the final state."""
    reset_launches()
    gen = np.random.default_rng(19)
    worst = {}
    for label, make, ins, rel, control in small_cases(gen):
        runs = []
        for d in (dev, "cpu"):
            blk = make(d)
            feeds = [{("iq" if p == 0 else f"in{p}"): torch.from_numpy(a).to(d)
                      for p, a in enumerate(b)} for b in ins]
            runs.append(run_inputs(one_block_graph(blk), feeds, 1.0,
                                   control))
        (go, gf, gs), (co, cf, cs) = runs
        err = 0.0
        for g, c in zip(go, co):
            for port, (gd, gc) in g.items():
                cd, cc = c[port]
                check(int(gc) == int(cc), f"{label} {port} counts")
                if rel is None:
                    check(same_bits(gd, cd), f"{label} {port}: card and CPU "
                          "differ")
                else:
                    e = float((gd.cpu() - cd).abs().max() / cd.abs().max())
                    err = max(err, e)
                    check(e <= rel, f"{label} {port}: {e:.3e} of the max")
        check(gf == cf, f"{label}: flags")
        # one block a graph, auto-named anew in each
        for gst, cst in zip(gs[-1].values(), cs[-1].values()):
            for k, v in (gst or {}).items():
                check(same_bits(v, cst[k]), f"{label} state {k}")
        worst[label] = err
    launches = launch_counts()
    check(not any(launches.values()), f"small blocks launched {launches}")
    print(f"small blocks, card vs CPU ({len(worst)} blocks, 2^20-sample "
          "blocks): bit-equal "
          + ", ".join(k for k, e in worst.items() if e == 0.0)
          + "; within 1e-6 of the max: "
          + ", ".join(f"{k} {e:.2e}" for k, e in worst.items() if e))


# ---------------------------------------------------------------------------
# P25 receive and voice behind the channel block
# ---------------------------------------------------------------------------

P25_FS = 1.536e6                # an RTL dongle's rate
P25_DECIM = 32                  # to P25Config's 48 kHz channel rate
P25_BLOCK = 1 << 19             # 2^14 channel samples, P25Config's block
P25_OFFSET_HZ = 200e3
P25_NOISE = 0.05                # complex noise a component, wideband
P25_NAC = 0x293
P25_KEYS = {0x12: "0123456789abcdef", 0x34: "13579bdf02468ace"}
P25_PATH_KERNELS = ("xlating_fir_block",)
# the scene's LDUs in turn, (DUID, ALGID, KID): the wire LDU carries its
# encryption sync in LDU2 only, so the encrypted ones are LDU2s
P25_LDUS = ((0x5, ALGID_CLEAR, 0), (0xA, ALGID_DES_OFB, 0x12),
            (0xA, ALGID_CLEAR, 0), (0xA, ALGID_DES_OFB, 0x34))
P25_SOFT_REL = 1e-5


def p25_channel_taps():
    """The P25 channel's low-pass: 741 taps, 7.25 kHz cut-off, 5 kHz
    wide."""
    return fir.low_pass_taps(1.0, P25_FS, 7.25e3, 5e3)


def p25_scene(dev, n_blocks=N_BLOCKS, seed=25):
    """``n_blocks`` blocks of P25_BLOCK samples at P25_FS (8 blocks: 2.7 s)
    holding wire LDUs (P25_LDUS in turn, random voice bits, MIs and link
    control) between runs of 100-400 random dibits, C4FM-modulated at
    the wideband rate, moved to +P25_OFFSET_HZ, with complex noise.
    Returns the feeds and the plan, [(dibit index, DUID, ALGID, KID,
    voice [9, 88])]."""
    rng = np.random.default_rng(seed)
    n = n_blocks * P25_BLOCK
    n_dib = int(np.ceil(n * P25_SYMBOL_RATE / P25_FS)) + 1
    parts, plan, pos = [], [], 0
    while True:
        gap = rng.integers(0, 4, int(rng.integers(100, 400))).astype(np.uint8)
        if pos + len(gap) + WIRE_LDU_DIBITS + 100 > n_dib:
            break
        duid, algid, kid = P25_LDUS[len(plan) % len(P25_LDUS)]
        voice = rng.integers(0, 2, (9, 88)).astype(np.uint8)
        ldu = make_wire_ldu(
            P25_NAC, duid, voice, mi=int.from_bytes(rng.bytes(9), "big"),
            algid=algid, kid=kid,
            key=int(P25_KEYS[kid], 16) if algid == ALGID_DES_OFB else None,
            lc72=rng.integers(0, 2, 72).astype(np.uint8))
        parts += [gap, ldu]
        pos += len(gap)
        plan.append((pos, duid, algid, kid, voice))
        pos += len(ldu)
    parts.append(rng.integers(0, 4, n_dib - pos).astype(np.uint8))
    iq = torch.from_numpy(c4fm_modulate(np.concatenate(parts), P25_FS)[:n])
    t = torch.arange(n, dtype=torch.float64, device=dev)
    lo = torch.polar(torch.ones_like(t), 2 * np.pi * torch.frac(
        t * (P25_OFFSET_HZ / P25_FS))).to(torch.complex64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    iq = iq.to(dev) * lo + P25_NOISE * torch.view_as_complex(
        torch.randn(n, 2, generator=gen, device=dev))
    return ([dict(iq=iq[b * P25_BLOCK:(b + 1) * P25_BLOCK])
             for b in range(n_blocks)], plan)


def p25_graph(device):
    """The channel block (B1 at decim 32) in front of ``build_p25_rx`` at
    its defaults; the channel is an output too."""
    fg, h = build_p25_rx(P25Config(), device=device)
    chan = FreqXlatingFIRDecimator(p25_channel_taps(), P25_DECIM,
                                   P25_OFFSET_HZ, P25_FS, name="channel",
                                   device=device)
    fg.connect(chan, h["disc"])
    fg.input("iq", chan)
    fg.output("channel", chan)
    return fg


def p25_events(outs):
    """[(symbol index, NAC, DUID, sync errors)] over every step."""
    rows = []
    for o in outs:
        ev, n = o["frames"]
        ev = ev[:int(n)].cpu().numpy()
        rows += [(int(i), int(a), int(d), int(e)) for i, (a, d, e)
                 in zip(decode_i32(ev[:, 0]), ev[:, 1:].astype(np.int64))]
    return rows


def p25_voice(outs, key_map):
    """P25WireVoiceDecoder over every step's valid dibits and events."""
    dec = P25WireVoiceDecoder(key_map=key_map)
    frames = []
    for o in outs:
        dib, n = o["dibits"]
        ev, n_ev = o["frames"]
        frames += dec.feed(dib[:int(n)], ev, n_ev)
    return frames


def check_p25_outputs(outs, plan):
    """Every planted LDU found once, at its dibit index plus the chain's
    one delay, with its NAC and DUID; the voice bits of every LDU back
    with the right keys; every encrypted codeword garbled with the keys
    swapped. Returns (delay, sync errors, LDUs, encrypted LDUs)."""
    found = p25_events(outs)
    check(len(found) == len(plan), f"P25: {len(found)} frames found, "
          f"{len(plan)} planted")
    delays = {f[0] - p[0] for f, p in zip(found, plan)}
    check(len(delays) == 1 and 0 <= min(delays) <= 8,
          f"P25: frames not at their indices (delays {sorted(delays)})")
    check(all((f[1], f[2]) == (P25_NAC, p[1]) for f, p in zip(found, plan)),
          "P25: a frame's NAC or DUID")
    frames = p25_voice(outs, P25_KEYS)
    check(len(frames) == 9 * len(plan), f"P25: {len(frames)} voice frames")
    for i, (pos, duid, algid, kid, voice) in enumerate(plan):
        for j, f in enumerate(frames[9 * i:9 * i + 9]):
            check(f.index == j and f.duid == duid and f.nac == P25_NAC
                  and f.decrypted == (algid == ALGID_DES_OFB)
                  and np.array_equal(f.bits, voice[j]),
                  f"P25: LDU {i} codeword {j} not recovered")
    swapped = {0x12: P25_KEYS[0x34], 0x34: P25_KEYS[0x12]}
    wrong = p25_voice(outs, swapped)
    for i, (pos, duid, algid, kid, voice) in enumerate(plan):
        same = [np.array_equal(f.bits, voice[j])
                for j, f in enumerate(wrong[9 * i:9 * i + 9])]
        want = [algid != ALGID_DES_OFB] * 9
        check(same == want, f"P25: LDU {i} with the wrong key: {same}")
    n_enc = sum(p[2] == ALGID_DES_OFB for p in plan)
    return min(delays), max(f[3] for f in found), len(plan), n_enc


def p25_path(dev):
    """The P25 receiver behind the channel block over 8 blocks, counted
    like phase 3: every planted LDU found at its index and decoded (right
    keys) or garbled (wrong keys); blocks 0-1 against the port on the CPU
    (the channel and the soft symbols within 1e-5 of their max, dibits
    equal but where a soft symbol lies within 1e-5 of a threshold, frame
    events bit for bit); then timed and profiled."""
    feeds, plan = p25_scene(dev)
    (outs, _, states), launches = counted(
        "P25 path", P25_PATH_KERNELS, N_BLOCKS,
        lambda: run_inputs(p25_graph(dev), feeds, P25_FS))
    delay, errs, n_ldu, n_enc = check_p25_outputs(outs, plan)
    n_sym = sum(int(o["dibits"][1]) for o in outs)
    print(f"P25 path: {n_sym} symbols from {N_BLOCKS * P25_BLOCK} IQ at "
          f"{P25_FS / 1e6} Msamp/s; {n_ldu} LDUs found at their index + "
          f"{delay} (most sync errors {errs}); the voice bits of all "
          f"{n_ldu} back, the {n_enc} encrypted ones (two KIDs) garbled "
          "with the keys swapped")
    cpu, _, cstates = run_inputs(p25_graph("cpu"), to_cpu(feeds[:2]), P25_FS)
    worst = dict(channel=0.0, soft=0.0)
    exempt = 0
    for b in range(2):
        g, c = outs[b], cpu[b]
        for port in ("channel", "soft", "dibits", "frames"):
            check(int(g[port][1]) == int(c[port][1]),
                  f"P25 {port} counts, block {b}")
        for port in ("channel", "soft"):
            gz, cz = g[port][0].cpu(), c[port][0]
            err = float((gz - cz).abs().max() / cz.abs().max())
            worst[port] = max(worst[port], err)
            check(gz.shape == cz.shape and err <= P25_SOFT_REL,
                  f"P25 {port} block {b}: card and CPU differ {err:.3e}")
        soft = c["soft"][0]
        near = ((soft[:, None] - torch.tensor([-1.0, 0.0, 1.0])).abs()
                .amin(dim=1) < P25_SOFT_REL)
        differ = g["dibits"][0].cpu() != c["dibits"][0]
        check(not bool((differ & ~near).any()),
              f"P25 dibits block {b}: card and CPU differ")
        exempt += int(differ.sum())
        check(same_bits(g["frames"][0], c["frames"][0]),
              f"P25 frames block {b}: card and CPU differ")
        for k in ("phase", "buf_count", "mu_int", "mu_frac"):
            check(int(states[b]["fsk4"][k]) == int(cstates[b]["fsk4"][k]),
                  f"P25 FSK4 {k}, card and CPU")
    print(f"P25 path blocks 0-1, card vs CPU: channel within "
          f"{worst['channel']:.3e} of the max, soft symbols within "
          f"{worst['soft']:.3e} (bar {P25_SOFT_REL}); dibits equal "
          f"({exempt} next to a threshold differ); frame events, counts "
          "and the FSK4 phase and positions equal")
    time_path("p25", p25_graph(dev), [f["iq"] for f in feeds], P25_FS,
              P25_BLOCK, "Msamp/s", bits_ports=("frames",),
              kernels=("polyphase_fir",))
    return launches


# ---------------------------------------------------------------------------
# the Audio FMCW radar
# ---------------------------------------------------------------------------

FMCW_BLOCK = 1 << 20            # 1024 sweeps of 1024 samples at 48 kHz
FMCW_ECHOES = ((80, 0.5), (200, 0.3))   # (delay in samples, amplitude)
FMCW_NOISE = 0.01
FMCW_WRAP = 2 ** 32 - 2 ** 19   # the counter's start in the wrap run


def fmcw_scene(dev, cfg, n_blocks=PATH_BLOCKS):
    """``n_blocks`` blocks of the demo's microphone input: the chirp's
    echoes FMCW_ECHOES plus noise."""
    n = n_blocks * cfg.block_size
    x = sum(simulate_echo(cfg, n, d, a) for d, a in FMCW_ECHOES) \
        + np.random.default_rng(26).normal(0, FMCW_NOISE, n)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    return [dict(rx=x[b * cfg.block_size:(b + 1) * cfg.block_size])
            for b in range(n_blocks)]


def fmcw_echo_bins(beat, cfg):
    """The two strongest bins of the beat's sweep spectra (Hann window,
    averaged over the sweeps but the stream's first), as beat bins: the
    echoes of a real input mixed against ``conj(tx)`` lie at negative
    frequencies, bin P - delay_to_bin."""
    P = cfg.sweep_period
    frames = beat.reshape(-1, P)[1:]
    win = torch.hann_window(P, periodic=False, device=beat.device)
    spec = torch.fft.fft(frames * win, dim=-1).abs().mean(dim=0)
    top = torch.topk(spec, 2).indices.cpu().tolist()
    return sorted((P - k) % P for k in top)


def fmcw_range_error(got, want, beat, cfg):
    """The largest difference of two range outputs' magnitudes over each
    sweep's full scale, the most any bin of its windowed FFT can reach
    (sum of w |beat|), and the largest difference in dB. The range keeps
    the positive half, where a real input's echoes are not (see
    :func:`fmcw_echo_bins`): its own max is leakage, and a float32 FFT's
    error scales with the whole sweep, not with that max."""
    P = cfg.sweep_period
    win = torch.from_numpy(np.hanning(P).astype(np.float32))
    scale = (beat.reshape(-1, P).abs() * win).sum(dim=1, keepdim=True)
    mag = [10.0 ** (r.to(torch.float64) / 10.0) for r in (got, want)]
    rel = float(((mag[0] - mag[1]).abs() / scale).max())
    return rel, float((got - want).abs().max())


def fmcw_run(fg, feeds, counter):
    """Steps of the FMCW graph from the deramp's ``counter``: outputs and
    the counter after every step."""
    step = fg.compile().step
    states, params = fg.init_states(), fg.init_params()
    states["deramp"] = torch.full_like(states["deramp"], counter)
    outs, after = [], []
    for feed in feeds:
        states, o = step(states, params, {
            "rx": Stream.full(feed["rx"], sample_rate=48e3)})
        outs.append(o)
        after.append(int(states["deramp"]))
    return outs, after


def check_fmcw_outputs(outs, cfg, counter=0):
    """Every block: the range count, both echoes in their beat bins,
    ``tx`` equal to ``chirp_iq``'s real part at the block's counters, the
    range profiles finite. Returns the bins."""
    want = sorted(int(cfg.delay_to_bin(d)) for d, _ in FMCW_ECHOES)
    for b, o in enumerate(outs):
        check(int(o["range"].count) == cfg.n_sweeps, "FMCW range count")
        got = fmcw_echo_bins(o["beat"].data, cfg)
        check(got == want, f"FMCW block {b}: echoes at beat bins {got}, "
              f"not {want}")
        idx = (counter + b * cfg.block_size + torch.arange(
            cfg.block_size, device=o["tx"].data.device)) & 0xFFFFFFFF
        check(same_bits(o["tx"].data, chirp_iq(idx, cfg).real.contiguous()),
              f"FMCW block {b}: tx is not chirp_iq's real part")
        check(bool(torch.isfinite(o["range"].data).all()), "FMCW range finite")
    return want


def fmcw_path(dev):
    """The FMCW radar at the demo's widths over 2^20-sample blocks: both
    echoes in their beat bins, ``tx`` equal to ``chirp_iq``'s real part;
    block 0 on the CPU (``beat``, ``tx`` within 1e-6, ``range``'s
    magnitudes within 1e-5 of each sweep's full scale); a run across the
    counter's 2^32 wrap whose counters equal the CPU's; then timed and
    profiled."""
    cfg = FMCWConfig(block_size=FMCW_BLOCK)
    feeds = fmcw_scene(dev, cfg)
    (outs, _), launches = counted(
        "FMCW path", (), PATH_BLOCKS,
        lambda: fmcw_run(build_fmcw(cfg, device=dev)[0], feeds, 0))
    want = check_fmcw_outputs(outs, cfg)
    cpu, _ = fmcw_run(build_fmcw(cfg, device="cpu")[0], to_cpu(feeds[:1]), 0)
    err = {}
    for port in ("beat", "tx"):
        g, c = outs[0][port].data.cpu(), cpu[0][port].data
        err[port] = float((g - c).abs().max() / max(float(c.abs().max()),
                                                     1.0))
    err["range"], err["range_db"] = fmcw_range_error(
        outs[0]["range"].data.cpu(), cpu[0]["range"].data,
        cpu[0]["beat"].data, cfg)
    print(f"FMCW block 0, card vs CPU: beat {err['beat']:.3e}, tx "
          f"{err['tx']:.3e} (bar 1e-6); range magnitudes "
          f"{err['range']:.3e} of the sweep's full scale (bar 1e-5), "
          f"{err['range_db']:.3e} dB at most")
    check(err["beat"] <= 1e-6 and err["tx"] <= 1e-6,
          "FMCW beat or tx: card and CPU differ")
    check(err["range"] <= 1e-5, "FMCW range: card and CPU differ")
    runs = [fmcw_run(build_fmcw(cfg, device=d)[0], f, FMCW_WRAP)
            for d, f in ((dev, feeds[:2]), ("cpu", to_cpu(feeds[:2])))]
    (go, gc), (co, cc) = runs
    check(gc == cc == [(FMCW_WRAP + (b + 1) * cfg.block_size) % 2 ** 32
                       for b in range(2)], f"FMCW wrap counters {gc} {cc}")
    check_fmcw_outputs(go, cfg, FMCW_WRAP)
    for b in range(2):
        e = float((go[b]["beat"].data.cpu() - co[b]["beat"].data).abs().max())
        check(e <= 1e-6, f"FMCW wrap block {b}: beat, card and CPU")
    print(f"FMCW path: {PATH_BLOCKS} blocks of {cfg.block_size} samples "
          f"({cfg.n_sweeps} sweeps of {cfg.sweep_period}); echoes at beat "
          f"bins {want} (delay_to_bin of {[d for d, _ in FMCW_ECHOES]}), "
          "tx = chirp_iq's real part; across the 2^32 wrap the "
          "counters equal the CPU's")
    time_path("fmcw", build_fmcw(cfg, device=dev)[0],
              [f["rx"] for f in feeds], cfg.sample_rate, cfg.block_size,
              "Msamp/s")
    return launches


# ---------------------------------------------------------------------------
# the multi-device patterns at one rank (parallel_path)
# ---------------------------------------------------------------------------

PAR_CHANNELS = 8          # the JAX scaling bench's bank (benchmarks.py:553)
PAR_FREQS = np.linspace(-1.2e6, 1.2e6, PAR_CHANNELS)
PAR_CPU_BLOCKS = 2
TP_TAPS = np.sinc(np.linspace(-8, 8, 1025)).astype(np.float32)
TP_DECIM = 4
# B3 against its plain version at the TP FIR's shape, relative to the max:
# two float32 orders of the 1028-tap sum (the plain polyphase product and
# the strided windows) differ by 7.7e-7 of the max over 2^18 outputs
TP_REL = 2e-6
MUSIC_ANGLES = (60.0, 110.0)  # two sources on the 0.5-degree grid


@contextlib.contextmanager
def one_rank_world(dev):
    """A one-rank NCCL process group on the card (a file rendezvous in a
    temporary directory), destroyed on exit so that later phases are
    untouched."""
    torch.cuda.set_device(torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", init_method=f"file://{d}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120),
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            check(dist.get_backend() == "nccl", "the process group is NCCL")
            yield
        finally:
            dist.destroy_process_group()


def card_mesh(names):
    """A one-rank "cuda" mesh over the NCCL group, with dims ``names``."""
    return init_device_mesh("cuda", (1,) * len(names),
                            mesh_dim_names=tuple(names))


def cpu_mesh(names):
    """A one-rank "cpu" mesh over a gloo group of its own, for the CPU
    check (the NCCL group carries no CPU tensors)."""
    g = dist.new_group(backend="gloo")
    return DeviceMesh.from_group(
        [g] * len(names) if len(names) > 1 else g, "cpu",
        torch.zeros((1,) * len(names), dtype=torch.int64),
        mesh_dim_names=tuple(names))


def step_timer(step):
    """``run(steps)``: CUDA-event ms per call of ``step(i)`` (which returns
    a float32 checksum tensor that must stay finite)."""
    acc = {"sum": torch.zeros((), device="cuda"), "i": 0}

    def run(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            acc["sum"] = acc["sum"] + step(acc["i"])
            acc["i"] += 1
        end.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc["sum"])), "path checksum")
        return start.elapsed_time(end) / steps

    run(3)  # warm-up
    return run


def par_stations(dev, cfg, n_blocks):
    """One FM station a channel row at PAR_FREQS, each carrying TONE_HZ
    at DEVIATION_HZ, noise 40 dB down; complex64 [C, n_blocks * N]."""
    n = n_blocks * cfg.block_size
    t = torch.arange(n, dtype=torch.float64, device=dev)
    tone = (DEVIATION_HZ / TONE_HZ) * torch.sin(
        2 * np.pi * torch.frac(t * (TONE_HZ / cfg.sample_rate)))
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for f in PAR_FREQS:
        ph = 2 * np.pi * torch.frac(t * (f / cfg.sample_rate)) + tone
        noise = torch.randn(n, 2, generator=gen, device=dev) * 0.01
        rows.append(torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
                    + torch.view_as_complex(noise))
    return torch.stack(rows)


def bank_run(bank, x, n_blocks):
    """Steps of ``bank`` over the first ``n_blocks`` blocks of the global
    ``x``: per block the compacted audio of every channel and the
    rank's state."""
    state = bank.shard_state(bank.init_state())
    params = bank.init_params(PAR_FREQS)
    n = bank.cfg.block_size
    out = []
    for b in range(n_blocks):
        state, (a, c) = bank.step(state, params,
                                  bank.shard_input(x[:, b * n:(b + 1) * n]))
        out.append((bank.compact_audio(a, c), c, state))
    return out


def bank_serial(cfg, x, n_blocks, dev):
    """The serial chain a channel on the card (FreqXlatingFIRDecimator on
    B1 -> QuadratureDemod -> FractionalResampler), as the JAX package's
    bank test holds its bank."""
    taps = fir.low_pass_taps(1.0, cfg.sample_rate,
                             cfg.channel_width / 2 + cfg.transition / 2,
                             cfg.transition)
    audio = []
    for ch, f in enumerate(PAR_FREQS):
        fg = Flowgraph("serial")
        chan = FreqXlatingFIRDecimator(taps, cfg.decim, f, cfg.sample_rate,
                                       name="chan", device=dev)
        dem = QuadratureDemod(cfg.quad_rate / (2 * np.pi * cfg.max_deviation),
                              name="demod", device=dev)
        rs = FractionalResampler(cfg.block_size // cfg.decim, cfg.ratio,
                                 dtype=torch.float32, name="rs", device=dev)
        fg.input("iq", chan)
        fg.chain(chan, dem, rs)
        fg.output("audio", rs)
        n = cfg.block_size
        outs = run_graph(fg, [x[ch, b * n:(b + 1) * n]
                              for b in range(n_blocks)], cfg.sample_rate)
        audio.append(torch.cat(valid(outs, "audio")).cpu().numpy())
    return audio


def parallel_bank(dev):
    cfg = BankConfig(channels=PAR_CHANNELS, block_size=BLOCK)
    x = par_stations(dev, cfg, N_BLOCKS)
    bank = ShardedWBFMBank(cfg, card_mesh(("chan", "time")))
    out, launches = counted(
        "parallel bank", ("fir_decimate_frame",), N_BLOCKS,
        lambda: bank_run(bank, x, N_BLOCKS), per_block=PAR_CHANNELS)
    audio = [np.concatenate([o[0][ch] for o in out])
             for ch in range(PAR_CHANNELS)]
    serial = bank_serial(cfg, x, N_BLOCKS, dev)
    worst_snr, worst_df = np.inf, 0.0
    for ch in range(PAR_CHANNELS):
        check(len(audio[ch]) == len(serial[ch]) and len(audio[ch]) > 0,
              f"bank channel {ch} audio count")
        check(bool(np.isfinite(audio[ch]).all()), f"bank channel {ch} finite")
        s = snr_db(serial[ch], audio[ch])
        f, sinad = tone_sinad(audio[ch][len(audio[ch]) // N_BLOCKS:],
                              cfg.audio_rate)
        worst_snr, worst_df = min(worst_snr, s), max(worst_df,
                                                       abs(f - TONE_HZ))
        check(s > 80.0, f"bank channel {ch}: {s:.1f} dB against the serial "
              "chain")
        check(abs(f - TONE_HZ) < 5.0, f"bank channel {ch} tone at {f:.2f} Hz")
    print(f"parallel bank: {PAR_CHANNELS} channels x {N_BLOCKS} blocks of "
          f"{BLOCK} at {cfg.sample_rate / 1e6} Msamp/s over (chan, time) = "
          f"(1, 1) on NCCL; audio against the serial chain (B1) at least "
          f"{worst_snr:.1f} dB (bar 80), tones within {worst_df:.3f} Hz")
    # blocks 0-1 on the CPU, over a gloo mesh of their own
    cpu_bank = ShardedWBFMBank(cfg, cpu_mesh(("chan", "time")))
    cpu = bank_run(cpu_bank, x[:, :PAR_CPU_BLOCKS * BLOCK].cpu(),
                   PAR_CPU_BLOCKS)
    err = 0.0
    for b in range(PAR_CPU_BLOCKS):
        (ga, gc, gs), (ca, cc, cs) = out[b], cpu[b]
        check(torch.equal(gc.cpu(), cc), f"bank block {b} counts card/CPU")
        for k in ("lo_phase", "rs_mu_int", "rs_mu_frac"):
            check(torch.equal(gs[k].cpu(), cs[k]), f"bank block {b} {k} "
                  "card/CPU")
        for ch in range(PAR_CHANNELS):
            scale = float(np.abs(ca[ch]).max())
            e = float(np.abs(ga[ch] - ca[ch]).max()) / scale
            err = max(err, e)
            check(e <= 1e-5, f"bank block {b} channel {ch} card/CPU {e:.3e}")
    print(f"parallel bank blocks 0-1, card vs CPU (gloo mesh): audio within "
          f"{err:.3e} of the max (bar 1e-5); counts, lo_phase, rs_mu_int, "
          "rs_mu_frac equal")
    state = bank.shard_state(bank.init_state())
    params = bank.init_params(PAR_FREQS)
    blocks = [x[:, b * BLOCK:(b + 1) * BLOCK] for b in range(N_BLOCKS)]

    def step(i):
        nonlocal state
        state, (a, _) = bank.step(state, params, blocks[i % N_BLOCKS])
        return a.sum()

    time_run("parallel_bank", step_timer(step), PAR_CHANNELS * BLOCK,
             "Mchansamp/s")
    return launches


def parallel_tp(dev):
    x = torch.randn(N_BLOCKS * BLOCK, generator=torch.Generator(
        device=dev).manual_seed(15), device=dev)
    blocks = [x[b * BLOCK:(b + 1) * BLOCK] for b in range(N_BLOCKS)]
    blk = TPFIRDecimator(TP_TAPS, TP_DECIM, card_mesh(("tp",)),
                         dtype=torch.float32, name="tp")
    check(np.array_equal(blk.h_chunks[0], fir.prepare_taps(TP_TAPS, TP_DECIM)),
          "shard_taps at one shard equals prepare_taps")
    fg = one_block_graph(blk)
    outs, launches = counted("parallel TP FIR", ("fir_decimate_frame",),
                             N_BLOCKS, lambda: run_graph(fg, blocks, 1.0))
    got = torch.cat(valid(outs, "out"))
    ref = torch.cat(valid(run_graph(one_block_graph(FIRDecimator(
        TP_TAPS, TP_DECIM, dtype=torch.float32, name="fir", device=dev)),
        blocks, 1.0), "out"))
    # FIRDecimator launches the same kernel: hold both against B3's plain
    # version over the frames the block carries too
    h = torch.from_numpy(fir.prepare_taps(TP_TAPS, TP_DECIM)).to(dev)
    tail = torch.zeros(h.shape[0] - 1, device=dev)
    plain = []
    for xb in blocks:
        frame = torch.cat([tail, xb])
        plain.append(fd.fir_decimate_frame_plain(frame, h, TP_DECIM))
        tail = frame[-tail.shape[0]:]
    plain = torch.cat(plain)
    check(got.shape == ref.shape == plain.shape, "TP FIR output length")
    err = float((got - ref).abs().max() / ref.abs().max())
    err_plain = float((got - plain).abs().max() / plain.abs().max())
    print(f"parallel TP FIR: {len(TP_TAPS)} taps at decim {TP_DECIM}, tp = 1 "
          f"on NCCL, {N_BLOCKS} blocks of {BLOCK}: against FIRDecimator "
          f"within {err:.3e} of the max, against B3's plain version over "
          f"the carried frames within {err_plain:.3e} (bars 1e-6, "
          f"{TP_REL:.0e})")
    check(err <= 1e-6, "TP FIR and FIRDecimator differ")
    check(err_plain <= TP_REL, "TP FIR and B3's plain version differ")
    time_path("parallel_tp", fg, blocks, 1.0, BLOCK, "Msamp/s")
    return launches


def parallel_music(dev):
    m, navg = 8, 512
    x = torch.from_numpy(simulate_snapshots(m, MUSIC_ANGLES, navg,
                                            snr_db=20.0, seed=3)).to(dev)
    steer = torch.from_numpy(doa.ula_steering_vectors(m, 360)).to(dev)
    mesh = card_mesh(("dev",))
    got, launches = counted("parallel MUSIC", (), 1,
                            lambda: sharded_music_spectrum(x, steer, 2, mesh))
    ref, _ = doa.music_spectrum(x, steer, 2)
    db = float((10 * torch.log10(got / ref)).abs().max())
    idx, _ = doa.top_n_peaks(got, 2)
    peaks = sorted(float(i) * 0.5 for i in idx.cpu())
    off = max(abs(p - a) for p, a in zip(peaks, MUSIC_ANGLES))
    print(f"parallel MUSIC: {m} antennas, {navg} snapshots, 360 angles, dev "
          f"= 1 on NCCL: within {db:.4f} dB of music_spectrum (bar 0.2), "
          f"peaks {peaks} (planted {list(MUSIC_ANGLES)})")
    check(db < 0.2, "sharded MUSIC and music_spectrum differ")
    check(off <= 1.0, "sharded MUSIC peaks more than 1 degree off")
    time_run("parallel_music", step_timer(lambda i: sharded_music_spectrum(
        x, steer, 2, mesh).sum()), 1, "scans/s", scale=1.0)
    return launches


def parallel_pipeline(dev):
    cfg = WBFMConfig(block_size=BLOCK, center_freq=STATION_HZ)
    fns, inits, buf_shape = _wbfm_stages(cfg, dev)

    def chain(states, buf):
        new = []
        for fn, st in zip(fns, states):
            st, buf = fn(st, buf)
            new.append(st)
        return tuple(new), buf

    pipe = StagePipeline([chain], [tuple(inits)], buf_shape,
                         card_mesh(("stage",)))
    iq = synth_fm(N_BLOCKS * BLOCK, dev, seed=3)
    mb = torch.stack([torch.stack([iq[b * BLOCK:(b + 1) * BLOCK].real,
                                   iq[b * BLOCK:(b + 1) * BLOCK].imag])
                      for b in range(N_BLOCKS)])
    (states, out), launches = counted(
        "parallel pipeline", ("fir_decimate_frame",), N_BLOCKS,
        lambda: pipe.run(pipe.init_states(), mb))
    check(pipe.ticks == N_BLOCKS, f"pipeline ticks {pipe.ticks}")
    n = out[:, 1, BLOCK - 1].to(torch.int64).tolist()
    got = np.concatenate([out[b, 0, :n[b]].cpu().numpy()
                          for b in range(N_BLOCKS)])
    ref = np.concatenate([a.cpu().numpy() for a in valid(run_chain(
        cfg, dev, iq, N_BLOCKS), "audio")])
    check(len(got) == len(ref), "pipeline audio count")
    s = snr_db(ref, got)
    f, sinad = tone_sinad(got[len(got) // N_BLOCKS:], cfg.audio_rate)
    print(f"parallel pipeline: the four WBFM stages in one stage over a "
          f"one-rank NCCL stage mesh, {N_BLOCKS} microbatches of {BLOCK}: "
          f"{s:.1f} dB against build_wbfm (bar 100); tone {f:.2f} Hz, "
          f"SINAD {sinad:.2f} dB")
    check(s > 100.0, "pipeline and build_wbfm differ")
    check(abs(f - TONE_HZ) < 5.0 and sinad > 40.0, "pipeline tone")
    carry = {"states": pipe.init_states()}

    def step(i):
        # the states run on from call to call, as a stream's would
        carry["states"], out = pipe.run(carry["states"], mb)
        return out[:, 0].sum()

    time_run("parallel_pipeline", step_timer(step), N_BLOCKS * BLOCK,
             "Msamp/s", steps=3)
    return launches


def parallel_path(dev):
    """The JAX package's four multi-device patterns at world size 1 over
    NCCL, through the port's kernels: the (chan, time) WBFM bank, the
    tap-sharded FIR, sharded MUSIC and the stage pipeline. Returns the
    kernels' launches."""
    with one_rank_world(dev):
        parts = [part(dev) for part in (
            parallel_bank, parallel_tp, parallel_music, parallel_pipeline)]
    return {name: sum(p[name] for p in parts) for name in parts[0]}


# ---------------------------------------------------------------------------
# the main path fed from the wire (ingest_path) and the apps (apps_phase)
# ---------------------------------------------------------------------------

INGEST_SECONDS = 2.0      # of signal at the RTL rate FS, paced
INGEST_INFLIGHT = 3
# the unpaced sweep: send rates (samples/s; None: as fast as the socket
# takes them), INGEST_SWEEP_BLOCKS blocks each
INGEST_SWEEP = (6.4e6, 12.8e6, 25.6e6, 51.2e6, None)
INGEST_SWEEP_BLOCKS = 4
INGEST_BURST = 16         # packets a send call
APP_SECONDS = 1.0         # of input for rtl_fm's three sources
INGEST_WAIT_S = 30.0      # deadline of a run after its last packet left


class WireSource:
    """A StreamPump source over a BorIP receiver. It accumulates every
    read (a read hands out the whole packets that have arrived, and a
    block straddles many) until it holds a whole block; once the
    stream's end has been flagged and the ring is drained, it hands the
    rest on as a partial block with its count. A short read is never
    discarded."""

    def __init__(self, rx, block: int, port: str = "iq"):
        self.rx, self.block, self.port = rx, int(block), port
        self.parts, self.have = [], 0
        self.ended = self.drained = False
        self.full_blocks = self.partial = 0

    def __call__(self):
        x, flags = self.rx.read_complex(self.block)
        if len(x):
            self.parts.append(x)
            self.have += len(x)
        # the flags are sticky over packets not yet read, so the end is
        # known to be drained only by a read that comes back empty
        self.drained = self.ended and len(x) == 0
        self.ended |= bool(flags & stream_flags.STREAM_END)
        if self.have >= self.block:
            data = np.concatenate(self.parts)
            rest = data[self.block:]
            self.parts, self.have = ([rest] if len(rest) else []), len(rest)
            self.full_blocks += 1
            return {self.port: data[:self.block]}
        if self.drained and self.have:
            pad = np.zeros(self.block, np.complex64)
            pad[:self.have] = np.concatenate(self.parts)
            count, self.parts, self.have = self.have, [], 0
            self.partial += 1
            return {self.port: pad}, {self.port: count}
        return None

    @property
    def done(self) -> bool:
        return self.drained and not self.have


def send_wire(tx, wire: bytes, rate, block: int, bursts=(INGEST_BURST,),
              rx=None, ahead=None):
    """Send ``wire`` (BorIP ishort bytes) in packets of DEFAULT_PAYLOAD,
    ``bursts`` packets a call (cycled), paced at ``rate`` samples/s (None:
    as fast as the socket takes them), then the end-of-stream packet.
    With ``ahead``, never more than that many packets ahead of what the
    receiver ``rx`` has taken off the socket. Returns the start time and,
    for each block of ``block`` samples, the time its last packet left
    (``time.perf_counter``)."""
    pkt = udp.DEFAULT_PAYLOAD
    block_bytes = 4 * block
    t0 = time.perf_counter()
    sent_at, next_end, off, i = [], block_bytes, 0, 0
    while off < len(wire):
        if rate:
            due = t0 + off / 4 / rate
            while True:
                wait = due - time.perf_counter()
                if wait <= 0:
                    break
                time.sleep(wait if wait > 2e-4 else 0)
        end = min(off + bursts[i % len(bursts)] * pkt, len(wire))
        check(tx.send_bytes(wire[off:end]) == end - off, "UDP send")
        now = time.perf_counter()
        while next_end <= end:
            sent_at.append(now)
            next_end += block_bytes
        off, i = end, i + 1
        if ahead is not None:
            sent = -(-off // pkt)
            limit = time.perf_counter() + INGEST_WAIT_S
            while rx.stats()["packets"] < sent - ahead:
                check(time.perf_counter() < limit, "the receiver stalled")
                time.sleep(0.0002)
    if len(wire) % block_bytes:
        sent_at.append(time.perf_counter())
    tx.end_stream()
    return t0, sent_at


def run_counted(fg, blocks, counts, rate):
    """:func:`run_graph` with each block's valid count (a partial last
    block): the outputs."""
    step = fg.compile().step
    states, params = fg.init_states(), fg.init_params()
    outs = []
    for x, c in zip(blocks, counts):
        s = Stream.full(x, sample_rate=rate)
        if c != x.shape[0]:
            s = Stream(x, torch.full((), c, dtype=torch.int32,
                                     device=x.device), s.meta)
        states, o = step(states, params, {"iq": s})
        outs.append({k: (v.data, v.count) for k, v in o.items()})
    return outs


def wire_blocks(wire: bytes, block: int, device):
    """The samples on the wire as the chain's blocks (the last padded
    with zeros) and their counts."""
    x = udp.ishort_bytes_to_complex(wire)
    blocks, counts = [], []
    for b in range(0, len(x), block):
        part = x[b:b + block]
        counts.append(len(part))
        pad = np.zeros(block, np.complex64)
        pad[:len(part)] = part
        blocks.append(torch.from_numpy(pad).to(device))
    return blocks, counts


def ingest_executor(cfg, device):
    """``build_wbfm(cfg)`` in a StreamExecutor, stepped once on zeros and
    reset (the warm-up's launches come before any count is read)."""
    fg, _ = build_wbfm(cfg, device=device)
    ex = StreamExecutor(fg, {"iq": InputSpec((cfg.block_size,), "complex64",
                                             cfg.sample_rate)},
                        device=device)
    ex.step({"iq": np.zeros(cfg.block_size, np.complex64)})
    return ex.reset()


def ingest_run(ex, wire: bytes, rate, profile=False, drop=True, **send):
    """One run of the ingest path on 127.0.0.1: ``wire`` sent at ``rate``
    over BorIP UDP to a UDPSampleReceiver (the native engine), whose
    WireSource feeds a StreamPump(drop=``drop``, inflight=3) into the
    executor ``ex`` (from :func:`ingest_executor`). Returns the audio
    blocks, the receiver's, source's and pump's counts, the wall time from
    the first packet sent to the last audio delivered, each block's
    latency (its last packet sent to its audio delivered) and, with
    ``profile``, the kernels' device time over the run (torch.profiler).
    ``send`` goes to :func:`send_wire` (``bursts``, ``ahead``)."""
    block = ex.inputs["iq"].shape[0]
    n_blocks = -(-len(wire) // (4 * block))
    ex.reset()
    rx = udp.UDPSampleReceiver(port=0, bor=True)
    tx = udp.UDPSampleSender("127.0.0.1", rx.port, bor=True)
    audio, delivered = [], []

    def sink(d, c):
        audio.append(np.array(d[:c]))
        delivered.append(time.perf_counter())

    src = WireSource(rx, block)
    pump = StreamPump(ex, src, {"audio": sink}, drop=drop,
                      inflight=INGEST_INFLIGHT)
    prof = None
    try:
        check(rx._lib is not None, "the native BorIP engine is not in use")
        pump.start()
        with contextlib.ExitStack() as stack:
            if profile:
                prof = stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]))
            t0, sent_at = send_wire(tx, wire, rate, block, rx=rx, **send)
            deadline = time.perf_counter() + INGEST_WAIT_S
            last, quiet = None, time.perf_counter()
            while time.perf_counter() < deadline:
                st = pump.stats()
                if len(delivered) >= n_blocks or (
                        src.done and st["queued"] == 0
                        and st["blocks_out"] + st["overruns"]
                        >= st["blocks_in"]):
                    break
                # a lost end-of-stream packet: stop once nothing moves
                now = (rx.stats()["packets"], st["blocks_in"],
                       st["blocks_out"])
                if now != last:
                    last, quiet = now, time.perf_counter()
                elif time.perf_counter() - quiet > 2.0:
                    break
                time.sleep(0.0005)
            if ex.device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        pump.stop()
        rx_stats = rx.stats()
        tx.close()
        rx.close()
    busy_ms = None
    if prof is not None:
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation) / 1e3
    wall = (delivered[-1] if delivered else time.perf_counter()) - t0
    return dict(audio=audio, rx=rx_stats, pump=pump.stats(),
                full_blocks=src.full_blocks, partial=src.partial,
                n_blocks=n_blocks, wall_s=wall,
                send_s=sent_at[-1] - t0 if sent_at else 0.0,
                latency_s=[d - s for d, s in zip(delivered, sent_at)],
                busy_ms=busy_ms, samples=len(wire) // 4)


def check_ingest(run, ref_audio, what):
    """A run that must lose nothing: no drop in the receiver or the pump,
    every block out (the partial last one too), the audio bit-equal to
    ``ref_audio`` (the Flowgraph over the same samples)."""
    rx, st = run["rx"], run["pump"]
    print(f"{what}: receiver {rx}, pump {st}, source {run['full_blocks']} "
          f"full + {run['partial']} partial blocks of {run['n_blocks']}")
    check(rx["dropped"] == 0 and rx["overruns"] == 0,
          f"{what}: the receiver dropped packets")
    check(st["overruns"] == 0, f"{what}: the pump dropped blocks")
    check(st["blocks_out"] == run["n_blocks"] == len(run["audio"]),
          f"{what}: {st['blocks_out']} of {run['n_blocks']} blocks came out")
    check(len(ref_audio) == len(run["audio"]) and all(
        np.array_equal(a, r) for a, r in zip(run["audio"], ref_audio)),
        f"{what}: the audio differs from the Flowgraph run")


def ingest_path(dev):
    """The main path fed from the wire: an FM station (``synth_fm``)
    quantized to BorIP ishort and sent at the RTL rate over loopback UDP
    for INGEST_SECONDS, through the native receiver and the pump into the
    cascade chain on the card (B1, B3). Checks no drop and no overrun,
    every block out, audio bit-equal to the Flowgraph run over the same
    samples, the tone; prints the ingest rate, the latency and the card's
    idle share, then the unpaced sweep. Returns the kernels' launches of
    the checked run."""
    cfg = WBFMConfig(block_size=BLOCK, audio_chain="cascade",
                     center_freq=STATION_HZ)
    n = int(INGEST_SECONDS * FS)
    wire = udp.complex_to_ishort_bytes(synth_fm(n, dev, seed=5).cpu().numpy())
    blocks, counts = wire_blocks(wire, BLOCK, dev)
    ref = [d[:int(c)].cpu().numpy() for d, c in (
        o["audio"] for o in run_counted(build_wbfm(cfg, device=dev)[0],
                                        blocks, counts, FS))]
    del blocks
    ex = ingest_executor(cfg, dev)
    run, launches = counted("ingest path", MAIN_PATH_KERNELS, len(counts),
                            lambda: ingest_run(ex, wire, FS))
    check_ingest(run, ref, "ingest path")
    audio = np.concatenate(run["audio"][1:])
    f, sinad = tone_sinad(audio, cfg.audio_rate)
    print(f"ingest path tone: {f:.2f} Hz, SINAD {sinad:.2f} dB over "
          f"{len(audio)} audio samples")
    check(abs(f - TONE_HZ) < 5.0, "ingest tone frequency")
    check(sinad > 40.0, "ingest tone SINAD")
    lat = np.array(run["latency_s"]) * 1e3
    print(f"ingest path paced at {FS / 1e6:.2f} Msamp/s: {run['samples']} "
          f"samples in {run['wall_s']:.4f} s from the first packet sent to "
          f"the last audio delivered = {run['samples'] / run['wall_s'] / 1e6:.4f}"
          f" Msamp/s wall-clock; latency (a block's last packet sent to its "
          f"audio delivered) median {np.median(lat):.3f} ms, max "
          f"{lat.max():.3f} ms over {len(lat)} blocks ({card()})")
    prof = ingest_run(ex, wire, FS, profile=True)
    check_ingest(prof, ref, "ingest path (profiled)")
    busy = prof["busy_ms"] / (prof["wall_s"] * 1e3)
    print(f"ingest path profiled run: kernels {prof['busy_ms']:.4f} ms of "
          f"{prof['wall_s'] * 1e3:.3f} ms wall; card busy "
          f"{100 * busy:.3f}%, idle {100 * (1 - busy):.3f}% ({card()})")
    sweep = wire[:4 * INGEST_SWEEP_BLOCKS * BLOCK]
    runs = []
    for rate in INGEST_SWEEP:
        r = ingest_run(ex, sweep, rate)
        r["sent_rate"] = r["samples"] / r["send_s"]
        r["lost"] = (r["rx"]["dropped"] + r["rx"]["overruns"]
                     + r["pump"]["overruns"])
        runs.append(r)
        label = "unpaced" if rate is None else f"paced {rate / 1e6:.1f} Msamp/s"
        print(f"ingest sweep {label}: sent at {r['sent_rate'] / 1e6:.2f} "
              f"Msamp/s, {r['samples'] / r['wall_s'] / 1e6:.2f} Msamp/s "
              f"wall-clock to the last audio, {len(r['audio'])} of "
              f"{r['n_blocks']} blocks out, receiver dropped "
              f"{r['rx']['dropped']} packets and overran {r['rx']['overruns']}"
              f", pump overruns {r['pump']['overruns']} ({card()})")
    clean = [r["sent_rate"] for r in runs if r["lost"] == 0]
    fastest = max(runs, key=lambda r: r["sent_rate"])
    print(f"ingest sweep: highest send rate that arrived with no drop "
          + (f"{max(clean) / 1e6:.2f} Msamp/s" if clean else "none")
          + f"; at the fastest send ({fastest['sent_rate'] / 1e6:.2f} "
          f"Msamp/s) {fastest['rx']['dropped']} packets dropped, "
          f"{fastest['rx']['overruns']} ring overruns, "
          f"{fastest['pump']['overruns']} pump overruns ({card()})")
    return launches


# -- the apps ---------------------------------------------------------------

APP_LSB = 3          # WAV samples: 1e-4 of full scale
APP_DB_LSB = 0.01    # the apps' CSVs print dB as %.2f


def read_wav(path):
    """(rate, int16 samples) of a WAV written by ``rtl_fm.write_wav``."""
    data = open(path, "rb").read()
    check(data[:4] == b"RIFF" and data[8:12] == b"WAVE", f"{path}: a WAV")
    return struct.unpack("<I", data[24:28])[0], \
        np.frombuffer(data[44:], np.int16)


def read_png(path):
    """The [h, w, 3] raster of a PNG written by ``viz.export.write_image``
    (one zlib stream of filter-0 rows)."""
    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: a PNG")
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    return rows.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def same_wav(a, b, upto=None):
    """Two WAVs of one rate and length, within APP_LSB (over the first
    ``upto`` samples, where given); the samples of ``a``."""
    ra, pa = read_wav(a)
    rb, pb = read_wav(b)
    check(ra == rb and len(pa) == len(pb) > 0, f"{a}: rate and length")
    err = int(np.abs(pa[:upto].astype(np.int32) - pb[:upto]).max())
    check(err <= APP_LSB, f"{a}: {err} LSB from {b}")
    return pa


def same_db_csv(a, b):
    """dB spectra CSVs (a frame a row): each value within one printed LSB
    or, in linear power, within 1e-4 of its frame's peak (a stopband bin
    far down differs by more than an LSB in dB between two float32
    orders of its sum, by nothing at the frame's scale); the values of
    ``a``."""
    va = np.loadtxt(a, delimiter=",", ndmin=2)
    vb = np.loadtxt(b, delimiter=",", ndmin=2)
    check(va.shape == vb.shape and va.size > 0, f"{a}: shape")
    pa, pb = 10.0 ** (va / 10.0), 10.0 ** (vb / 10.0)
    near = np.abs(pa - pb) <= 1e-4 * pb.max(axis=1, keepdims=True)
    check(bool((near | (np.abs(va - vb) <= APP_DB_LSB + 1e-9)).all()),
          f"{a}: values differ from {b}")
    return va


def same_png(a, b):
    """Two rasters of the thermal gradient within one level of it."""
    level = {tuple(c): i for i, c in enumerate(thermal_gradient())}
    ia, ib = read_png(a), read_png(b)
    check(ia.shape == ib.shape, f"{a}: raster shape")
    la = np.array([level[tuple(p)] for p in ia.reshape(-1, 3)])
    lb = np.array([level[tuple(p)] for p in ib.reshape(-1, 3)])
    check(int(np.abs(la - lb).max()) <= 1, f"{a}: levels differ from {b}")


def fill(argv, files):
    """``argv`` with each ``{name}`` replaced by its output path."""
    out = []
    for a in argv:
        for n, p in files.items():
            a = a.replace("{" + n + "}", p)
        out.append(a)
    return out


@contextlib.contextmanager
def step_events():
    """A pair of CUDA events around every StreamExecutor.dispatch made
    inside: each step's span on the card."""
    spans, orig = [], StreamExecutor.dispatch

    def dispatch(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = orig(self, *args, **kw)
        end.record()
        spans.append((start, end))
        return outs

    StreamExecutor.dispatch = dispatch
    try:
        yield spans
    finally:
        StreamExecutor.dispatch = orig


def app_pair(name, main, argv, tmp, outs=(), kernels=(), n_blocks=0):
    """``main(argv)`` with ``--device cuda`` (its launches counted: each of
    ``kernels`` once a block of ``n_blocks``) and then ``--device cpu``,
    each writing its ``outs`` under ``tmp``; prints the card run's wall
    time and step time. Returns each run's stdout (paths masked) and
    output paths."""
    res = {}
    for devname in ("cuda", "cpu"):
        files = {o: os.path.join(tmp, f"{devname}_{o}") for o in outs}
        args = fill(argv, files) + ["--device", devname]
        buf = io.StringIO()

        def run():
            with contextlib.redirect_stdout(buf):
                check(main(args) == 0, f"app {name} --device {devname}")

        t0 = time.perf_counter()
        if devname == "cuda":
            with step_events() as spans:
                counted(f"app {name}", kernels, n_blocks, run)
            torch.cuda.synchronize()
            steps = [s.elapsed_time(e) for s, e in spans]
        else:
            run()
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        for n, p in files.items():
            out = out.replace(p, n)
        res[devname] = (out, files, wall)
        if devname == "cuda":
            step = (f"{len(steps)} steps, step median "
                    f"{statistics.median(steps):.4f} ms, max "
                    f"{max(steps):.4f} ms (events)") if steps else \
                "no graph stepped"
            print(f"app {name}: card {wall:.4f} s wall, {step} ({card()})")
        else:
            print(f"app {name}: cpu {wall:.4f} s wall")
    return res["cuda"], res["cpu"]


class RecordingRemote(borip_client.RemoteDevice):
    """The port's RemoteDevice, keeping each instance and its receiver's
    stats at close (the apps phase reads its drops)."""

    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        RecordingRemote.made.append(self)

    def close(self):
        if getattr(self, "final_stats", None) is None:
            self.final_stats = self.rx.stats()
        super().close()


def wav_tone(path, skip=8):
    """(tone Hz, SINAD dB) of a WAV's audio after its first 1/``skip``."""
    rate, pcm = read_wav(path)
    audio = pcm[len(pcm) // skip:].astype(np.float64) / 32767.0
    return tone_sinad(audio, rate)


def apps_phase(dev):
    """Each ported app through its ``main(argv)`` on the card and again
    with ``--device cpu`` on the same argv, outputs in a temporary
    directory: rtl_fm (--synth, --borip against the port's BorIPServer
    serving a FileDevice paced at the RTL rate, --input), am_fft,
    realtime_fft, fac, scanner and papr at their defaults. Returns the
    kernels' launches."""
    launches = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    rtl_blocks = -(-int(APP_SECONDS * FS) // (1 << 17))
    with tempfile.TemporaryDirectory() as tmp:
        def pair(name, main, argv, outs=(), kernels=(), n_blocks=0):
            reset_launches()
            got = app_pair(name, main, argv, tmp, outs, kernels, n_blocks)
            return got

        # rtl_fm --synth at its defaults for APP_SECONDS
        card_run, cpu_run = pair(
            "rtl_fm --synth", rtl_fm.main,
            ["--synth", "--seconds", str(APP_SECONDS), "-o", "{a.wav}"],
            ["a.wav"], ("xlating_fir_block",), rtl_blocks)
        add(launch_counts())
        check(card_run[0] == cpu_run[0], "rtl_fm --synth stdout")
        same_wav(card_run[1]["a.wav"], cpu_run[1]["a.wav"])
        synth_f, sinad = wav_tone(card_run[1]["a.wav"])
        print(f"app rtl_fm --synth tone: {synth_f:.2f} Hz, SINAD "
              f"{sinad:.2f} dB")
        check(abs(synth_f - TONE_HZ) < 5.0 and sinad > 40.0,
              "rtl_fm --synth tone")

        # a capture of the FM station, quantized to the wire, served
        # over BorIP by a FileDevice at the RTL rate
        cap = os.path.join(tmp, "station.c64")
        x = synth_fm(int(APP_SECONDS * FS), dev, seed=7).cpu().numpy()
        udp.ishort_bytes_to_complex(udp.complex_to_ishort_bytes(x)).tofile(
            cap)
        srv = BorIPServer(("127.0.0.1", 0),
                          default_device=f"file {cap} rate={int(FS)} "
                          "realtime=1")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        orig_remote = borip_client.RemoteDevice
        borip_client.RemoteDevice = RecordingRemote
        RecordingRemote.made = []
        try:
            card_run, cpu_run = pair(
                "rtl_fm --borip", rtl_fm.main,
                ["--borip", f"127.0.0.1:{srv.port}", "--freq",
                 str(STATION_HZ), "--seconds", str(APP_SECONDS), "-o",
                 "{a.wav}"], ["a.wav"], ("xlating_fir_block",), rtl_blocks)
            add(launch_counts())
        finally:
            borip_client.RemoteDevice = orig_remote
            srv.shutdown()
            srv.server_close()
        stats = [d.final_stats for d in RecordingRemote.made]
        print(f"app rtl_fm --borip: the clients' receiver stats {stats}")
        check(len(stats) == 2 and all(s["dropped"] == 0 and s["overruns"] == 0
                                      for s in stats),
              "rtl_fm --borip: the client dropped samples")
        check(card_run[0] == cpu_run[0], "rtl_fm --borip stdout")
        same_wav(card_run[1]["a.wav"], cpu_run[1]["a.wav"])
        f, sinad = wav_tone(card_run[1]["a.wav"])
        print(f"app rtl_fm --borip tone: {f:.2f} Hz, SINAD {sinad:.2f} dB")
        check(abs(f - TONE_HZ) < 5.0 and sinad > 40.0, "rtl_fm --borip tone")

        # rtl_fm --input on the same capture
        card_run, cpu_run = pair(
            "rtl_fm --input", rtl_fm.main,
            ["--input", cap, "--fmt", "c64", "--freq", str(STATION_HZ),
             "-o", "{a.wav}"], ["a.wav"], ("xlating_fir_block",), rtl_blocks)
        add(launch_counts())
        check(card_run[0] == cpu_run[0], "rtl_fm --input stdout")
        # the file source zero-fills its last read past the capture's end:
        # an FM discriminator turns the filters' last rounding bits there
        # into full-scale noise, which no two float orders share, so the
        # WAVs are held over the capture's audio (as the bank holds only
        # the slots that carry a station)
        same_wav(card_run[1]["a.wav"], cpu_run[1]["a.wav"],
                 upto=int(APP_SECONDS * 48e3) - 64)
        f, sinad = wav_tone(card_run[1]["a.wav"])
        print(f"app rtl_fm --input tone: {f:.2f} Hz (--synth {synth_f:.2f}),"
              f" SINAD {sinad:.2f} dB")
        check(abs(f - synth_f) < 5.0 and sinad > 40.0, "rtl_fm --input tone")

        # am_fft at its defaults: B1 at decim 16
        card_run, cpu_run = pair(
            "am_fft", am_fft.main, ["-o", "{am.wav}", "--csv", "{am.csv}"],
            ["am.wav", "am.csv"], ("xlating_fir_block",), 8)
        add(launch_counts())
        check(card_run[0] == cpu_run[0], "am_fft stdout")
        same_wav(card_run[1]["am.wav"], cpu_run[1]["am.wav"])
        spectra = same_db_csv(card_run[1]["am.csv"], cpu_run[1]["am.csv"])
        f, sinad = wav_tone(card_run[1]["am.wav"], skip=2)
        carrier = int(np.argmax(spectra[-1]))
        print(f"app am_fft tone: {f:.2f} Hz, SINAD {sinad:.2f} dB; carrier "
              f"in bin {carrier} of {spectra.shape[1]}")
        check(abs(f - TONE_HZ) < 5.0, "am_fft tone")
        check(carrier == spectra.shape[1] // 2, "am_fft carrier bin")

        # realtime_fft --synth and fac, CSV and images
        card_run, cpu_run = pair(
            "realtime_fft --synth", realtime_fft.main,
            ["--synth", "--csv", "{s.csv}", "--waterfall", "{w.png}"],
            ["s.csv", "w.png"])
        check(card_run[0] == cpu_run[0], "realtime_fft stdout")
        check(same_db_csv(card_run[1]["s.csv"], cpu_run[1]["s.csv"]).shape
              == (32, 4096), "realtime_fft spectra")
        same_png(card_run[1]["w.png"], cpu_run[1]["w.png"])
        card_run, cpu_run = pair("fac", fac.main,
                                 ["--csv", "{f.csv}", "--png", "{f.png}"],
                                 ["f.csv", "f.png"])
        same_db_csv(card_run[1]["f.csv"], cpu_run[1]["f.csv"])
        same_png(card_run[1]["f.png"], cpu_run[1]["f.png"])
        bins = [int(o.split("strongest correlation at bin")[1].split()[0])
                for o in (card_run[0], cpu_run[0])]
        # the FAC is symmetric: bins k and 512 - k tie
        check(len({min(b, 512 - b) for b in bins}) == 1
              and min(bins[0], 512 - bins[0]) % 50 == 0, f"fac bins {bins}")

        # scanner at its defaults: the bank kernel, 8 blocks
        card_run, cpu_run = pair("scanner", scanner.main, [],
                                 kernels=("channel_bank",), n_blocks=8)
        add(launch_counts())
        print("app scanner:", " ".join(card_run[0].split()))
        check(card_run[0] == cpu_run[0], "scanner hits differ from the CPU")
        check("-300.0 kHz : 8/8" in card_run[0]
              and "+100.0 kHz : 8/8" in card_run[0], "scanner stations")

        # papr at its defaults
        card_run, cpu_run = pair("papr", papr.main, ["--csv", "{c.csv}"],
                                 ["c.csv"])
        a, b = (json.loads(r[0].strip().splitlines()[-1])
                for r in (card_run, cpu_run))
        print(f"app papr: card {a}, cpu {b}")
        check(a.keys() == b.keys() and all(
            abs(a[k] - b[k]) <= 1e-4 * abs(b[k]) for k in a),
            "papr differs from the CPU run")
        ca = np.loadtxt(card_run[1]["c.csv"], delimiter=",", skiprows=1)
        cb = np.loadtxt(cpu_run[1]["c.csv"], delimiter=",", skiprows=1)
        check(ca.shape == cb.shape and float(np.abs(ca - cb).max()) <= 1e-5,
              "papr CCDF differs from the CPU run")
    return launches


def profile_chain(run, step_ms: float, label: str, kernels=()):
    """Kernel time per step and by name, from torch.profiler over 5
    steps. The busy share is that kernel time over ``step_ms``, the
    CUDA-event step time of unprofiled runs: the profiler adds host time
    to every op, so the profiled step would understate the share. The
    device kernels whose names hold one of ``kernels`` are summed on a
    line of their own."""
    os.makedirs(OUT_DIR, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = 5
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms = run(steps)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(OUT_DIR, f"{label}_profile.txt"), "w") as fh:
        fh.write(table)
    # kernel rows only: the aten rows repeat their kernels' time
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation)
    kern_ms = dev_us / 1e3 / steps
    busy = kern_ms / step_ms
    print(f"profile {label} ({steps} steps): kernels {kern_ms:.4f} ms per step; "
          f"step {prof_ms:.4f} ms under the profiler, {step_ms:.4f} ms "
          f"without (events); device busy {100 * busy:.1f}%, idle "
          f"{100 * (1 - busy):.1f}% of the unprofiled step")
    for row in table.splitlines()[:12]:
        print("  " + row)
    if kernels:
        mine = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in kernels)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
        print(f"profile {label}: {' + '.join(kernels)} {ms:.4f} ms per step "
              f"({sum(e.count for e in mine) / steps:.0f} launches), "
              f"{100 * ms / step_ms:.1f}% of the unprofiled step")


def chain_timing(dev, iq, cfg, label, rounds=6, steps=20):
    """Step time of the kernel and plain backends in alternating rounds
    (the host's share of the step varies from run to run). The checksum
    reads the audio only, so the step is the chain and one sum."""
    xs = [iq[b * BLOCK:(b + 1) * BLOCK] for b in range(N_BLOCKS)]
    runs = {b: graph_timer(build_wbfm(dataclasses.replace(
        cfg, chan_backend=b, fused_backend=b), device=dev)[0], xs, FS,
        ports=("audio",)) for b in ("auto", "plain")}
    times = {b: [] for b in runs}
    for r in range(rounds):
        for b in (("auto", "plain") if r % 2 == 0 else ("plain", "auto")):
            times[b].append(runs[b](steps))
    for b, ts in times.items():
        med = statistics.median(ts)
        print(f"{label} [{b}] step ms per round (events): "
              + ", ".join(f"{t:.4f}" for t in ts)
              + f"; median {med:.4f} ms = {BLOCK / med / 1e3:.2f} Msamp/s "
              f"({card()})")
    profile_chain(runs["auto"], statistics.median(times["auto"]), label)


def resampler_timing(dev):
    """The resampler's two forms at the cascade chain's audio shape: the
    block runs the generic form; the rational form (with its generic
    guard computed beside it) is timed for the record."""
    n = BLOCK // DECIM // DECIM
    rs = FractionalResampler(n, 25 / 24, dtype=torch.float32, device=dev)
    st, pr = rs.init_state(), rs.init_params()
    frame = torch.cat([st["tail"], torch.randn(n, device=dev)])
    args = (frame, st["mu_int"], st["mu_frac"], pr["inc_int"],
            pr["inc_frac"], rs.capacity, rs.taps_table)
    gen = time_ms(lambda i: resample_block(*args), 50)
    rat = time_ms(lambda i: resample_block_rational(*args, 25, 24), 50)
    print(f"resampler 25/24 at {n} samples/block: generic form {gen:.4f} ms "
          f"(the block's), rational form with its guard {rat:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = report()

    cases = kernel_cases(dev)
    check_kernels(cases)
    viterbi_lengths_phase(dev)

    iq = synth_fm(N_BLOCKS * BLOCK, dev)
    cfg, kern, launches = main_path(dev, iq)
    executor_phase(dev, iq, cfg, kern)
    fused_launches = fused_path(dev, iq)
    for name in FUSED_PATH_KERNELS:
        launches[name] = fused_launches[name]
    pump_phase(dev)

    floor_ms = time_ms(lambda i: torch.cuda._sleep(0), 200)
    rows = []
    for c in cases:
        ms = time_ms(c["kernel"], c.get("iters", 200))
        plain_ms = time_ms(c["plain"], c.get("plain_iters", 20))
        lib_ms = time_ms(c["library"], 200) if c["library"] else None
        b_ms, b_by = bound_ms(c["nbytes"], c["flops"])
        label = c["name"] + (f" [{c['shape']}]" if "shape" in c else "")
        print(f"time {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
              + (f" ({c['library_label']})" if "library_label" in c else "")
              + f", "
              f"bound {b_ms:.4f} ms ({b_by}), "
              f"{c['nbytes'] / ms / 1e6:.1f} GB/s"
              + (f"; {c['after']()}" if "after" in c else ""))
        rows.append(dict(c, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
    chain_timing(dev, iq, cfg, "chain")
    chain_timing(dev, iq, WBFMConfig(block_size=BLOCK, fused=True,
                                     center_freq=STATION_HZ), "fused_chain")
    resampler_timing(dev)
    # the other configurations after the WBFM chains' timing: their
    # profiled runs then cannot touch the chains' step times
    config1_path(dev)
    spectral_path(dev)
    peak_path(dev)
    music_path(dev)
    bank_launches = bank_path(dev)
    for name in BANK_PATH_KERNELS:
        launches[name] = bank_launches[name]
    burst_launches = burst_path(dev)
    for name in BURST_PATH_KERNELS:
        launches[name] = burst_launches[name]
    launches["vrr_walk"] = am_path(dev)["vrr_walk"]
    launches["fastrak_fsm"] = fastrak_path(dev)["fastrak_fsm"]
    launches["viterbi"] = fec_path(dev)["viterbi"]
    dec_launches = decoders_path(dev)
    for name in DECODE_KERNELS:
        launches[name] = dec_launches[name]
    small_blocks_phase(dev)
    launches["xlating_fir_block"] += p25_path(dev)["xlating_fir_block"]
    fmcw_path(dev)
    launches["fir_decimate_frame"] += parallel_path(dev)[
        "fir_decimate_frame"]
    ingest = ingest_path(dev)
    for name in MAIN_PATH_KERNELS:
        launches[name] += ingest[name]
    for name, n in apps_phase(dev).items():
        launches[name] += n

    table = []
    for r in rows:
        # one row per kernel: its first case, the main path's shape and
        # entry point
        if any(t["name"] == r["name"] for t in table):
            continue
        _, source, replaces = KERNELS[r["name"]]
        table.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"launch floor: {floor_ms:.4f} ms per back-to-back empty kernel "
          f"(torch.cuda._sleep(0), CUDA events)")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
