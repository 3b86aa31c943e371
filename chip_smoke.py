#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``grbaz_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA card and the CUDA toolkit (``nvcc``); the first run builds
the kernels from ``grbaz_tpu_torch/csrc`` (one ``nvcc`` per source, all
started together). Imports nothing of JAX or ``grbaz_tpu``. Phases, any
failure of which exits non-zero:

1. report the card, its power limit and the versions; build the kernels;
2. hold every kernel against its plain PyTorch version at the main
   path's shapes (max-abs error < 1e-5 * max|plain|);
3. the main path: the cascade WBFM receiver at 2^20-sample blocks,
   8 chained blocks of a synthesized FM station through the Flowgraph
   step with the kernels, launch counts set to 0 just before and read
   just after; the same run on the plain backend must agree, and the
   1 kHz test tone must come back (frequency and SINAD);
4. the host-fed StreamExecutor with a retune and a partial last block;
5. times from CUDA events after warm-up: each kernel, its plain version
   and the one-call library equivalent where there is one, beside its
   bound; the chain's step time and Msamp/s; the resampler's two forms;
   a torch.profiler breakdown of chain steps (``chiprun_out/``).

The last lines are the kernel table as JSON, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models.wbfm import WBFMConfig, build_wbfm
from grbaz_tpu_torch.ops import exact, fir
from grbaz_tpu_torch.ops.cuda import build
from grbaz_tpu_torch.ops.cuda import fir_decimate as fd
from grbaz_tpu_torch.ops.cuda import xlating_fir as xf
from grbaz_tpu_torch.ops.fir import FreqXlatingFIRDecimator
from grbaz_tpu_torch.ops.resampler import (FractionalResampler,
                                           resample_block,
                                           resample_block_rational)

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

KERNELS = {  # wrapper -> (source, replaced TPU kernel)
    "xlating_fir_block": (
        xf.xlating_fir_block, "grbaz_tpu_torch/csrc/xlating_fir.cu",
        "grbaz_tpu/ops/pallas/wbfm_frontend.py:621"),
    "xlating_fir_frame_rtf": (
        xf.xlating_fir_frame_rtf, "grbaz_tpu_torch/csrc/xlating_fir.cu",
        "grbaz_tpu/ops/pallas/wbfm_frontend.py:403"),
    "fir_decimate_frame": (
        fd.fir_decimate_frame, "grbaz_tpu_torch/csrc/fir_decimate.cu",
        "grbaz_tpu/ops/pallas/fir_kernel.py:113"),
}
# kernels the cascade main path launches; xlating_fir_frame_rtf is the
# frame-convention entry point of the channelizer kernel, which the JAX
# package calls only from its tests
MAIN_PATH_KERNELS = ("xlating_fir_block", "fir_decimate_frame")


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


def tone_sinad(audio: np.ndarray, rate: float):
    """(peak frequency, SINAD dB) with a Blackman-Harris window; the
    signal is the peak bin +-8, the rest above DC is noise+distortion."""
    n = len(audio)
    k = np.arange(n)
    w = (0.35875 - 0.48829 * np.cos(2 * np.pi * k / (n - 1))
         + 0.14128 * np.cos(4 * np.pi * k / (n - 1))
         - 0.01168 * np.cos(6 * np.pi * k / (n - 1)))
    p = np.abs(np.fft.rfft((audio - audio.mean()) * w)) ** 2
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
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def report():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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

    def conv_real(frame, h):
        return torch.nn.functional.conv1d(frame[None, None], h[None, None],
                                          stride=DECIM)

    planar = [torch.view_as_real(f).T.contiguous()[:, None]
              for f in frames]
    rot_flops = 6 * BLOCK + 4 * tpad * n_out
    return [
        dict(name="xlating_fir_block",
             kernel=lambda i: xf.xlating_fir_block(
                 xs[i % len(xs)], tail, h_chan, DECIM, phase0, inc),
             plain=lambda i: xf.xlating_fir_block_plain(
                 xs[i % len(xs)], tail, h_chan, DECIM, phase0, inc),
             library=None,
             nbytes=8 * BLOCK + 12 * tpad + 8 * n_out + 16, flops=rot_flops),
        dict(name="xlating_fir_frame_rtf",
             kernel=lambda i: xf.xlating_fir_frame_rtf(
                 frames[i % len(frames)], h_chan, DECIM, phase0, inc),
             plain=lambda i: xf.xlating_fir_frame_rtf_plain(
                 frames[i % len(frames)], h_chan, DECIM, phase0, inc),
             library=None,
             nbytes=8 * (tpad - 1 + BLOCK) + 4 * tpad + 8 * n_out + 16,
             flops=rot_flops),
        dict(name="fir_decimate_frame", shape="audio_aa f32",
             kernel=lambda i: fd.fir_decimate_frame(
                 aa_frames[i % len(aa_frames)], h_aa, DECIM),
             plain=lambda i: fd.fir_decimate_frame_plain(
                 aa_frames[i % len(aa_frames)], h_aa, DECIM),
             library=lambda i: conv_real(aa_frames[i % len(aa_frames)], h_aa),
             nbytes=4 * (tpad_aa - 1 + n_out) + 4 * tpad_aa + 4 * n_aa,
             flops=2 * tpad_aa * n_aa),
        dict(name="fir_decimate_frame", shape="channel c64",
             kernel=lambda i: fd.fir_decimate_frame(
                 frames[i % len(frames)], h_chan, DECIM),
             plain=lambda i: fd.fir_decimate_frame_plain(
                 frames[i % len(frames)], h_chan, DECIM),
             library=lambda i: torch.nn.functional.conv1d(
                 planar[i % len(planar)], h_chan[None, None], stride=DECIM),
             nbytes=8 * (tpad - 1 + BLOCK) + 4 * tpad + 8 * n_out,
             flops=4 * tpad * n_out),
    ]


def check_kernels(cases):
    for c in cases:
        got, ref = c["kernel"](0), c["plain"](0)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bar = 1e-5 * float(ref.abs().max())
        c["max_abs_err"] = err
        label = c["name"] + (f" [{c['shape']}]" if "shape" in c else "")
        print(f"kernel {label}: max_abs_err {err:.3e} (bar {bar:.3e}), "
              f"shape {tuple(got.shape)} {got.dtype}")
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{label} shape/dtype")
        check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got).all()), f"{label} finite")
        check(err < bar, f"{label} disagrees with its plain version")


def run_chain(cfg, dev, iq, n_blocks):
    fg, handles = build_wbfm(cfg, device=dev)
    step = fg.compile().step
    states, params = fg.init_states(), fg.init_params()
    outs = []
    for b in range(n_blocks):
        x = iq[b * BLOCK:(b + 1) * BLOCK]
        states, o = step(states, params,
                         {"iq": Stream.full(x, sample_rate=FS)})
        outs.append({k: (s.data, s.count) for k, s in o.items()})
    torch.cuda.synchronize()
    return fg, outs


def valid(outs, port):
    return [d[: int(c)] for d, c in (o[port] for o in outs)]


def main_path(dev, iq):
    cfg = WBFMConfig(block_size=BLOCK, audio_chain="cascade",
                     center_freq=STATION_HZ)
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    _, kern = run_chain(cfg, dev, iq, N_BLOCKS)
    launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
    print(f"main path launches over {N_BLOCKS} blocks: {launches}")
    for name in MAIN_PATH_KERNELS:
        check(launches[name] == N_BLOCKS, f"main path launched {name} "
              f"{launches[name]} times, not once per block")

    _, plain = run_chain(dataclasses.replace(cfg, chan_backend="plain"), dev,
                         iq, N_BLOCKS)
    check(all(fn.launches == launches[n]
              for n, (fn, _, _) in KERNELS.items()),
          "the plain backend launched a kernel")
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


def chain_runner(dev, iq, cfg, backend):
    """A function ``run(steps)`` that runs that many chained steps of the
    chain on ``backend`` and returns the CUDA-event ms per step. Every
    block's audio feeds a checksum, so no stage is dead code."""
    fg, _ = build_wbfm(dataclasses.replace(cfg, chan_backend=backend),
                       device=dev)
    step = fg.compile().step
    params = fg.init_params()
    xs = [iq[b * BLOCK:(b + 1) * BLOCK] for b in range(N_BLOCKS)]
    carry = dict(states=fg.init_states(), acc=torch.zeros((), device=dev),
                 i=0)

    def run(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            x = xs[carry["i"] % len(xs)]
            states, o = step(carry["states"], params,
                             {"iq": Stream.full(x, sample_rate=FS)})
            carry.update(states=states, i=carry["i"] + 1,
                         acc=carry["acc"] + o["audio"].data.sum())
        end.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(carry["acc"])), "chain checksum")
        return start.elapsed_time(end) / steps

    run(3)  # warm-up
    return run


def profile_chain(run, step_ms: float):
    """Kernel time per step and by name, from torch.profiler over 5
    steps. The busy share is that kernel time over ``step_ms``, the
    CUDA-event step time of unprofiled runs: the profiler adds host time
    to every op, so the profiled step would understate the share."""
    os.makedirs(OUT_DIR, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = 5
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms = run(steps)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(OUT_DIR, "chain_profile.txt"), "w") as fh:
        fh.write(table)
    # kernel rows only: the aten rows repeat their kernels' time
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation)
    kern_ms = dev_us / 1e3 / steps
    busy = kern_ms / step_ms
    print(f"profile ({steps} steps): kernels {kern_ms:.4f} ms per step; "
          f"step {prof_ms:.4f} ms under the profiler, {step_ms:.4f} ms "
          f"without (events); device busy {100 * busy:.1f}%, idle "
          f"{100 * (1 - busy):.1f}% of the unprofiled step")
    for row in table.splitlines()[:18]:
        print("  " + row)


def chain_timing(dev, iq, cfg, rounds=6, steps=20):
    """Step time of the kernel and plain backends in alternating rounds
    (the host's share of the step varies from run to run)."""
    runs = {b: chain_runner(dev, iq, cfg, b) for b in ("auto", "plain")}
    times = {b: [] for b in runs}
    for r in range(rounds):
        for b in (("auto", "plain") if r % 2 == 0 else ("plain", "auto")):
            times[b].append(runs[b](steps))
    for b, ts in times.items():
        med = statistics.median(ts)
        print(f"chain [{b}] step ms per round (events): "
              + ", ".join(f"{t:.4f}" for t in ts)
              + f"; median {med:.4f} ms = {BLOCK / med / 1e3:.2f} Msamp/s")
    profile_chain(runs["auto"], statistics.median(times["auto"]))


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

    iq = synth_fm(N_BLOCKS * BLOCK, dev)
    cfg, kern, launches = main_path(dev, iq)
    executor_phase(dev, iq, cfg, kern)

    rows = []
    for c in cases:
        ms = time_ms(c["kernel"], 200)
        plain_ms = time_ms(c["plain"], 20)
        lib_ms = time_ms(c["library"], 200) if c["library"] else None
        b_ms, b_by = bound_ms(c["nbytes"], c["flops"])
        label = c["name"] + (f" [{c['shape']}]" if "shape" in c else "")
        print(f"time {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), "
              f"{c['nbytes'] / ms / 1e6:.1f} GB/s")
        rows.append(dict(c, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
    chain_timing(dev, iq, cfg)
    resampler_timing(dev)

    table = []
    for r in rows:
        # one row per kernel: the main path's shape where there are two
        if any(t["name"] == r["name"] for t in table):
            continue
        _, source, replaces = KERNELS[r["name"]]
        table.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
