"""The MUSIC direction-finding station on the port: the five antennas'
snapshots channelized by B1 in one launch (``FreqXlatingFIRDecimator``
over ``[n, M]`` rows), framed (``SnapshotFrames``) and resolved by
``MusicDOA`` in one ``Flowgraph`` under a ``StreamExecutor``. Sizes come
from ``doa.json``; the block size, in array snapshots, from the cell's
traffic.

The array delivers snapshot rows ``s * a(theta)``; the port's covariance
is ``x^H x`` of rows, the conjugate of gr-baz's ``R = x x^H``, so
``MusicDOA`` is handed the conjugated steering vectors and its spectrum
is gr-baz's.

A traced run of this cell asks the profiler to tear CUPTI down at the
end of each session (``TEARDOWN_CUPTI=1``, unless the environment sets
it). Left to its default, the profile of the window is a second session
started while the runner launches ~570 kernels a block, and on the H100
about one such session in four kept no kernel record at all (memcpys
and runtime calls still recorded), which leaves every kernel metric of
the cell without a reading. A fresh CUPTI at the window's start keeps
them. Untraced runs never start the profiler, so this changes nothing
there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from radiobench import signals
from radiobench.reference import doa as reference

# the outputs the sinks receive, in the order the pump hands them on
PORTS = ("spectrum", "doas")

# read by the profiler when a session stops (see the module's docstring)
os.environ.setdefault("TEARDOWN_CUPTI", "1")


def executor(cfg: dict, block: int, device):
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.core.graph import Flowgraph
    from grbaz_tpu_torch.ops.doa import (MusicDOA, SnapshotFrames,
                                         uca_steering_vectors)
    from grbaz_tpu_torch.ops.fir import FreqXlatingFIRDecimator, low_pass_taps

    fs, m = cfg["sample_rate"], cfg["antennas"]
    decim, navg = cfg["decim"], cfg["navg"]
    if block % (decim * navg):
        raise ValueError(f"a block of {block} snapshots is not a whole "
                         f"number of {navg}-snapshot frames after "
                         f"decimation by {decim}")
    taps = low_pass_taps(1.0, fs, cfg["channel_width"] / 2
                         + cfg["transition"] / 2, cfg["transition"])
    chan = FreqXlatingFIRDecimator(taps, decim, cfg["channel_hz"], fs,
                                   rows=m, name="chan", device=device)
    frames = SnapshotFrames(navg, name="frames")
    steering = np.conj(uca_steering_vectors(m, cfg["radius_wavelengths"],
                                            cfg["angles"]))
    music = MusicDOA(m, cfg["signals"], navg, steering=steering,
                     method=cfg["method"], name="music", device=device)
    fg = Flowgraph("doa")
    fg.input("iq", chan)
    fg.chain(chan, frames, music)
    for i, port in enumerate(PORTS):
        fg.output(port, (music, i))
    return StreamExecutor(fg, {"iq": InputSpec((block, m), "complex64", fs)},
                          device=device)


def bearings(cfg: dict, ring_blocks: int, seed: int, k: int) -> np.ndarray:
    """int [ring_blocks, 2]: each ring block's two bearings in degrees,
    bins of the 360-bin scan, at least ``min_separation_deg`` apart round
    the circle."""
    sep = cfg["signal"]["min_separation_deg"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 27, k])
    first = rng.integers(0, 360, ring_blocks)
    return np.stack([first, (first + rng.integers(sep, 360 - sep + 1,
                                                   ring_blocks)) % 360], 1)


def ring(cfg: dict, streams: int, ring_blocks: int, block: int, seed: int,
         device) -> np.ndarray:
    """complex64 [streams, ring_blocks, block, M] on the host. Each stream:
    two NBFM emitters in the channel, each an FM carrier of one tone
    (frequency, offset and phases drawn from the seed) at its in-channel
    SNR, arriving from the ring block's bearings as rows ``s * a(theta)``
    (the circular array's response, the reference's steering vectors at
    those bins), plus independent complex noise on every antenna."""
    sig, fs, m = cfg["signal"], cfg["sample_rate"], cfg["antennas"]
    resp = reference.steering(cfg, "f64", device)
    rng = np.random.default_rng([int(seed) % (1 << 63), 26])
    gen = signals.seed_generator(seed, device)
    n = ring_blocks * block
    # in-channel SNR: the emitter's power over the noise in channel_width
    noise_in = 2 * sig["noise_rms"] ** 2 * cfg["channel_width"] / fs
    out = np.empty((streams, ring_blocks, block, m), np.complex64)
    for k in range(streams):
        deg = bearings(cfg, ring_blocks, seed, k)
        x = torch.zeros((ring_blocks, block, m), dtype=torch.complex128,
                        device=device)
        for e, snr in enumerate(sig["snr_db"]):
            amp = float(np.sqrt(noise_in * 10 ** (snr / 10)))
            fc = cfg["channel_hz"] + rng.uniform(-1, 1) * sig["offset_hz"]
            tone = rng.uniform(*sig["tone_hz"])
            s = amp * signals.fm_stream(
                n, fs, [(fc, sig["deviation_hz"], tone,
                         rng.uniform(0, 2 * np.pi),
                         rng.uniform(0, 2 * np.pi))], 0.0, gen, device)
            x += s.reshape(ring_blocks, block, 1) * resp[
                torch.from_numpy(deg[:, e]).to(device)][:, None, :]
            del s
        noise = torch.randn((ring_blocks, block, m, 2), generator=gen,
                            device=device) * sig["noise_rms"]
        out[k] = (x + torch.view_as_complex(noise)).to(
            torch.complex64).cpu().numpy()
        del x, noise
    return out
