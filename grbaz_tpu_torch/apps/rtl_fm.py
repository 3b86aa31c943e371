"""rtl_fm — WBFM broadcast receiver app (port of ``grbaz_tpu/apps/rtl_fm.py``,
the samples/RTL-FM.grc equivalent).

Input: a capture file (WAV/auxi, raw c64/i16/u8), a BorIP server, or
the synthetic device. Output: 16-bit WAV audio. The DSP chain is the
port's ``models.wbfm`` flowgraph, stepped on the card (the channelizer
kernel B1 and, with ``audio_chain='cascade'``, the decimating FIR B3)
unless ``--device cpu`` is given.

Usage:
  python -m grbaz_tpu_torch.apps.rtl_fm --input cap.wav --freq -250e3 -o out.wav
  python -m grbaz_tpu_torch.apps.rtl_fm --borip host:28888 --freq 100.1e6 ...
  python -m grbaz_tpu_torch.apps.rtl_fm --synth --seconds 2 -o out.wav
  python -m grbaz_tpu_torch.apps.rtl_fm --synth -o out.wav --device cpu
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def write_wav(path, audio: np.ndarray, rate: int):
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)
    data = pcm.tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
        + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


class FMStation:
    """The ``--synth`` source: an FM station carrying a 1 kHz tone at
    ``freq`` Hz within the band, its phase integral carried across
    reads."""

    def __init__(self, rate: float, freq: float, deviation: float):
        self.rate, self.freq, self.deviation = rate, freq, deviation
        self._n = 0
        self._acc = 0.0

    def read_samples(self, n: int) -> np.ndarray:
        t = (self._n + np.arange(n)) / self.rate
        msg = np.sin(2 * np.pi * 1000.0 * t)
        ph = self._acc + 2 * np.pi * np.cumsum(self.deviation * msg) \
            / self.rate
        self._acc = float(ph[-1])
        x = np.exp(1j * (ph + 2 * np.pi * self.freq * t))
        self._n += n
        return x.astype(np.complex64)


def main(argv=None):
    ap = argparse.ArgumentParser(description="WBFM receiver (RTL-FM chain)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="capture file (wav/c64/i16/u8)")
    src.add_argument("--borip", help="BorIP server host[:port]")
    src.add_argument("--synth", action="store_true",
                     help="synthetic FM station (test mode)")
    ap.add_argument("--fmt", default="auto", help="raw file format")
    ap.add_argument("--rate", type=float, default=3.2e6,
                    help="input sample rate (raw files / synth)")
    ap.add_argument("--freq", type=float, default=0.0,
                    help="station offset within the band (Hz)")
    ap.add_argument("--audio-rate", type=float, default=48e3)
    ap.add_argument("--decim", type=int, default=8)
    ap.add_argument("--squelch", type=float, default=None,
                    help="power squelch threshold (dB)")
    ap.add_argument("--deviation", type=float, default=None,
                    help="FM max deviation (default: min(75k, quad/5))")
    ap.add_argument("--seconds", type=float, default=None,
                    help="stop after this many seconds of input")
    ap.add_argument("-o", "--output", required=True, help="output WAV")
    ap.add_argument("--block", type=int, default=1 << 17)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chain (cuda or cpu)")
    args = ap.parse_args(argv)

    from grbaz_tpu_torch.core.device import resolve_device
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.core.stream import stream_flags
    from grbaz_tpu_torch.models.wbfm import WBFMConfig, build_wbfm

    device = resolve_device(args.device)
    rate = args.rate
    closers = []
    # --- input feeder ---
    if args.input:
        from grbaz_tpu_torch.io.file_source import FileSource
        fsrc = FileSource(args.input, fmt=args.fmt, sample_rate=args.rate)
        rate = fsrc.sample_rate or args.rate
        read = fsrc.read_samples
        closers.append(fsrc.close)
    elif args.borip:
        from grbaz_tpu_torch.net.borip_client import RemoteDevice
        host, _, port = args.borip.partition(":")
        dev = RemoteDevice(host, int(port or 28888), udp_port=0)
        closers.append(dev.close)
        dev.set_sample_rate(args.rate)
        dev.set_freq(args.freq)
        dev.start()
        read = lambda n: (dev.wait_samples(n), 0)
    else:
        deviation = args.deviation or min(75e3, args.rate / args.decim / 5)
        station = FMStation(args.rate, args.freq, deviation)
        read = lambda n: (station.read_samples(n), 0)

    cfg = WBFMConfig(sample_rate=rate, center_freq=args.freq,
                     decim=args.decim, audio_rate=args.audio_rate,
                     squelch_db=args.squelch, block_size=args.block,
                     max_deviation=args.deviation
                     or min(75e3, rate / args.decim / 5))
    fg, _ = build_wbfm(cfg, device=device)
    ex = StreamExecutor(fg, {"iq": InputSpec((cfg.block_size,), "complex64",
                                             rate)}, device=device)
    total = int((args.seconds or 1.0) * rate) if (args.seconds or args.synth) \
        else None
    audio = []
    fed = 0
    try:
        while True:
            x, flags = read(cfg.block_size)
            if not args.input:
                flags = 0
            if len(x) < cfg.block_size:
                pad = np.zeros(cfg.block_size, np.complex64)
                pad[:len(x)] = x
                r = ex.step({"iq": pad}, counts={"iq": len(x)})
            else:
                r = ex.step({"iq": x})
            d, c = r["audio"]
            audio.append(d[:c])
            fed += cfg.block_size
            if args.input and (flags & stream_flags.STREAM_END):
                break
            if total is not None and fed >= total:
                break
    finally:
        for close in closers:
            close()
    out = np.concatenate(audio) if audio else np.zeros(0, np.float32)
    write_wav(args.output, out, int(args.audio_rate))
    print(f"wrote {len(out)} audio samples ({len(out)/args.audio_rate:.2f}s) "
          f"to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
