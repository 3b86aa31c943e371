"""am_fft — AM receiver with spectrum analysis (port of
``grbaz_tpu/apps/am_fft.py``).

Equivalent of the reference's apps/am_fft.py (USRP AM receive chain
with FFT/waterfall/scope displays): source -> channel select
(freq-xlating FIR decimator, the channelizer kernel B1 on the card) ->
AM envelope demod -> audio WAV, plus an averaged spectrum export of the
channelized band. One flowgraph, stepped on the card unless ``--device
cpu`` is given.

Usage:
  python -m grbaz_tpu_torch.apps.am_fft -f 100e3 -o am.wav --csv am.csv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="AM receiver + FFT")
    ap.add_argument("--input", help="capture file (default: synthetic AM)")
    ap.add_argument("--rate", type=float, default=1.024e6)
    ap.add_argument("-f", "--freq", type=float, default=0.0,
                    help="station offset within the band (Hz)")
    ap.add_argument("-d", "--decim", type=int, default=16)
    ap.add_argument("--bandwidth", type=float, default=10e3)
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--block", type=int, default=1 << 16)
    ap.add_argument("-o", "--output", help="write demodulated audio WAV")
    ap.add_argument("--csv", help="write channel spectra to CSV")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chain (cuda or cpu)")
    args = ap.parse_args(argv)

    from grbaz_tpu_torch.core.device import resolve_device
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.core.graph import Flowgraph
    from grbaz_tpu_torch.ops.demod import AMDemod
    from grbaz_tpu_torch.ops.fir import FreqXlatingFIRDecimator, low_pass_taps
    from grbaz_tpu_torch.ops.spectral import PowerSpectrum, Vectorize

    device = resolve_device(args.device)
    chan_rate = args.rate / args.decim
    taps = low_pass_taps(1.0, args.rate, args.bandwidth,
                         args.bandwidth / 2)
    fg = Flowgraph("am_fft")
    chan = FreqXlatingFIRDecimator(taps, args.decim, args.freq, args.rate,
                                   name="channel", device=device)
    am = AMDemod(dc_alpha=1e-3, gain=2.0, name="am", device=device)
    framer = Vectorize(args.fft)
    psd = PowerSpectrum(args.fft, "blackmanharris", 0.25, name="psd",
                        device=device)
    fg.input("iq", chan)
    fg.chain(chan, am)
    fg.connect(chan, framer)
    fg.chain(framer, psd)
    fg.output("audio", am)
    fg.output("spectra", psd)
    ex = StreamExecutor(fg, {"iq": InputSpec((args.block,), "complex64",
                                             args.rate)}, device=device)

    fsrc = None
    if args.input:
        from grbaz_tpu_torch.io.file_source import FileSource
        fsrc = FileSource(args.input, sample_rate=args.rate)
        read = lambda n: fsrc.read_samples(n)[0]
    else:
        ph = [0]
        rng = np.random.default_rng(1234)

        def read(n):
            # AM station at the tuned offset, 80% depth 1 kHz tone
            t = (ph[0] + np.arange(n)) / args.rate
            ph[0] += n
            msg = 0.8 * np.sin(2 * np.pi * 1e3 * t)
            return (0.5 * (1 + msg) * np.exp(2j * np.pi * args.freq * t)
                    + 0.005 * rng.standard_normal(n)).astype(np.complex64)

    audio, spectra = [], []
    try:
        for _ in range(args.blocks):
            r = ex.step({"iq": read(args.block)})
            d, c = r["audio"]
            audio.append(d[:c])
            sd, sc = r["spectra"]
            spectra.append(sd[:sc])
    finally:
        if fsrc is not None:
            fsrc.close()
    audio = np.concatenate(audio or [np.zeros(0)]).astype(np.float32)
    spectra = np.concatenate(spectra) if spectra else np.zeros(0)
    rms = float(np.sqrt(np.mean(audio[len(audio) // 2:] ** 2)))
    print(f"demodulated {len(audio)} audio samples @ {chan_rate:.0f} Hz, "
          f"rms {rms:.4f}; {len(spectra)} spectra of {args.fft} bins")
    if args.output:
        from grbaz_tpu_torch.apps.rtl_fm import write_wav
        write_wav(args.output, np.clip(audio, -1, 1), int(chan_rate))
        print("wrote", args.output, file=sys.stderr)
    if args.csv and len(spectra):
        np.savetxt(args.csv, spectra, fmt="%.2f", delimiter=",")
        print("wrote", args.csv, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
