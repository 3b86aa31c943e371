"""realtime_fft — network spectrum analyzer (port of
``grbaz_tpu/apps/realtime_fft.py``, the apps/realtime_fft.py analog).

Receives samples over BorIP UDP (or reads a file / synthesizes), steps
the port's PowerSpectrum chain (``models.spectral.build_spectrum``) on
the card unless ``--device cpu`` is given, and exports spectra: CSV
rows and a PNG waterfall (colouriser raster). The wx display of the
reference is replaced by data export.

Usage:
  python -m grbaz_tpu_torch.apps.realtime_fft --synth --csv s.csv --waterfall w.png
  python -m grbaz_tpu_torch.apps.realtime_fft --udp-port 28888 --frames 64
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def udp_reader(rx, poll: float = 0.005):
    """``read(n)``: exactly n samples from the BorIP receiver ``rx``,
    accumulating partial reads (a block straddles any number of them).
    The receiver hands out whole packets only, so the rest of a packet
    that ends past the block is kept for the next call (the JAX app asks
    for ``n - got`` samples and waits forever once that is less than a
    packet, unless the block is a multiple of one)."""
    import time

    pending = np.zeros(0, np.complex64)
    per_packet = max(1, rx.payload_size // 4)

    def read(n):
        nonlocal pending
        out = np.zeros(n, np.complex64)
        got = min(n, len(pending))
        out[:got], pending = pending[:got], pending[got:]
        while got < n:
            x, _ = rx.read_complex(max(n - got, per_packet))
            if len(x):
                take = min(len(x), n - got)
                out[got:got + take], pending = x[:take], x[take:]
                got += take
            else:
                time.sleep(poll)
        return out
    return read


def main(argv=None):
    ap = argparse.ArgumentParser(description="network spectrum analyzer")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--udp-port", type=int, help="BorIP UDP listen port")
    src.add_argument("--input", help="capture file")
    src.add_argument("--synth", action="store_true")
    ap.add_argument("--rate", type=float, default=250e3)
    ap.add_argument("--fft", type=int, default=4096)
    ap.add_argument("--avg", type=float, default=0.25)
    ap.add_argument("--frames", type=int, default=32,
                    help="spectra to collect before exit (0=forever)")
    ap.add_argument("--block", type=int, default=1 << 16)
    ap.add_argument("--csv", help="write spectra rows to CSV")
    ap.add_argument("--waterfall", help="write waterfall PNG (PPM fallback)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chain (cuda or cpu)")
    args = ap.parse_args(argv)

    from grbaz_tpu_torch.core.device import resolve_device
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.models.spectral import SpectralConfig, build_spectrum

    device = resolve_device(args.device)
    cfg = SpectralConfig(fft_size=args.fft, avg_alpha=args.avg,
                         block_size=args.block,
                         waterfall=bool(args.waterfall))
    fg, _ = build_spectrum(cfg, device=device)
    ex = StreamExecutor(fg, {"iq": InputSpec((args.block,), "complex64",
                                             args.rate)}, device=device)

    closers = []
    if args.udp_port is not None:
        from grbaz_tpu_torch.net.udp import UDPSampleReceiver
        rx = UDPSampleReceiver(port=args.udp_port, bor=True)
        closers.append(rx.close)
        read = udp_reader(rx)
    elif args.input:
        from grbaz_tpu_torch.io.file_source import FileSource
        fsrc = FileSource(args.input, sample_rate=args.rate)
        closers.append(fsrc.close)
        read = lambda n: fsrc.read_samples(n)[0]
    else:
        ph = [0]
        rng = np.random.default_rng(1234)

        def read(n):
            t = ph[0] + np.arange(n)
            ph[0] += n
            x = (0.5 * np.exp(2j * np.pi * 0.1 * t)
                 + 0.05 * np.exp(2j * np.pi * -0.23 * t)
                 + 0.01 * rng.standard_normal(n)).astype(np.complex64)
            return x

    spectra, rasters = [], []
    try:
        while args.frames == 0 or len(spectra) < args.frames:
            r = ex.step({"iq": read(args.block)})
            d, c = r["spectra"]
            spectra.extend(d[:c])
            if args.waterfall:
                rd, rc = r["raster"]
                rasters.extend(rd[:rc])
    finally:
        for close in closers:
            close()
    spectra = np.asarray(spectra[:args.frames or None])
    print(f"collected {len(spectra)} spectra of {args.fft} bins; "
          f"peak {spectra.max():.1f} dBFS at bin "
          f"{int(np.argmax(spectra.max(axis=0)))}")

    if args.csv:
        np.savetxt(args.csv, spectra, fmt="%.2f", delimiter=",")
        print("wrote", args.csv)
    if args.waterfall:
        from grbaz_tpu_torch.viz.export import write_image
        rows = np.asarray(rasters).reshape(len(rasters), -1, 3)
        write_image(args.waterfall, rows)
        print("wrote", args.waterfall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
