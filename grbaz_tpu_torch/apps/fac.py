"""fac — fast auto-correlation spectrum analyzer (port of
``grbaz_tpu/apps/fac.py``).

Equivalent of the reference's apps/usrp_fac.py (a 32k-point FAC display
over a USRP) and the facsink window it instantiates: source -> FAC
pipeline (FFT -> |.| -> FFT -> |.| -> averaging -> log), stepped on the
card unless ``--device cpu`` is given -> CSV / PNG export. Sources:
capture file, BorIP UDP, or a synthetic pulse train whose correlation
structure shows up as FAC peaks.

Usage:
  python -m grbaz_tpu_torch.apps.fac --frames 8 --csv fac.csv --png fac.png
  python -m grbaz_tpu_torch.apps.fac --udp-port 28888
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="fast auto-correlation analyzer")
    ap.add_argument("--input", help="capture file (default: synthetic)")
    ap.add_argument("--udp-port", type=int, help="BorIP UDP source port")
    ap.add_argument("--rate", type=float, default=250e3)
    ap.add_argument("--fac-size", type=int, default=512)
    ap.add_argument("--fac-rate", type=float, default=3.0)
    ap.add_argument("--avg", type=float, default=0.25)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--block", type=int, default=1 << 16)
    ap.add_argument("--csv", help="write FAC rows to CSV")
    ap.add_argument("--png", help="write FAC waterfall PNG")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chain (cuda or cpu)")
    args = ap.parse_args(argv)

    from grbaz_tpu_torch.core.device import resolve_device
    from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
    from grbaz_tpu_torch.models.spectral import FACConfig, build_fac

    device = resolve_device(args.device)
    cfg = FACConfig(fac_size=args.fac_size, sample_rate=args.rate,
                    fac_rate=args.fac_rate, avg_alpha=args.avg,
                    block_size=args.block)
    fg, _ = build_fac(cfg, device=device)
    ex = StreamExecutor(fg, {"iq": InputSpec((args.block,), "complex64",
                                             args.rate)}, device=device)

    closers = []
    if args.udp_port is not None:
        from grbaz_tpu_torch.apps.realtime_fft import udp_reader
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
            # 5 kHz pulse train: the FAC (an autocorrelation) peaks at
            # the period lag = rate/5e3 samples (bin 50 at 250 kS/s)
            k = ph[0] + np.arange(n)
            ph[0] += n
            period = int(args.rate / 5e3)
            x = np.where(k % period < 4, 1.0, 0.0)
            return (x + 0.01 * rng.standard_normal(n)).astype(np.complex64)

    rows = []
    try:
        while len(rows) < args.frames:
            r = ex.step({"iq": read(args.block)})
            d, c = r["fac"]
            rows.extend(d[:c])
    finally:
        for close in closers:
            close()
    fac = np.asarray(rows[: args.frames])
    peak_bin = int(np.argmax(fac[-1][1:])) + 1  # skip the zero-lag bin
    print(f"collected {len(fac)} FAC frames of {args.fac_size} bins; "
          f"strongest correlation at bin {peak_bin}")
    if args.csv:
        np.savetxt(args.csv, fac, fmt="%.2f", delimiter=",")
        print("wrote", args.csv, file=sys.stderr)
    if args.png:
        from grbaz_tpu_torch.viz import WaterfallSink
        wf = WaterfallSink(width=fac.shape[1], rows=len(fac),
                           vmin=float(fac.min()), vmax=float(fac.max()))
        for row in fac:
            wf.push(row)
        wf.save_png(args.png)
        print("wrote", args.png, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
