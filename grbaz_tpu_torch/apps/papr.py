"""papr — peak-to-average power ratio analysis of an IQ capture (port of
``grbaz_tpu/apps/papr.py``).

Equivalent of the reference's apps/papr.py (offline PAPR tool with a
moving-average envelope and matplotlib plots): loads an IQ file (or
synthesizes a test signal), computes instantaneous power, a moving
average, PAPR, and the CCDF (probability that instantaneous power
exceeds the average by x dB); exports CSV instead of plotting. The power
pipeline runs on the card unless ``--device cpu`` is given.

Usage:
  python -m grbaz_tpu_torch.apps.papr --csv ccdf.csv
  python -m grbaz_tpu_torch.apps.papr cap.c64 -t c64 -T 1000000
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_DTYPES = {"c8": None, "c64": np.complex64, "i16": np.int16, "u8": np.uint8}


def load_iq(path: str, fmt: str, trim: int | None = None) -> np.ndarray:
    if fmt == "c8":  # interleaved signed byte IQ (the reference default)
        raw = np.fromfile(path, np.int8)
        x = (raw[0::2].astype(np.float32)
             + 1j * raw[1::2].astype(np.float32)) / 128.0
    elif fmt == "c64":
        x = np.fromfile(path, np.complex64)
    elif fmt == "i16":
        raw = np.fromfile(path, np.int16).astype(np.float32) / 32767.0
        x = raw[0::2] + 1j * raw[1::2]
    elif fmt == "u8":
        raw = (np.fromfile(path, np.uint8).astype(np.float32) - 127.5) / 127.5
        x = raw[0::2] + 1j * raw[1::2]
    else:
        raise ValueError(f"type {fmt!r} not in {sorted(_DTYPES)}")
    x = x.astype(np.complex64)
    return x[:trim] if trim else x


def analyze(xr, xi, window: int):
    """(average power, peak power, peak of the ``window``-sample moving
    average, the dB steps, the CCDF at each step) of float32 tensors."""
    import torch

    p = xr * xr + xi * xi
    avg = torch.mean(p)
    peak = torch.max(p)
    # numpy's convolve(mode="same") window: w//2 samples before each
    # output and w - 1 - w//2 after it
    w = int(window)
    k = torch.full((1, 1, w), 1.0 / w, dtype=p.dtype, device=p.device)
    ma = torch.nn.functional.conv1d(
        torch.nn.functional.pad(p[None, None], (w // 2, w - 1 - w // 2)),
        k)[0, 0]
    # CCDF over 0..12 dB above average in 0.25 dB steps
    steps = torch.arange(0.0, 12.25, 0.25, dtype=torch.float32,
                         device=p.device)
    thr = avg * 10.0 ** (steps / 10.0)
    ccdf = torch.mean((p[None, :] > thr[:, None]).to(torch.float32), dim=1)
    return avg, peak, torch.max(ma), steps, ccdf


def main(argv=None):
    ap = argparse.ArgumentParser(description="PAPR / CCDF analysis")
    ap.add_argument("input", nargs="?", help="IQ file (default: synth QPSK)")
    ap.add_argument("-t", "--type", default="c8",
                    choices=sorted(_DTYPES), help="input sample format")
    ap.add_argument("-T", "--trim", type=int, help="max samples")
    ap.add_argument("-w", "--window", type=int, default=256,
                    help="moving-average window")
    ap.add_argument("--csv", help="write CCDF table to CSV")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the analysis (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch

    from grbaz_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    if args.input:
        x = load_iq(args.input, args.type, args.trim)
    else:
        rng = np.random.default_rng(0)
        sym = rng.choice([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], 1 << 16)
        x = np.repeat(sym, 4) * (1 / np.sqrt(2))
        # pulse-shape so the envelope varies (realistic PAPR > 0 dB)
        from grbaz_tpu_torch.ops.fir import low_pass_taps
        h = low_pass_taps(1.0, 4.0, 0.35, 0.15)
        x = np.convolve(x, h, mode="same").astype(np.complex64)

    xr = torch.from_numpy(np.ascontiguousarray(x.real)).to(device)
    xi = torch.from_numpy(np.ascontiguousarray(x.imag)).to(device)
    avg, peak, peak_ma, steps, ccdf = (
        v.cpu().numpy() for v in analyze(xr, xi, args.window))
    papr_db = 10.0 * np.log10(float(peak) / max(float(avg), 1e-30))
    papr_ma_db = 10.0 * np.log10(float(peak_ma) / max(float(avg), 1e-30))
    print(json.dumps(dict(samples=len(x),
                          avg_power=float(avg), peak_power=float(peak),
                          papr_db=round(papr_db, 3),
                          papr_ma_db=round(papr_ma_db, 3))))
    if args.csv:
        from grbaz_tpu_torch.viz.export import write_csv
        write_csv(args.csv, zip(steps, ccdf),
                  header=["db_above_avg", "prob"])
        print("wrote", args.csv, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
