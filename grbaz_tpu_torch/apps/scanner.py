"""scanner — multi-channel activity scanner (port of
``grbaz_tpu/apps/scanner.py``: the multi_channel_decoder +
parallel_scanner_fsm app analog, BASELINE config 5 chain).

Watches a wideband stream with the DynamicChannelBank: channels are
added/removed at runtime as activity (per-channel power) crosses
thresholds — the scanner FSM of python/parallel_scanner_fsm.py driving
the dynamic bank of python/multi_channel_decoder.py. The bank steps on
the card (one launch of the bank kernel a block) unless ``--device cpu``
is given; each slot's power is reduced there and read back once a block.

Usage:
  python -m grbaz_tpu_torch.apps.scanner --blocks 8
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-channel scanner")
    ap.add_argument("--input", help="capture file (default: synthetic)")
    ap.add_argument("--rate", type=float, default=1.024e6)
    ap.add_argument("--decim", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--scan-start", type=float, default=-400e3)
    ap.add_argument("--scan-stop", type=float, default=400e3)
    ap.add_argument("--scan-step", type=float, default=100e3)
    ap.add_argument("--threshold-db", type=float, default=-20.0)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--block", type=int, default=1 << 15)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the bank (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch

    from grbaz_tpu_torch.core.device import resolve_device
    from grbaz_tpu_torch.core.stream import Stream, StreamMeta
    from grbaz_tpu_torch.parallel.channel_bank import DynamicChannelBank

    device = resolve_device(args.device)
    freqs = np.arange(args.scan_start, args.scan_stop + 1, args.scan_step)
    bank = DynamicChannelBank(capacity=args.capacity, sample_rate=args.rate,
                              decim=args.decim, channel_width=25e3,
                              transition=25e3, device=device)
    params = bank.init_params()
    state = bank.init_state()
    slots = {}
    for f in freqs[:args.capacity]:
        slots[bank.add_channel(params, f)] = f

    fsrc = None
    if args.input:
        from grbaz_tpu_torch.io.file_source import FileSource
        fsrc = FileSource(args.input, sample_rate=args.rate)
        read = lambda n: fsrc.read_samples(n)[0]
    else:
        ph = [0]
        rng = np.random.default_rng(1234)
        active_stations = [-300e3, 100e3]

        def read(n):
            t = (ph[0] + np.arange(n)) / args.rate
            ph[0] += n
            x = sum(0.5 * np.exp(2j * np.pi * f * t) for f in active_stations)
            x = x + 0.002 * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
            return x.astype(np.complex64)

    thr = 10 ** (args.threshold_db / 10.0)
    hits = {}
    try:
        for b in range(args.blocks):
            x = torch.from_numpy(read(args.block)).to(device)
            s = Stream.full(x, meta=StreamMeta.start(args.rate, device=device))
            state, (quad, act) = bank.apply(state, params, s)
            # activity = variance of the demodulated channel (FM noise floor
            # drops when a carrier is present -> use channel power instead);
            # every slot's mean power in one reduction and one read-back
            power = quad.data.to(torch.float64).square().mean(dim=1).cpu()
            for slot, f in list(slots.items()):
                busy = float(power[slot]) < 10.0  # quiet discriminator
                if busy:
                    hits[f] = hits.get(f, 0) + 1
    finally:
        if fsrc is not None:
            fsrc.close()
    print("scan results (blocks with carrier per frequency):")
    for f in sorted(hits):
        print(f"  {f/1e3:+9.1f} kHz : {hits[f]}/{args.blocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
