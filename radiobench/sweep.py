"""Find a live cell's knee: the highest number of streams at which the
95th percentile of block latency stays within one block period and the
blocks outstanding at the window's end are no more than at its middle
plus the pump's ``inflight``.

    python3 -m radiobench.sweep --config rtl_fm --traffic live_k2 \
        --streams 1,2,3,4 --seconds 10 --seed 7

Each count runs the configuration under the open-loop mix with
``streams`` replaced, one run a count in this process, seeds ``seed +
count``. Prints one line a count and the knee, with 0.8 of it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True, help="an open-loop mix")
    ap.add_argument("--streams", required=True,
                    help="comma-separated stream counts, rising")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from radiobench import manifest, run, spans
    if not torch.cuda.is_available():
        print("radiobench.sweep: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = dict(name=f"{args.config}.{args.traffic}", config=args.config,
                traffic=args.traffic, chips=1)
    base = manifest.traffic(args.traffic)
    if base["loop"] != "open":
        print("radiobench.sweep: a live (open-loop) cell only",
              file=sys.stderr)
        return 2
    period = base["block"] / base["rate_sps"]
    inflight = manifest.config(args.config)["pump"]["inflight"]
    print(f"card: {run.card()}; period {1e3 * period:.3f} ms", flush=True)
    rows = []
    for k in (int(s) for s in args.streams.split(",")):
        traffic = dict(base, streams=k)
        # blocks still owed a second after the close count as failed: a
        # count that holds delivers them within a few periods
        res, info = run.run_cell(cell, args.seed + k, args.seconds, False,
                                 device, time.perf_counter(),
                                 traffic=traffic, drain_s=1.0)
        lat = info["latencies"]
        p95 = 1e3 * spans.percentile(lat, 95)
        ok = (p95 <= 1e3 * period and info["failed"] == 0
              and info["backlog_end"] <= info["backlog_mid"] + inflight)
        row = dict(streams=k, p50_ms=1e3 * spans.percentile(lat, 50),
                   p95_ms=p95, backlog_mid=info["backlog_mid"],
                   backlog_end=info["backlog_end"],
                   attempted=info["attempted"], failed=info["failed"],
                   correct=res["correct"], sustained=ok)
        rows.append(row)
        print(json.dumps(row), flush=True)
    held = [r["streams"] for r in rows if r["sustained"]]
    knee = max(held) if held else 0
    print(json.dumps(dict(knee=knee, cell_streams=math.floor(0.8 * knee))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
