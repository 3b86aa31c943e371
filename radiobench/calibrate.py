"""Readings for a cell's correctness limits, in one process.

    python3 -m radiobench.calibrate --workload rtl_fm.replay \
        --seeds 12 --control-seeds 3 --seconds 3 --seed 1000

Runs the cell (its own traffic, a short window) on ``--seeds`` seeds and
prints each number compared, as a run computes it; then on
``--control-seeds`` further seeds with the control in the program's
place: the plain reference computed in TF32, judged against the same
blocks the run kept. The lower reading of a number is the largest the
program gives; the upper, the smallest the control gives (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from radiobench import manifest, run
    if not torch.cuda.is_available():
        print("radiobench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = manifest.cell(args.workload)
    print(f"card: {run.card()}", flush=True)
    readings = {"program": {}, "control": {}}
    for side, n, start in (("program", args.seeds, args.seed),
                           ("control", args.control_seeds,
                            args.seed + args.seeds)):
        for seed in range(start, start + n):
            res, _ = run.run_cell(cell, seed, args.seconds, False, device,
                                  time.perf_counter(),
                                  control=side == "control")
            vals = {k: v["value"] for k, v in res["checks"].items()}
            readings[side][seed] = vals
            print(json.dumps(dict(side=side, seed=seed, **vals)), flush=True)
    for side, by_seed in readings.items():
        names = next(iter(by_seed.values())).keys() if by_seed else ()
        agg = max if side == "program" else min
        print(json.dumps({side: {k: agg(v[k] for v in by_seed.values())
                                 for k in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
