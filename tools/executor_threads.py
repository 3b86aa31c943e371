#!/usr/bin/env python3
"""Steps a second of the lrpt cell's eight executors driven by host threads.

    python3 tools/executor_threads.py [--seconds S]

Eight ``StreamExecutor``s of the lrpt graph (``radiobench/configs/lrpt``,
2^16 QPSK symbols a block) on CUDA device 0, split among T threads, each
thread taking its executors in turn and keeping three steps in flight on
each before it fetches the oldest (as a pump's runner does). T runs 1, 2,
4 and 8, then 8 again beside 8 threads that wake every 2 ms (as the
pump's feeders do on a full queue). One line a run: the threads, the
steps a second and the symbols a second.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N = 1 << 16
EXECUTORS = 8
DEPTH = 3


def drive(exs, feeds, stop, done):
    pend = [[] for _ in exs]
    j = 0
    while not stop.is_set():
        for k, ex in enumerate(exs):
            if len(pend[k]) == DEPTH:
                ex.fetch(pend[k].pop(0))
                done[0] += 1
            pend[k].append(ex.dispatch({"iq": feeds[k][j % len(feeds[k])]}))
        j += 1
    for ex, p in zip(exs, pend):
        for o in p:
            ex.fetch(o)


def wake(stop):
    while not stop.is_set():
        time.sleep(0.002)


def run(cfg, host, dev, threads, wakers, seconds):
    from radiobench.configs import lrpt
    exs = [lrpt.executor(cfg, N, dev) for _ in range(EXECUTORS)]
    for k, ex in enumerate(exs):
        ex.step({"iq": host[k][0]})
        ex.reset()
    stop = threading.Event()
    done = [[0] for _ in range(threads)]
    ts = [threading.Thread(target=drive, args=(
        exs[t::threads], host[t::threads], stop, done[t]))
        for t in range(threads)]
    ts += [threading.Thread(target=wake, args=(stop,)) for _ in range(wakers)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(seconds)
    steps, el = sum(d[0] for d in done), time.perf_counter() - t0
    stop.set()
    for t in ts:
        t.join()
    print(f"threads {threads} wakers {wakers}: {steps / el:.1f} steps/s, "
          f"{steps * N / el / 1e6:.2f} Msym/s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from radiobench import manifest
    from radiobench.configs import lrpt
    if not torch.cuda.is_available():
        sys.exit("executor_threads: needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = manifest.config("lrpt")
    _, sym, _ = lrpt.passes(cfg, EXECUTORS, 4 * N, 5, dev)
    host = list(sym.cpu().numpy().reshape(EXECUTORS, 4, N))
    for threads, wakers in ((1, 0), (2, 0), (4, 0), (8, 0), (8, 8)):
        run(cfg, host, dev, threads, wakers, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
