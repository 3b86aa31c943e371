#!/usr/bin/env python3
"""The served path's time split on the card, read from the port's spans.

    python3 tools/trace_split.py split CELL SEED [SEED ...] [--seconds S]
    python3 tools/trace_split.py cost CELL SEED [SEED ...] [--seconds S]
    python3 tools/trace_split.py toggle CELL SEED [--blocks N --every K]

All run on CUDA device 0 in this process and print JSON lines.

``split``: traced runs, as ``python3 -m radiobench.run --trace 1`` makes
them (the profiler over the window's last 2 s arms the port's tracer).
Each line holds the run's per-layer metrics and ``correct``; the mean,
median and largest host ms a block of every span name (``span_ms``);
how much of a parent span its children cover (``coverage``); the share
of the program's ``executor.dispatch`` and ``executor.fetch`` spans that
lie inside the benchmark's own spans around the same calls
(``inside_bench``); the idle gaps labelled by the program spans open at
their middle (``idle_by_span``); for each ``fetch.copy``, the wait from
its start to the first device-to-host copy inside it, the device's busy
time in that wait (other steps' work queued before the copy) and the
copies' own device time (``fetch_copy``, ms a block); how many
``block.*`` ranges the profiler's exported trace holds
(``block_ranges_in_trace``); the CUDA API calls, kernel launches and
device ms a block of each ``block.*`` and each part of ``dispatch`` and
``fetch`` (``per_leaf``); for each kernel that holds a tenth of the busy
time, the mean number of its launches running at once over their union
(``kernels_at_once``: 1 where they run one after another); and the mean
of ``dispatch.graph``'s ``n``, the other executors' steps pending as a
step launches (``graph_beside``). Run one seed a process: a second
profiler session in one process can lose its kernels.

``cost``: untraced runs in pairs, one with the tracer enabled for the
whole window and one without, alternating which goes first (one pair a
seed), after a first run marked ``warmup``; each line gives
``replay_msps``, the spans recorded a block, the window's garbage
collections (count, of generation 2, seconds), the run's minor page
faults, and the tracer's own cost a span from a loop of begin/end pairs.

``toggle``: the tracer's cost with less noise: see :func:`toggle`.
"""

from __future__ import annotations

import argparse
import bisect
import json
import resource
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHILDREN = {
    "executor.dispatch": ("dispatch.params", "dispatch.stage",
                          "dispatch.upload", "dispatch.meta",
                          "dispatch.graph"),
    "executor.fetch": ("fetch.wait", "fetch.copy"),
    "dispatch.graph": "block.",
}


def _sum(spans, pred) -> float:
    return sum(s.t1 - s.t0 for s in spans if pred(s))


def coverage(spans) -> dict:
    """Time in a parent's children over the parent's own time."""
    out = {}
    for parent, kids in CHILDREN.items():
        whole = _sum(spans, lambda s: s.name == parent)
        if isinstance(kids, str):
            part = _sum(spans, lambda s: s.parent == parent
                        and s.name.startswith(kids))
        else:
            part = _sum(spans, lambda s: s.parent == parent
                        and s.name in kids)
        out[parent] = part / whole if whole else None
    return out


def span_ms(spans) -> dict:
    """Host ms a block of each span name: mean, median and largest."""
    per = {}
    for s in spans:
        if s.seq < 0:
            continue
        d = per.setdefault(s.name, {})
        d[(s.stream, s.seq)] = d.get((s.stream, s.seq), 0.0) + s.t1 - s.t0
    return {name: [1e3 * statistics.mean(d.values()),
                   1e3 * statistics.median(d.values()),
                   1e3 * max(d.values())] for name, d in per.items()}


def inside_bench(spans, rec, name, bench_name) -> float:
    outer = sorted((s[3], s[4]) for s in rec.spans if s[0] == bench_name)
    starts = [o[0] for o in outer]
    mine = [s for s in spans if s.name == name]
    ok = 0
    for s in mine:
        i = bisect.bisect_right(starts, s.t0) - 1
        ok += i >= 0 and outer[i][0] <= s.t0 and s.t1 <= outer[i][1]
    return ok / len(mine) if mine else None


def fetch_copy(spans, tr) -> dict:
    """ms a block: from ``fetch.copy``'s start to its first device-to-host
    copy, the device busy in that wait, and the copies' device time."""
    from radiobench import spans as host
    dev = sorted((s, e, n) for n, c, s, e in tr.events)
    starts = [d[0] for d in dev]
    wait, busy, copy, n = 0.0, 0.0, 0.0, 0
    for s in spans:
        if s.name != "fetch.copy" or s.t1 > tr.end:
            continue
        lo = bisect.bisect_left(starts, s.t0)
        hi = bisect.bisect_right(starts, s.t1)
        d2h = [d for d in dev[lo:hi] if "DtoH" in d[2]]
        if not d2h:
            continue
        first = d2h[0][0]
        wait += first - s.t0
        before = dev[bisect.bisect_left(starts, s.t0 - 0.05):  # none longer
                     bisect.bisect_left(starts, first)]
        busy += host.covered(host.clip([(a, b) for a, b, _ in before],
                                       s.t0, first))
        copy += sum(b - a for a, b, _ in d2h)
        n += 1
    return dict(blocks=n, wait_ms=1e3 * wait / n, busy_in_wait_ms=1e3 * busy
                / n, d2h_ms=1e3 * copy / n) if n else {}


LEAVES = ("dispatch.params", "dispatch.stage", "dispatch.upload",
          "dispatch.meta", "fetch.wait", "fetch.copy")


def per_leaf(events, marks, mine, blocks) -> dict:
    """Each CUDA API call of the exported trace, by the innermost span open
    on the host at its start (a ``block.*`` or a part of ``dispatch`` or
    ``fetch``; ``other`` for none), and each device event, by the span of
    the call that launched it (the profiler's correlation ids): API calls,
    kernel launches and device ms a block. The trace's clock is mapped onto
    the host's by the window's two markers (``marks``: their host times),
    so that a drift between the two clocks over the window does not move a
    call into a neighbouring span."""
    from radiobench import spans as host
    ts = {e["name"]: (e["ts"] + 0.5 * e.get("dur", 0.0)) * 1e-6
          for e in events
          if e.get("name") in (host.Profile.START, host.Profile.END)}
    t_a, t_b = ts[host.Profile.START], ts[host.Profile.END]
    h_a, h_b = marks[host.Profile.START], marks[host.Profile.END]
    rate = (h_b - h_a) / (t_b - t_a)
    leaves = sorted((s.t0, s.t1, s.name) for s in mine
                    if s.name in LEAVES or s.name.startswith("block."))
    t0s = [x[0] for x in leaves]

    def label(ts):
        t = h_a + (ts * 1e-6 - t_a) * rate
        i = bisect.bisect_right(t0s, t) - 1
        return leaves[i][2] if i >= 0 and t < leaves[i][1] else "other"

    out, by_corr = {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
            continue
        name = label(e["ts"])
        d = out.setdefault(name, dict(api=0, launches=0, device_ms=0.0))
        d["api"] += 1
        d["launches"] += "LaunchKernel" in e["name"]
        by_corr[e.get("args", {}).get("correlation")] = name
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in host.DEVICE_CATS:
            name = by_corr.get(e.get("args", {}).get("correlation"), "other")
            d = out.setdefault(name, dict(api=0, launches=0, device_ms=0.0))
            d["device_ms"] += 1e-3 * e.get("dur", 0.0)
    return {k: {f: v / blocks for f, v in d.items()}
            for k, d in sorted(out.items())}


def at_once(tr, share=0.1) -> dict:
    """Mean launches of a kernel running at once over their union, for
    the kernels that hold ``share`` of the trace's busy time or more."""
    from radiobench import spans as host
    by = {}
    for n, c, s, e in tr.events:
        if c == "kernel":
            by.setdefault(n, []).append((s, e))
    busy = tr.busy_s
    return {n: sum(e - s for s, e in iv) / host.covered(iv)
            for n, iv in by.items()
            if busy and sum(e - s for s, e in iv) >= share * busy}


def _device():
    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_split: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def split(cell_name, seeds, seconds):
    from grbaz_tpu_torch.core import trace
    from radiobench import manifest, run, spans

    dev = _device()
    cell = manifest.cell(cell_name)
    got = {}
    real_read, real_recorder = spans.Profile.read, spans.Recorder

    def read(self):
        got["trace"] = real_read(self)
        got["marks"] = dict(self.marks)
        return got["trace"]

    class Recorder(real_recorder):
        def __init__(self):
            super().__init__()
            got["rec"] = self

    def from_events(events, host_start):
        got["events"] = events
        return real_from(events, host_start)

    real_from = spans.trace_from_events
    spans.Profile.read, spans.Recorder = read, Recorder
    spans.trace_from_events = from_events
    for seed in seeds:
        trace.clear()
        result, info = run.run_cell(cell, seed, seconds, True, dev,
                                    time.perf_counter())
        tr = got["trace"]
        mine = trace.spans(tr.start, tr.end)
        host = [(s.name, s.t0, s.t1) for s in mine]
        gaps = spans.gaps([(s, e) for _, _, s, e in tr.events], tr.start,
                          tr.end)
        print(json.dumps(dict(
            cell=cell_name, seed=seed, correct=result["correct"],
            metrics={k: v["value"] for k, v in result["metrics"].items()},
            window_s=tr.window_s, busy_s=tr.busy_s,
            spans=len(mine), span_ms=span_ms(mine),
            coverage=coverage(mine),
            inside_bench={n: inside_bench(mine, got["rec"], n, b) for n, b in
                          (("executor.dispatch", "dispatch"),
                           ("executor.fetch", "fetch"))},
            idle_by_span=spans.label_gaps(gaps, host, top=12),
            fetch_copy=fetch_copy(mine, tr),
            block_ranges_in_trace=sum(
                str(e.get("name", "")).startswith("block.")
                for e in got["events"]),
            per_leaf=per_leaf(got["events"], got["marks"], mine, sum(
                s.name == "executor.dispatch" for s in mine)),
            kernels_at_once=at_once(tr),
            graph_beside=statistics.mean(
                [s.n for s in mine if s.name == "dispatch.graph"
                 and s.n is not None] or [0]))), flush=True)


def span_cost_us(n=100000) -> float:
    from grbaz_tpu_torch.core import trace
    trace.enable()
    t = time.perf_counter()
    for _ in range(n):
        trace.end(trace.begin("cost"))
    us = 1e6 * (time.perf_counter() - t) / n
    trace.disable()
    trace.clear()
    return us


def cost(cell_name, seeds, seconds):
    from grbaz_tpu_torch.core import trace
    from radiobench import manifest, run

    dev = _device()
    cell = manifest.cell(cell_name)
    block = manifest.traffic(cell["traffic"])["block"]
    runs = [(seeds[0], False, True)]  # a process's first window runs slow
    for k, seed in enumerate(seeds):
        runs += [(seed, on, False) for on in ((True, False) if k % 2 == 0
                                              else (False, True))]
    for seed, on, warmup in runs:
        trace.clear()
        if on:
            trace.enable()
        try:
            faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
            result, info = run.run_cell(cell, seed, seconds, False, dev,
                                        time.perf_counter())
            faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt \
                - faults
        finally:
            trace.disable()
        got = trace.spans()
        blocks = sum(s.name == "executor.dispatch" for s in got)
        pauses = info["gc_pauses"]
        line = dict(cell=cell_name, seed=seed, traced=on, warmup=warmup,
                    correct=result["correct"],
                    replay_msps=result["metrics"]["replay_msps"]["value"],
                    spans_a_block=len(got) / blocks if blocks else 0.0,
                    gc=[len(pauses), sum(g == 2 for g, _ in pauses),
                        sum(d for _, d in pauses)],
                    minor_faults=faults)
        line["us_a_block"] = block / line["replay_msps"]
        del got
        trace.clear()
        line["span_us"] = span_cost_us()
        print(json.dumps(line), flush=True)
    trace.clear()


def _pump_run(ex, prog, cfg, ring, n, on_block):
    """``n`` ring blocks through a closed-loop pump; ``on_block(j)`` as
    block j's last output reaches its sink."""
    import gc

    from grbaz_tpu_torch.core.pump import StreamPump
    left, done = [n], [0]

    def src():
        if left[0] <= 0:
            return None
        left[0] -= 1
        return {"iq": ring[left[0] % len(ring)]}

    def last(data, count):
        done[0] += 1
        on_block(done[0])
    sinks = {p: (lambda data, count: None) for p in prog.PORTS[:-1]}
    sinks[prog.PORTS[-1]] = last
    pump = StreamPump(ex, src, sinks, **cfg["pump"])
    gc.collect()
    pump.start()
    while done[0] < n:
        time.sleep(0.002)
    pump.stop()


def toggle(cell_name, seed, blocks, every, skip=5):
    """One closed-loop pump run with the tracer switched on and off every
    ``every`` blocks, so that the host's drifting pace cancels: the
    change in ms a block of each switched stretch against the one before
    it (the first ``skip`` blocks of a stretch left out), then the
    tracer's own time a block, from timed begin/end/add."""
    from grbaz_tpu_torch.core import trace
    from radiobench import manifest

    dev = _device()
    cell = manifest.cell(cell_name)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    prog = manifest.program(cell["config"])
    ring = prog.ring(cfg, 1, traffic["ring"], traffic["block"], seed, dev)[0]
    ex = prog.executor(cfg, traffic["block"], dev)
    for i in range(3):
        ex.step({"iq": ring[i]})
    stamps = []

    def switch(j):
        stamps.append((time.perf_counter(), trace._enabled))
        if j % every == 0:
            (trace.disable if trace._enabled else trace.enable)()
            trace.clear()
    _pump_run(ex, prog, cfg, ring, blocks, switch)
    trace.disable()
    stretches = []
    for k in range(0, len(stamps) - every, every):
        part = stamps[k + skip:k + every + 1]
        dt = [b[0] - a[0] for a, b in zip(part, part[1:])]
        stretches.append((part[-1][1], statistics.mean(dt)))
    change = [(a if on else b) / (b if on else a) - 1
              for (on, a), (_, b) in zip(stretches, stretches[1:])]
    q = statistics.quantiles(change, n=4)
    line = dict(cell=cell_name, seed=seed, blocks=blocks, every=every,
                on_ms=1e3 * statistics.median(
                    [v for on, v in stretches if on]),
                off_ms=1e3 * statistics.median(
                    [v for on, v in stretches if not on]),
                change_pct=[100 * q[0], 100 * statistics.median(change),
                            100 * q[2]],
                on_slower_share=sum(c > 0 for c in change) / len(change))

    spent = [0.0, 0]
    real = (trace.begin, trace.end, trace.add)

    def timed(fn):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            spent[0] += time.perf_counter() - t
            spent[1] += 1
            return out
        return call
    trace.clear()
    trace.begin, trace.end, trace.add = map(timed, real)
    trace.enable()
    try:
        _pump_run(ex, prog, cfg, ring, blocks // 4, lambda j: None)
    finally:
        trace.disable()
        trace.begin, trace.end, trace.add = real
    n = blocks // 4
    line.update(tracer_us_a_block=1e6 * spent[0] / n,
                calls_a_block=spent[1] / n,
                spans_a_block=len(trace.spans()) / n)
    trace.clear()
    print(json.dumps(line), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("split", "cost", "toggle"))
    ap.add_argument("cell")
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--blocks", type=int, default=3000)
    ap.add_argument("--every", type=int, default=20)
    args = ap.parse_args(argv)
    if args.mode == "toggle":
        toggle(args.cell, args.seeds[0], args.blocks, args.every)
    else:
        (split if args.mode == "split" else cost)(args.cell, args.seeds,
                                                  args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
