"""Run one cell of the port's benchmark once.

    python3 -m radiobench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's input ring from the seed, builds one
``StreamExecutor`` a stream (its kernels build into the port's
``_build/`` on a checkout's first run), warms each up and resets it.
Then every stream's ``StreamPump`` runs for ``--seconds`` under the
cell's traffic. Once the window has closed every block owed by then is
waited for (a minute at most), the peak memory read, the program freed,
and a sample of blocks drawn from the seed held to the plain reference.
The last line of standard output is one JSON object: the end-to-end
metrics (``--trace 0``) or the per-layer ones (``--trace 1``, with a
profiled part of the window), and, last, each number compared beside its
limit, also printed as the last lines of standard error.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the JAX stack and the JAX package: the harness runs the port alone
FORBIDDEN = ("jax", "jaxlib", "flax", "grbaz_tpu")
DRAIN_S = 60.0          # how long blocks owed at the close are waited for
PROFILE_S = 2.0         # the profiled end of a traced window, at most


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric reader reads (``metrics/<name>.py``):
    host spans of the window's part before the profiler starts (it slows
    the host), the device trace of the profiled part."""

    def __init__(self, cfg, traffic, recorder, t0, t_host, trace):
        self.cfg, self.traffic = cfg, traffic
        self._rec = recorder
        self.t0, self.t_host = t0, t_host
        self.trace = trace
        self.blocks_profiled = 0 if trace is None else len(
            recorder.of("dispatch", trace.start, trace.end))

    def spans(self, name: str) -> list:
        """Spans ``(name, stream, block, start, end)`` that start in the
        window before the profiler."""
        return self._rec.of(name, self.t0, self.t_host)

    def durations(self, name: str) -> list:
        return [s[4] - s[3] for s in self.spans(name)]


def _sleep_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


class GCPauses:
    """The interpreter's garbage collections while installed: ``(gen,
    seconds)`` each (they stop every thread of the program)."""

    def __init__(self):
        self.pauses, self._t = [], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def check_outputs(cell, cfg, traffic, ring, collectors, device,
                  undelivered: int, control: bool = False):
    """Every kept block against the plain reference: {number: {value,
    limit}}. With ``control`` the reference in TF32 stands in the
    program's place."""
    from radiobench import manifest
    ref = manifest.reference(cell["config"])
    per_block = []
    for k, col in enumerate(collectors):
        for j, outs in col.blocks().items():
            want = ref.outputs(cfg, ring[k], j, "f64", device)
            if control:
                outs = {p: (v, v.shape[-1]) for p, v in ref.outputs(
                    cfg, ring[k], j, "tf32", device).items()}
            per_block.append(ref.numbers(outs, want))
    values = {name: max((b[name] for b in per_block), default=0)
              for name in ref.LIMITS if name != "undelivered"}
    values["undelivered"] = undelivered
    return {name: {"value": _finite(values[name]),
                   "limit": ref.LIMITS[name]} for name in ref.LIMITS}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, traffic: dict = None, fault=None,
             control: bool = False, drain_s: float = DRAIN_S):
    """One run of ``cell``; returns (result, info). ``traffic`` replaces
    the cell's mix (the sweep's stream counts, the tests' small sizes);
    ``fault(executor)`` breaks the program underneath the timed path (the
    tests); ``control`` judges the reference in TF32 instead."""
    import torch

    from grbaz_tpu_torch.core.pump import StreamPump
    from radiobench import generator, manifest, spans

    cuda = device.type == "cuda"
    cfg = manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    prog = manifest.program(cell["config"])
    n_streams, block = traffic["streams"], traffic["block"]
    phases = dict(start=time.perf_counter())
    ring = prog.ring(cfg, n_streams, traffic["ring"], block, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["ring"] = time.perf_counter()
    exs = [prog.executor(cfg, block, device) for _ in range(n_streams)]
    phases["build"] = time.perf_counter()
    for k, ex in enumerate(exs):
        for i in range(traffic["warmup_blocks"]):
            ex.step({"iq": ring[k][i % traffic["ring"]]})
        ex.reset()
        if fault is not None:
            fault(ex)
    if trace and cuda:  # the profiler's first start initializes CUPTI
        warm = spans.Profile()
        warm.start()
        torch.ones(1, device=device).add_(1)
        warm.stop()
    gen = generator.Generator(traffic, ring)
    cols = [generator.Collector(prog.PORTS, traffic["checks"], seed, k)
            for k in range(n_streams)]
    rec = spans.Recorder() if trace else None
    pumps = []
    for k, ex in enumerate(exs):
        if rec is not None:
            spans.wrap_executor(ex, k, rec)
        pumps.append(StreamPump(ex, gen.source(k, rec),
                                cols[k].sinks(rec, k), **cfg["pump"]))
    gc.collect()  # set-up's garbage is collected before the window
    if cuda:
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    phases["warm"] = t0
    setup_s = t0 - t_start
    t_close = t0 + seconds
    t_host = t_close
    gen.start(t0)
    with GCPauses() as gc_pauses:
        for p in pumps:
            p.start()
        profile = None
        if trace and cuda:
            _sleep_until(t_close - min(PROFILE_S, 0.5 * seconds))
            profile = spans.Profile()
            t_host = time.perf_counter()
            profile.start()
        _sleep_until(t_close)
        gen.close(t_close)
    if profile is not None:
        profile.stop()
    deadline = t_close + drain_s
    while (any(len(c.delivered) < gen.owed(k) for k, c in enumerate(cols))
           and time.perf_counter() < deadline):
        time.sleep(0.005)
    for p in pumps:
        p.stop()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    # blocks owed by the close, their delivery, latency and the backlog
    owed = [gen.owed(k) for k in range(n_streams)]
    due = [gen.due_times(k) for k in range(n_streams)]
    got = [cols[k].delivered[:owed[k]] for k in range(n_streams)]
    attempted = sum(owed)
    failed = sum(o - len(g) for o, g in zip(owed, got))
    lat = [x for k in range(n_streams)
           for x in generator.latencies(due[k], got[k])]
    in_window = sum(1 for g in got for t in g if t <= t_close)

    def backlog(t):
        return sum(generator.backlog(due[k], got[k], t)
                   for k in range(n_streams))

    info = dict(setup_s=setup_s, attempted=attempted, failed=failed,
                phases=dict(init=phases["start"] - t_start, **{
                    k: phases[k] - phases[p] for p, k in (
                        ("start", "ring"), ("ring", "build"),
                        ("build", "warm"))}),
                blocks_in_window=in_window, gc_pauses=gc_pauses.pauses,
                backlog_mid=backlog(t0 + 0.5 * seconds),
                backlog_end=backlog(t_close), latencies=lat)
    values = dict(
        setup_s=setup_s,
        replay_msps=in_window * block / seconds / 1e6,
        latency_p50_ms=1e3 * spans.percentile(lat, 50) if lat else None,
        latency_p95_ms=1e3 * spans.percentile(lat, 95) if lat else None)
    if trace:
        tr = profile.read() if profile is not None else None
        ctx = Context(cfg, traffic, rec, t0, t_host, tr)
        metrics = {}
        for m in manifest.per_layer(cell["name"]):
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(cell["name"])
                   if values.get(m["name"]) is not None}
    device_info = dict(platform="gpu" if cuda else "cpu", kind=kind,
                       count=1, memory_peak_bytes=int(mem_peak))
    breakdown = None
    if trace and profile is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        host = [(s[0], s[3], s[4]) for s in rec.spans]
        breakdown = dict(device_ops=tr.top_ops(),
                         idle_gaps=spans.label_gaps(
                             spans.gaps([(s, e) for _, _, s, e in tr.events],
                                        tr.start, tr.end), host))

    del pumps, exs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check_outputs(cell, cfg, traffic, ring, cols, device, failed,
                           control)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from radiobench import manifest
    cell = manifest.cell(args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"radiobench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, _T_START)
    found = forbidden_modules()
    if found:
        print(f"radiobench: the run loaded {', '.join(found)}; the "
              f"benchmark runs the port alone", file=sys.stderr)
        return 3
    lat = info["latencies"]
    print(f"radiobench: {args.workload} seed {args.seed} on {card()}, torch "
          f"{torch.__version__}: setup {info['setup_s']:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in info["phases"].items())
          + f"), attempted "
          f"{info['attempted']}, failed {info['failed']}, delivered in the "
          f"window {info['blocks_in_window']}, backlog mid "
          f"{info['backlog_mid']} end {info['backlog_end']}, collections "
          f"{len(info['gc_pauses'])} (longest "
          f"{1e3 * max((d for _, d in info['gc_pauses']), default=0):.1f} "
          f"ms, generation 2: {sum(g == 2 for g, _ in info['gc_pauses'])})"
          + (f", latency p50 {1e3 * sorted(lat)[len(lat) // 2]:.3f} ms max "
             f"{1e3 * max(lat):.3f} ms" if lat else ""), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
