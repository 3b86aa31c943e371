"""The traffic generator every cell uses, driven by ``traffic/<mix>.json``.

Keys of a mix:

* ``loop``: ``"closed"`` (a capture replayed as fast as the served path
  takes it: the source hands out the next block whenever the pump asks)
  or ``"open"`` (live dongles: block j of stream k is due when its last
  sample comes off the dongle, ``t0 + k P / streams + (j + 1) P`` with
  ``P = block / rate_sps``; the schedule never waits for the port);
* ``streams``: independent streams, each with its own executor and pump;
* ``block``: samples a block; ``ring``: distinct seeded blocks a stream
  cycles through; ``rate_sps``: a live stream's sample rate;
* ``warmup_blocks``: steps each executor takes before the window;
* ``checks``: blocks a stream keeps, drawn from the seed, beside its
  first and its last, for the comparison with the reference.

A source returns a block only while the window is open (open loop:
every block due by the close, however late the pump asks), and the
sinks stamp each block's delivery, when its last port arrives.
"""

from __future__ import annotations

import math
import time

import numpy as np


class Generator:
    def __init__(self, traffic: dict, ring: np.ndarray,
                 clock=time.perf_counter):
        self.open = traffic["loop"] == "open"
        if traffic["loop"] not in ("open", "closed"):
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        self.ring = ring
        self.streams = ring.shape[0]
        self.period = (traffic["block"] / traffic["rate_sps"]
                       if self.open else 0.0)
        self.offsets = [k * self.period / self.streams
                        for k in range(self.streams)]
        self.clock = clock
        self.t0 = None
        self.t_close = math.inf
        self.taken = [[] for _ in range(self.streams)]

    def start(self, t0: float):
        self.t0 = t0

    def close(self, t_close: float):
        self.t_close = t_close

    def due(self, k: int, j: int) -> float:
        """When block j of stream k is due (open loop)."""
        return self.t0 + self.offsets[k] + (j + 1) * self.period

    def owed(self, k: int) -> int:
        """Blocks stream k owes by the close: due by then (open loop) or
        handed out before it (closed loop)."""
        if not self.open:
            return len(self.taken[k])
        return max(0, math.floor((self.t_close - self.t0 - self.offsets[k])
                                 / self.period + 1e-12))

    def due_times(self, k: int) -> list:
        if not self.open:
            return list(self.taken[k])
        return [self.due(k, j) for j in range(self.owed(k))]

    def source(self, k: int, recorder=None):
        taken, blocks = self.taken[k], self.ring[k]

        def src():
            j = len(taken)
            if self.open:
                due = self.due(k, j)
                if due > self.t_close or self.clock() < due:
                    return None
            elif self.clock() >= self.t_close:
                return None
            t = self.clock()
            taken.append(t)
            if recorder is not None:
                recorder.add("source", k, j, t, self.clock())
            return {"iq": blocks[j % len(blocks)]}
        return src


class Collector:
    """The sinks of one stream: stamps each block's delivery and keeps
    the outputs of block 0, the last block and a reservoir sample of
    ``checks`` others, drawn from the seed."""

    def __init__(self, ports, checks: int, seed: int, k: int,
                 clock=time.perf_counter):
        self.ports = tuple(ports)
        self.checks = int(checks)
        self.rng = np.random.default_rng([int(seed) % (1 << 63), k, 3])
        self.clock = clock
        self.delivered = []
        self.cur = {}
        self.kept = {}
        self.reservoir = []
        self.last = None

    def sinks(self, recorder=None, k: int = 0) -> dict:
        def make(port):
            def sink(data, count):
                t = self.clock()
                self.cur[port] = (data, count)
                if port == self.ports[-1]:
                    self._complete()
                if recorder is not None:
                    recorder.add("sink", k, len(self.delivered), t,
                                 self.clock())
            return sink
        return {p: make(p) for p in self.ports}

    def _complete(self):
        j = len(self.delivered)
        self.delivered.append(self.clock())
        outs, self.cur = self.cur, {}
        self.last = (j, outs)
        if j == 0:
            self.kept[0] = outs
            return
        i = j - 1  # reservoir sampling (algorithm R) over blocks 1..
        if i < self.checks:
            self.reservoir.append((j, outs))
        else:
            r = int(self.rng.integers(0, i + 1))
            if r < self.checks:
                self.reservoir[r] = (j, outs)

    def blocks(self) -> dict:
        """{block index: outputs} of every kept block."""
        out = dict(self.kept)
        out.update(dict(self.reservoir))
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return dict(sorted(out.items()))


def latencies(due: list, delivered: list) -> list:
    """Seconds from each owed block's due time to its delivery, block by
    block; blocks never delivered have none (they count as failed)."""
    return [g - d for d, g in zip(due, delivered)]


def backlog(due: list, delivered: list, t: float) -> int:
    """Blocks due by ``t`` and not delivered by then."""
    return sum(d <= t for d in due) - sum(g <= t for g in delivered)
