"""The generator's schedule, its reservoir of kept blocks, and seed
determinism of the inputs."""

import numpy as np
import pytest
import torch

from radiobench import generator, manifest


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


LIVE = dict(loop="open", streams=4, block=1000, rate_sps=1e5, ring=2,
            warmup_blocks=0, checks=2)


def ring(streams=4):
    return np.arange(streams * 2 * 1000).astype(np.complex64).reshape(
        streams, 2, 1000)


def test_open_loop_schedule_is_staggered_and_never_waits():
    clock = Clock()
    gen = generator.Generator(LIVE, ring(), clock)
    gen.start(100.0)
    period = 0.01
    assert gen.due(0, 0) == pytest.approx(100.0 + period)
    assert gen.due(2, 0) == pytest.approx(100.0 + period + period / 2)
    assert gen.due(1, 5) == pytest.approx(100.0 + period / 4 + 6 * period)
    src = gen.source(0)
    clock.t = 100.0 + period - 1e-6
    assert src() is None                    # not due yet
    clock.t = 100.0 + 3.5 * period           # three blocks due: all handed
    blocks = [src(), src(), src(), src()]
    assert blocks[3] is None
    assert [b["iq"][0] for b in blocks[:3]] == [0, 1000, 0]
    gen.close(100.0 + 10 * period)
    assert gen.owed(0) == 10 and gen.owed(3) == 9
    clock.t = 200.0                          # after the close: the backlog
    got = [src() for _ in range(10)]
    assert sum(b is not None for b in got) == 7
    assert len(gen.due_times(0)) == 10


def test_closed_loop_hands_out_until_the_close():
    clock = Clock(5.0)
    gen = generator.Generator(dict(LIVE, loop="closed", streams=1),
                              ring(1), clock)
    gen.start(5.0)
    src = gen.source(0)
    assert all(src() is not None for _ in range(5))
    gen.close(6.0)
    clock.t = 6.0
    assert src() is None
    assert gen.owed(0) == 5 and gen.due_times(0) == [5.0] * 5


def test_reservoir_keeps_first_last_and_a_seeded_sample():
    def kept(seed, n=200):
        col = generator.Collector(("a", "b"), 3, seed, 0, Clock())
        s = col.sinks()
        for j in range(n):
            s["a"](np.array([j]), 1)
            s["b"](np.array([-j]), 1)
        return col
    c1, c2, c3 = kept(11), kept(11), kept(12)
    b1 = c1.blocks()
    assert len(c1.delivered) == 200
    assert 0 in b1 and 199 in b1 and len(b1) == 5
    assert all(int(v["a"][0][0]) == j and int(v["b"][0][0]) == -j
               for j, v in b1.items())
    assert list(b1) == list(c2.blocks())
    assert list(b1) != list(c3.blocks())


@pytest.mark.parametrize("config", ["rtl_fm", "scanner"])
def test_inputs_follow_the_seed(config):
    cfg, prog = manifest.config(config), manifest.program(config)
    dev = torch.device("cpu")
    a = prog.ring(cfg, 2, 2, 512, 2 ** 31 + 12345, dev)
    b = prog.ring(cfg, 2, 2, 512, 2 ** 31 + 12345, dev)
    c = prog.ring(cfg, 2, 2, 512, 2 ** 31 + 12346, dev)
    assert a.shape == (2, 2, 512) and a.dtype == np.complex64
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])      # streams are independent


def test_latency_and_backlog_arithmetic():
    due = [1.0, 2.0, 3.0, 4.0]
    got = [1.5, 2.25, 5.0]              # the last block never came
    assert generator.latencies(due, got) == [0.5, 0.25, 2.0]
    assert generator.backlog(due, got, 0.5) == 0
    assert generator.backlog(due, got, 1.2) == 1
    assert generator.backlog(due, got, 3.5) == 1
    assert generator.backlog(due, got, 9.0) == 1
