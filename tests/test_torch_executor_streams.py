"""``StreamExecutor``'s compute stream: the lrpt cell's eight passes, an
executor each, dispatched in turn three deep, give every output (path
metrics, bits, BER, search state and their counts) bit-equal to each
pass run alone, also after a reset right before the first dispatch. On
the card (cases marked ``cuda``, at the cell's 2^16 symbols a block) the
executors' steps run on eight compute streams side by side; on the CPU
the same schedule runs at 2^10 symbols a block. A card-only case holds
the first step after work still queued on the caller's stream.

This file imports neither JAX nor ``grbaz_tpu``, so run it on the card
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_executor_streams.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import LRPT_DEPTH, interleaved
from grbaz_tpu_torch.core.block import FnBlock
from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.graph import Flowgraph
from radiobench import manifest
from radiobench.configs import lrpt

CFG = manifest.config("lrpt")
STREAMS = 8
BLOCKS = 5
SEED = 2 ** 31 + 241
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device(name)


def _feeds(dev):
    """(symbols a block, each pass's host blocks): the cell's passes
    (``lrpt.passes``, a channel each from the seed)."""
    n = 1 << 16 if dev.type == "cuda" else 1 << 10
    _, sym, _ = lrpt.passes(CFG, STREAMS, BLOCKS * n, SEED, torch.device(
        "cpu"))
    host = sym.numpy().reshape(STREAMS, BLOCKS, n)
    return n, [[np.ascontiguousarray(b) for b in p] for p in host]


def _executors(dev, n):
    return [lrpt.executor(CFG, n, dev) for _ in range(STREAMS)]


def _alone(dev, n, feeds):
    return [[ex.step({"iq": x}) for x in feed]
            for ex, feed in zip(_executors(dev, n), feeds)]


def _bit_equal(got, want):
    for port in lrpt.PORTS:
        (g, gc), (w, wc) = got[port], want[port]
        if gc != wc or g.dtype != w.dtype or \
                g[:gc].tobytes() != w[:wc].tobytes():
            return False
    return True


@pytest.mark.parametrize("device", DEVICES)
def test_interleaved_passes_match_each_alone(device):
    dev = _device(device)
    n, feeds = _feeds(dev)
    want = _alone(dev, n, feeds)
    got = interleaved(_executors(dev, n), feeds, LRPT_DEPTH)
    for k in range(STREAMS):
        assert len(got[k]) == BLOCKS
        for j in range(BLOCKS):
            assert _bit_equal(got[k][j], want[k][j]), (k, j)
    # the passes differ, so a mix-up between executors would show
    assert len({got[k][-1]["bits"][0].tobytes()
                for k in range(STREAMS)}) == STREAMS


@pytest.mark.parametrize("device", DEVICES)
def test_reset_right_before_the_first_interleaved_dispatch(device):
    """Warmed executors (a step each, as the benchmark warms them), reset
    just before the run: the first block as from fresh executors."""
    dev = _device(device)
    n, feeds = _feeds(dev)
    want = _alone(dev, n, [f[:1] for f in feeds])
    exs = _executors(dev, n)
    for k, ex in enumerate(exs):
        ex.step({"iq": feeds[(k + 1) % STREAMS][1]})
    for ex in exs:
        ex.reset()
    got = interleaved(exs, [f[:LRPT_DEPTH] for f in feeds], LRPT_DEPTH)
    for k in range(STREAMS):
        assert _bit_equal(got[k][0], want[k][0]), k


@pytest.mark.cuda
def test_first_step_after_the_callers_queued_work():
    """A Block's constant filled on the caller's stream behind a long
    sleep, in memory that held -1 before, and the executor reset there:
    its next step, on its own compute stream, reads the filled value. A
    step first loads every kernel involved (a kernel's first launch may
    wait for the whole card)."""
    dev = _device("cuda")
    n = 1 << 12
    const = {"c": torch.full((n,), 0.0, device=dev)}
    fg = Flowgraph("plus")
    blk = FnBlock(lambda x: x + const["c"], name="plus")
    fg.input("x", blk)
    fg.output("y", blk)
    ex = StreamExecutor(fg, {"x": InputSpec((n,), "float32")}, device=dev)
    ones = np.ones(n, np.float32)
    torch.cuda._sleep(1)
    assert (ex.step({"x": ones})["y"][0] == 1.0).all()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        stale = torch.full((n,), -1.0, device=dev)
        del stale  # the constant below takes its memory back
        torch.cuda._sleep(200_000_000)
        const["c"] = torch.full((n,), 7.0, device=dev)
        ex.reset()
    (y, count), = ex.step({"x": ones}).values()
    assert count == n
    assert (y == 8.0).all()
