"""The pump's feeder stages each block into host memory of the executor's
own (on the card a pinned slot of a ring), so a source may overwrite its
one buffer as soon as its call returns, and a slot is written again only
once the upload that last read it has finished. Many more blocks than
slots run through a pump with a slow sink and, on the card, steps that
hold the card ~20 ms each (their uploads queue behind them); the outputs
equal ``ex.step`` over copies of the blocks the executor was handed, in
order. In ``drop`` mode the feeder runs on through the ring while the
uploads of dispatched blocks still wait on the card (with shorter steps,
~4 ms against a block every 0.5 ms, no slot was found still waiting),
so there a slot written before its upload has finished shows.

This file imports neither JAX nor ``grbaz_tpu``, so run it on the card
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_pump_slots.py
"""

import time

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core.block import FnBlock
from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.pump import StreamPump

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
BLOCKS = 128
SLEEP_CYCLES = 40_000_000  # ~20 ms of card time a step
PACE_S = 0.001  # between the source's blocks: ~20 a step
MODES = dict(blocking=dict(depth=2, inflight=3),
             drop=dict(depth=1, inflight=3, drop=True))


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device(name)


def _executor(dev, n):
    """``y = 2 x + 1``, each step first holding the card ~20 ms."""
    def slow(x):
        if x.is_cuda:
            torch.cuda._sleep(SLEEP_CYCLES)
        return x * 2 + 1
    fg = Flowgraph("slow")
    blk = FnBlock(slow, name="slow")
    fg.input("x", blk)
    fg.output("y", blk)
    return StreamExecutor(fg, {"x": InputSpec((n,), "float32")}, device=dev)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("device", DEVICES)
def test_reused_slots_and_source_buffer_give_each_blocks_outputs(device,
                                                                 mode):
    dev = _device(device)
    n = 1 << 16 if dev.type == "cuda" else 1 << 10
    rng = np.random.default_rng(17)
    blocks = [rng.standard_normal(n).astype(np.float32)
              for _ in range(BLOCKS)]
    buf, last = np.empty(n, np.float32), [-1]

    def source():  # one buffer of its own, written again on every call
        j = last[0] + 1
        if j == BLOCKS:
            return None
        time.sleep(PACE_S)  # the feeder cycles the ring over many steps
        buf[...] = np.nan
        buf[...] = blocks[j]
        last[0] = j
        return {"x": buf}

    ex = _executor(dev, n)
    ex.step({"x": blocks[0]})  # warm-up
    ex.reset()
    index, order, slots = {}, [], []
    stage, dispatch = ex.stage, ex.dispatch

    def staged(ins, counts=None, **kw):
        s = stage(ins, counts, **kw)
        index[id(s)] = last[0]
        return s

    def dispatched(s, *a, **kw):
        order.append(index.pop(id(s)))
        step = dispatch(s, *a, **kw)
        slots.append(step.staged.slots["x"])
        return step
    ex.stage, ex.dispatch = staged, dispatched

    got = []

    def sink(data, count):  # slow: the queue fills behind it
        got.append(data[:count].copy())
        time.sleep(0.002)
    pump = StreamPump(ex, source, {"y": sink}, **MODES[mode])
    pump.start()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        st = pump.stats()
        if st["blocks_out"] + st["overruns"] == BLOCKS:
            break
        time.sleep(0.005)
    pump.stop()
    st = pump.stats()
    assert st["blocks_in"] == BLOCKS == st["blocks_out"] + st["overruns"]
    assert st["staged"] == st["blocks_out"] == len(order) == len(got)
    if mode == "blocking":
        assert order == list(range(BLOCKS))
    else:
        assert order == sorted(set(order)) and len(order) >= 8
    if dev.type == "cuda":  # the ring the pump asked for, never outgrown
        cfg = MODES[mode]
        ring = cfg["depth"] + cfg["inflight"] + 1
        assert len(ex._slots["x"].bufs) == ring
        assert set(slots) <= set(range(ring)) and len(set(slots)) > 2
    else:
        assert set(slots) == {None}
    ref = _executor(dev, n)
    for k, (j, y) in enumerate(zip(order, got)):
        (want, count), = ref.step({"x": blocks[j].copy()}).values()
        assert count == n
        assert np.array_equal(y, want[:count]), (k, j)
