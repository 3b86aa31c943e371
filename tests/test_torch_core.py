"""Port spine (stream, block, graph) == grbaz_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import block as jblock
from grbaz_tpu.core import graph as jgraph
from grbaz_tpu.core import stream as jstream
from grbaz_tpu_torch.core import block as tblock
from grbaz_tpu_torch.core import graph as tgraph
from grbaz_tpu_torch.core import stream as tstream

CPU = "cpu"


@pytest.mark.parametrize("abs_index", [0, 2 ** 32 - 5, 2 ** 64 - 3])
def test_meta_advance_carries_like_jax(abs_index):
    jm = jstream.StreamMeta.start(48e3, abs_index=abs_index)
    tm = tstream.StreamMeta.start(48e3, abs_index=abs_index, device=CPU)
    for n in (7, 2 ** 31, 3):
        jm = jm.advanced(n, rate_scale=0.5)
        tm = tm.advanced(torch.tensor(n), rate_scale=0.5)
        assert int(tm.abs_lo) == int(jm.abs_lo)
        assert int(tm.abs_hi) == int(jm.abs_hi)
        assert int(tm.seq) == int(jm.seq)
        assert tm.sample_rate == jm.sample_rate


def test_meta_start_defaults_to_the_card():
    """StreamMeta.start, like every entry point, defaults to the card and
    raises without one rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert tstream.StreamMeta.start(1.0).abs_lo.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tstream.StreamMeta.start(1.0)
    # Stream.full follows its data's device
    assert tstream.Stream.full(torch.zeros(4)).meta.seq.device.type == CPU


def test_stream_full_like_and_mask():
    x = torch.arange(10, dtype=torch.float32)
    s = tstream.Stream.full(x, sample_rate=2.0)
    assert int(s.count) == 10 and s.capacity == 10
    assert s.dtype == torch.float32 and s.meta.sample_rate == 2.0
    t = s.like(x[:5], count=torch.tensor(3, dtype=torch.int32),
               rate_scale=0.25)
    assert t.meta.sample_rate == 0.5 and t.count.dtype == torch.int32
    np.testing.assert_array_equal(
        t.valid_mask().numpy(),
        np.asarray(jstream.Stream.full(jnp.zeros(5)).like(
            jnp.zeros(5), count=3).valid_mask()))


def _diamond(blk_mod, graph_mod):
    @blk_mod.block_from_fn
    def scale(x, k=1.0):
        return x * k

    @blk_mod.block_from_fn
    def square(x):
        return x * x

    add = blk_mod.FnBlock(lambda a, b: a + b, n_in=2, name="add")
    split = blk_mod.FnBlock(lambda x: (x, -x), n_out=2, name="split")
    fg = graph_mod.Flowgraph()
    a, b = scale(2.0), square()
    fg.input("x", split)
    fg.connect((split, 0), a)
    fg.connect((split, 1), b)
    fg.connect(a, (add, 0))
    fg.connect(b, (add, 1))
    fg.output("y", add)
    fg.output("neg", (split, 1))
    return fg


def test_flowgraph_diamond_matches_jax():
    x = np.arange(6, dtype=np.float32)
    jfg = _diamond(jblock, jgraph)
    tfg = _diamond(tblock, tgraph)
    _, jo = jfg.build_step()(jfg.init_states(), jfg.init_params(),
                             {"x": jstream.Stream.full(jnp.asarray(x))})
    run = tfg.compile().run_stream(
        iter([{"x": tstream.Stream.full(torch.from_numpy(x))}]))
    to, _ = next(run)
    for port in ("y", "neg"):
        np.testing.assert_array_equal(to[port].data.numpy(),
                                      np.asarray(jo[port].data))


def test_flowgraph_rejects_bad_wiring():
    fg = tgraph.Flowgraph()
    a = tblock.FnBlock(lambda x: x, name="a")
    b = tblock.FnBlock(lambda x: x, name="b")
    fg.connect(a, b)
    with pytest.raises(ValueError, match="already connected"):
        fg.connect(a, b)
    with pytest.raises(ValueError, match="duplicate"):
        fg.add(tblock.FnBlock(lambda x: x, name="a"))
    fg.connect(b, a)
    with pytest.raises(ValueError, match="cycle"):
        fg.build_step()
    lone = tgraph.Flowgraph()
    lone.add(tblock.FnBlock(lambda x: x, name="c"))
    with pytest.raises(ValueError, match="unconnected"):
        lone.build_step()({"c": None}, {"c": None}, {})


def test_block_base_contract():
    blk = tblock.Block(name="plain")
    assert blk.init_state() is None and blk.init_params() is None
    assert "plain" in repr(blk)
    with pytest.raises(NotImplementedError):
        blk(tstream.Stream.full(torch.zeros(3)))
    auto = tblock.FnBlock(lambda x: x)
    assert auto.name != tblock.FnBlock(lambda x: x).name
