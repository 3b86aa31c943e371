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


@pytest.mark.parametrize("abs_index", [0, 2 ** 32 - 3, 2 ** 32, 2 ** 32 + 7,
                                       5 * 2 ** 32 + 12345])
@pytest.mark.parametrize("rate,epoch", [(48e3, (0, 0.0)),
                                        (3.2e6, (1700000000, 0.625)),
                                        (1.0 / 3.0, (12, 0.1))])
def test_time_of_first_sample_matches_jax(abs_index, rate, epoch):
    sec, frac = epoch
    jm = jstream.StreamMeta.start(rate, abs_index=abs_index, epoch_sec=sec,
                                  epoch_frac=frac)
    tm = tstream.StreamMeta.start(rate, abs_index=abs_index, epoch_sec=sec,
                                  epoch_frac=frac, device=CPU)
    for _ in range(3):
        want = np.asarray(jm.time_of_first_sample())
        got = tm.time_of_first_sample()
        assert got.dtype == torch.float32
        assert np.array_equal(want.view(np.int32),
                              got.numpy().view(np.int32))
        jm, tm = jm.advanced(2 ** 31 + 1), tm.advanced(2 ** 31 + 1)


def _jax_and_port_streams():
    x = np.array([3.0, -4.0], np.float32)
    return (jstream.Stream(data=jnp.asarray(x), count=jnp.int32(2),
                           meta=jstream.StreamMeta.start(1e3)),
            tstream.Stream(data=torch.from_numpy(x),
                           count=torch.tensor(2, dtype=torch.int32),
                           meta=tstream.StreamMeta.start(1e3, device=CPU)))


def test_any_block_stateful_matches_jax():
    # tests/test_viz_compat.py: test_any_block_stateful, on both packages
    def jaccum(state, params, x):
        return state + jnp.sum(x.data), x.like(x.data * params["k"])

    def taccum(state, params, x):
        return state + torch.sum(x.data), x.like(x.data * params["k"])

    jb = jblock.AnyBlock(jaccum, init_state=lambda: jnp.float32(0),
                         init_params=lambda: dict(k=jnp.float32(2.0)))
    tb = tblock.AnyBlock(taccum, init_state=lambda: torch.tensor(0.0),
                         init_params=dict(k=torch.tensor(2.0)))
    assert tb.name == "taccum" and (tb.n_in, tb.n_out) == (1, 1)
    jx, tx = _jax_and_port_streams()
    js, (jy,) = jb.apply(jb.init_state(), jb.init_params(), jx)
    ts, (ty,) = tb.apply(tb.init_state(), tb.init_params(), tx)
    assert float(ts) == float(js) == -1.0
    np.testing.assert_array_equal(ty.data.numpy(), np.asarray(jy.data))
    assert int(ty.count) == int(jy.count)


_ANY_CODE = """
def init_state():
    return {zero}

def apply(state, params, x):
    return state + 1, x.like(x.data + state)
"""


@pytest.mark.parametrize("expr", [("jnp.abs(x) ** 2", "torch.abs(x) ** 2"),
                                  ("x * 2 + 1", "x * 2 + 1"),
                                  ("np.float32(3) - x", "np.float32(3) - x")])
def test_any_code_expression_matches_jax(expr):
    jx, tx = _jax_and_port_streams()
    _, (jy,) = jblock.any_code(expr[0])(jx)
    blk = tblock.any_code(expr[1])
    assert isinstance(blk, tblock.FnBlock)
    _, (ty,) = blk(tx)
    np.testing.assert_array_equal(ty.data.numpy(), np.asarray(jy.data))


def test_any_code_block_matches_jax():
    jx, tx = _jax_and_port_streams()
    jb = jblock.any_code(_ANY_CODE.format(zero="jnp.float32(0)"))
    tb = tblock.any_code(_ANY_CODE.format(zero="torch.tensor(0.0)"))
    assert isinstance(tb, tblock.AnyBlock) and tb.name == "any_code"
    js, ts = jb.init_state(), tb.init_state()
    for _ in range(3):
        js, (jy,) = jb.apply(js, None, jx)
        ts, (ty,) = tb.apply(ts, None, tx)
        np.testing.assert_array_equal(ty.data.numpy(), np.asarray(jy.data))
    assert float(ts) == float(js) == 3.0
    with pytest.raises(ValueError, match="apply"):
        tblock.any_code("y = 1")
