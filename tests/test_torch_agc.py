"""Port AGC and BASELINE config 1 (resampler -> AGC) == grbaz_tpu."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.core.graph import Flowgraph as JFlowgraph
from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.ops.agc import AGC as JAGC
from grbaz_tpu.ops.resampler import FractionalResampler as JResampler
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.core.graph import Flowgraph
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.agc import AGC
from grbaz_tpu_torch.ops.resampler import FractionalResampler
from tests.conftest import snr_db
from tests.torch_parity import jax_run, port_run, split, valid

CPU = "cpu"
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")


def _fading(n, seed, complex_=True):
    """A signal whose amplitude swings over 20 dB, plus noise (a wider
    swing measures the one-pole scans' f32 error, relative to the block's
    largest envelope, more than the AGC)."""
    gen = np.random.default_rng(seed)
    t = np.arange(n)
    env = 10 ** (0.5 * np.sin(2 * np.pi * t / n))
    x = env * np.exp(1j * 0.013 * t) + 0.01 * (gen.standard_normal(n)
                                               + 1j * gen.standard_normal(n))
    return (x if complex_ else x.real).astype(
        np.complex64 if complex_ else np.float32)


@pytest.mark.parametrize("bs", [4096, 1024, 1000])
def test_agc_matches_golden(bs):
    """The golden fixture at > 80 dB, in one block or across blocks with
    a partial (zero-padded, count < capacity) last block."""
    fix = np.load(FIX)
    blk = AGC(rate=float(fix["agc_rate"]), reference=float(fix["agc_ref"]),
              device=CPU)
    blocks, counts = split(fix["agc_in"], bs)
    outs, _ = port_run(blk, blocks, counts)
    assert snr_db(fix["agc_out"], valid(outs)) > 80.0


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("bs,n", [(8192, 8192), (2048, 8192), (1500, 7000)])
def test_agc_matches_jax_block(complex_, bs, n):
    """Output, envelope and gain over chained blocks (a partial last block
    where bs does not divide n) at > 90 dB against the JAX block, and the
    carried (env, started) state."""
    x = _fading(n, 7, complex_)
    blocks, counts = split(x, bs)
    jo, js = jax_run(JAGC(1e-3, 1.0), blocks, counts)
    to, ts = port_run(AGC(1e-3, 1.0, device=CPU), blocks, counts)
    for port in range(3):
        assert snr_db(valid(jo, port), valid(to, port)) > 90.0
        assert [o[port][1] for o in jo] == [o[port][1] for o in to]
    assert ts["started"].dtype == torch.bool and bool(ts["started"])
    assert abs(float(ts["env"]) - float(js["env"])) \
        <= 1e-5 * abs(float(js["env"]))


def test_agc_empty_block_keeps_state_unstarted():
    """A block with count 0 before any sample leaves the AGC unstarted,
    so the first valid sample still sets the envelope."""
    x = _fading(2048, 3)
    blocks, counts = [x[:1024], x[1024:]], [0, 1024]
    jo, js = jax_run(JAGC(1e-2, 1.0), blocks, counts)
    blk = AGC(1e-2, 1.0, device=CPU)
    st = blk.init_state()
    to, ts = port_run(blk, blocks[:1], counts[:1], state=st)
    assert not bool(ts["started"]) and float(ts["env"]) == 1.0
    to, ts = port_run(blk, blocks[1:], counts[1:], state=ts)
    assert snr_db(jo[1][0][0], to[0][0][0]) > 90.0


def _config1(pkg_flowgraph, resampler, agc, block, **kw):
    fg = pkg_flowgraph("cfg1")
    rs = resampler(block, 250e3 / 48e3, name="rs", **kw)
    ag = agc(1e-4, 1.0, name="agc", **kw)
    fg.input("iq", rs)
    fg.chain(rs, ag)
    fg.output("out", ag)
    return fg


@pytest.mark.parametrize("block,counts", [(8192, (8192, 8192, 5000)),
                                          (4096, (4096, 1, 4096, 3000))])
def test_config1_flowgraph_matches_jax(block, counts):
    """BASELINE config 1 (FractionalResampler 250e3/48e3 -> AGC(1e-4,
    1.0), as benchmarks.py builds it) over chained blocks with partial
    blocks, against the JAX flowgraph step."""
    gen = np.random.default_rng(block)
    n = block * len(counts)
    t = np.arange(n)
    x = (np.exp(1j * 0.01 * t) * (0.2 + 0.1 * np.sin(2e-4 * t))
         + 0.01 * (gen.standard_normal(n) + 1j * gen.standard_normal(n))
         ).astype(np.complex64)
    jfg = _config1(JFlowgraph, JResampler, JAGC, block)
    tfg = _config1(Flowgraph, FractionalResampler, AGC, block, device=CPU)
    jstep, tstep = jax.jit(jfg.build_step()), tfg.build_step()
    jst = jax.tree_util.tree_map(jnp.asarray, jfg.init_states())
    tst = tfg.init_states()
    jpr, tpr = jfg.init_params(), tfg.init_params()
    got, want = [], []
    for b, c in enumerate(counts):
        xb = x[b * block:(b + 1) * block]
        js = JStream.full(jnp.asarray(xb), sample_rate=250e3)
        jst, jo = jstep(jst, jpr, {"iq": JStream(js.data, jnp.int32(c),
                                                 js.meta)})
        ts = Stream.full(torch.from_numpy(xb), sample_rate=250e3)
        ts.count = torch.tensor(c, dtype=torch.int32)
        tst, to = tstep(tst, tpr, {"iq": ts})
        k = int(jo["out"].count)
        assert int(to["out"].count) == k
        want.append(np.asarray(jo["out"].data)[:k])
        got.append(to["out"].data.numpy()[:k])
    got, want = np.concatenate(got), np.concatenate(want)
    assert snr_db(want, got) > 90.0


def test_agc_state_checkpoint_both_ways(tmp_path):
    """The bool `started` and f32 `env` leaves round-trip through both
    packages' checkpoints and the converters."""
    x = _fading(4096, 9)
    _, js = jax_run(JAGC(1e-3, 1.0), [x], [4096])
    _, ts = port_run(AGC(1e-3, 1.0, device=CPU), [x], [4096])
    p = str(tmp_path / "j.npz")
    jckpt.save_state(p, {"agc": js})
    st, _, _ = tckpt.load_state(p, {"agc": AGC(device=CPU).init_state()})
    assert st["agc"]["started"].dtype == torch.bool
    assert bool(st["agc"]["started"])
    assert float(st["agc"]["env"]) == float(js["env"])
    tckpt.save_state(p, {"agc": ts})
    jst, _, _ = jckpt.load_state(p, {"agc": JAGC().init_state()})
    assert np.asarray(jst["agc"]["started"]).dtype == np.bool_
    assert float(jst["agc"]["env"]) == float(ts["env"])
    back = states_from_numpy(to_numpy(ts), CPU)
    assert back["started"].dtype == torch.bool
    assert torch.equal(back["env"], ts["env"])
