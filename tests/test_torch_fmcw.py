"""The port's FMCW radar (``models/fmcw.py``) against the JAX package's on
the CPU. The JAX package has no FMCW test, so its blocks are the oracle.

Its blocks call ``Stream.replace``, which the JAX core's ``Stream`` does
not define, and ``build_fmcw`` calls ``connect(..., out_port=0)``, which
its ``Flowgraph`` does not take (both raise). The oracle here feeds the
JAX blocks a ``Stream`` with that one method (``dataclasses.replace``)
and chains ``ChirpDeramp`` into ``RangeFFT`` by hand, as ``build_fmcw``
means to.

Tolerances: the uint32 chirp phase and the deramp's counter are
bit-equal (their wraps included); ``tx`` (a float32 ``cos`` of the same
float32 angle) within 1e-6, since XLA's and torch's ``cos``/``sin``
differ by an ulp on some inputs; ``beat`` within 1e-6 of its max; the
range profiles within 1e-3 dB wherever the magnitude is above 1e-4 of
the block's max.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.core.stream import StreamMeta as JMeta
from grbaz_tpu.models import fmcw as jf
from grbaz_tpu_torch.convert import states_from_numpy
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.core.stream import StreamMeta as TMeta
from grbaz_tpu_torch.models import fmcw as tf

TX_ABS = 1e-6
BEAT_REL = 1e-6
RANGE_DB = 1e-3
RANGE_FLOOR = 1e-4


class _JStream(JStream):
    """The JAX Stream with the ``replace`` its FMCW blocks call."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def cfgs(**kw):
    return jf.FMCWConfig(**kw), tf.FMCWConfig(**kw)


@pytest.mark.parametrize("P", [1024, 1000, 1 << 17])
def test_chirp_phase_matches_jax(P):
    """Every intra-sweep index, and indices past 2^16 where k * (k - 1)
    wraps mod 2^32 before it is halved (the sweep at P = 2^17 reaches
    them), bit-equal."""
    jc, tc = cfgs(sweep_period=P)
    rng = np.random.default_rng(P)
    k = np.concatenate([np.arange(P), rng.integers(0, 2 ** 32, 4096),
                        [2 ** 32 - 1, 2 ** 16, 2 ** 16 + 1]]).astype(np.uint32)
    want = np.asarray(jf.chirp_phase_u32(jnp.asarray(k), jc))
    got = tf.chirp_phase_u32(torch.from_numpy(k.astype(np.int64)), tc)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("P", [1024, 1000])
def test_chirp_iq_matches_jax(P):
    """The complex chirp over three sweeps across the 2^32 index wrap."""
    jc, tc = cfgs(sweep_period=P)
    g = (np.arange(3 * P, dtype=np.int64) + 2 ** 32 - P - 7) % 2 ** 32
    want = np.asarray(jf.chirp_iq(jnp.asarray(g.astype(np.uint32)), jc))
    got = tf.chirp_iq(torch.from_numpy(g), tc).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= TX_ABS


def jax_deramp(jblk, blocks, counts, state, meta):
    outs = []
    for x, c in zip(blocks, counts):
        state, (beat, tx) = jblk.apply(state, None, _JStream(
            jnp.asarray(x), jnp.int32(c), meta))
        outs.append((np.asarray(beat.data), int(beat.count),
                     np.asarray(tx.data), int(tx.count), np.asarray(state)))
    return outs


def port_deramp(tblk, blocks, counts, state, meta):
    outs = []
    for x, c in zip(blocks, counts):
        state, (beat, tx) = tblk.apply(state, None, TStream(
            torch.from_numpy(x), torch.tensor(c, dtype=torch.int32), meta))
        outs.append((beat.data.numpy(), int(beat.count), tx.data.numpy(),
                     int(tx.count), int(state)))
    return outs


def assert_deramp_close(jo, to, cfg, starts):
    for (jb, jbc, jt, jtc, js), (tb, tbc, tt, ttc, ts), s0 in zip(jo, to,
                                                               starts):
        assert (jbc, jtc) == (tbc, ttc)
        assert int(js) == ts
        assert tb.dtype == np.complex64 and tt.dtype == np.float32
        assert np.abs(tt - jt).max() <= TX_ABS
        assert np.abs(tb - jb).max() <= BEAT_REL * np.abs(jb).max()
        # the exact part of tx: the uint32 phase at the block's counters
        idx = (s0 + np.arange(len(tt), dtype=np.int64)) % 2 ** 32
        k = idx % cfg.sweep_period
        np.testing.assert_array_equal(
            tf.chirp_phase_u32(torch.from_numpy(k), cfg).numpy(),
            np.asarray(jf.chirp_phase_u32(jnp.asarray(k.astype(np.uint32)),
                                          cfg)).astype(np.int64))


@pytest.mark.parametrize("P,bs,start", [(1024, 4096, 0), (1000, 1500, 0),
                                        (1000, 1500, 2 ** 32 - 2500),
                                        (1024, 3000, 2 ** 32 - 5000)])
def test_deramp_matches_jax(P, bs, start):
    """Blocks of ``bs`` with a partial block, from counter ``start``: the
    counter advances by the capacity and wraps at 2^32 (at P = 1000 the
    sweep loses its alignment there, in both packages)."""
    jc, tc = cfgs(sweep_period=P)
    rng = np.random.default_rng(bs + P)
    blocks = [rng.standard_normal(bs).astype(np.float32) for _ in range(4)]
    counts = [bs, bs - 123, bs, bs]
    jo = jax_deramp(jf.ChirpDeramp(jc), blocks, counts, jnp.uint32(start),
                    JMeta.start(48e3))
    to = port_deramp(tf.ChirpDeramp(tc, device="cpu"), blocks, counts,
                     torch.tensor(start, dtype=torch.int64),
                     TMeta.start(48e3, device="cpu"))
    starts = [(start + i * bs) % 2 ** 32 for i in range(4)]
    assert_deramp_close(jo, to, tc, starts)
    assert to[-1][4] == (start + 4 * bs) % 2 ** 32


def assert_range_close(jr, tr):
    mag = 10.0 ** (jr.astype(np.float64) / 10.0)
    big = mag > RANGE_FLOOR * mag.max()
    assert big.sum() > 0.5 * big.size
    assert np.abs(tr - jr)[big].max() <= RANGE_DB


@pytest.mark.parametrize("P,n_sweeps", [(1024, 8), (1000, 3), (256, 1)])
def test_range_fft_matches_jax(P, n_sweeps):
    jc, tc = cfgs(sweep_period=P, block_size=P * n_sweeps)
    rng = np.random.default_rng(P)
    beat = (rng.standard_normal(P * n_sweeps)
            + 1j * rng.standard_normal(P * n_sweeps)).astype(np.complex64)
    _, (jo,) = jf.RangeFFT(jc).apply(None, None, _JStream(
        jnp.asarray(beat), jnp.int32(P * n_sweeps - 5), JMeta.start(48e3)))
    _, (to,) = tf.RangeFFT(tc, device="cpu").apply(None, None, TStream(
        torch.from_numpy(beat), torch.tensor(P * n_sweeps - 5,
                                             dtype=torch.int32),
        TMeta.start(48e3, device="cpu")))
    assert to.data.shape == (n_sweeps, P // 2 + 1)
    assert int(to.count) == int(jo.count) == n_sweeps   # whatever the count
    assert_range_close(np.asarray(jo.data), to.data.numpy())


def echo(cfg, n, seed=0):
    return (tf.simulate_echo(cfg, n, 80, 0.5)
            + tf.simulate_echo(cfg, n, 200, 0.3, noise=0.01, seed=seed))


@pytest.mark.parametrize("P,sweeps", [(1024, 4), (1000, 2)])
def test_build_fmcw_matches_jax(P, sweeps):
    """The port's graph step against the JAX deramp chained into the JAX
    range FFT, over three blocks of echoes, the last partial."""
    jc, tc = cfgs(sweep_period=P, block_size=P * sweeps)
    n = tc.block_size
    x = echo(tc, 3 * n)
    np.testing.assert_array_equal(x, jf.simulate_echo(jc, 3 * n, 80, 0.5)
                                  + jf.simulate_echo(jc, 3 * n, 200, 0.3,
                                                     noise=0.01, seed=0))
    fg, _ = tf.build_fmcw(tc, device="cpu")
    step = fg.compile().step
    ts, tp_ = fg.init_states(), fg.init_params()
    jd, jr = jf.ChirpDeramp(jc), jf.RangeFFT(jc)
    js = jnp.uint32(0)
    for b, c in enumerate((n, n, n - 77)):
        blk = np.ascontiguousarray(x[b * n:(b + 1) * n])
        js, (jbeat, jtx) = jd.apply(js, None, _JStream(
            jnp.asarray(blk), jnp.int32(c), JMeta.start(48e3)))
        _, (jrng,) = jr.apply(None, None, jbeat)
        ts, o = step(ts, tp_, {"rx": TStream(
            torch.from_numpy(blk), torch.tensor(c, dtype=torch.int32),
            TMeta.start(48e3, device="cpu"))})
        assert int(o["beat"].count) == int(o["tx"].count) == c
        assert int(o["range"].count) == int(jrng.count) == sweeps
        assert np.abs(o["tx"].data.numpy() - np.asarray(jtx.data)).max() \
            <= TX_ABS
        jb = np.asarray(jbeat.data)
        assert np.abs(o["beat"].data.numpy() - jb).max() \
            <= BEAT_REL * np.abs(jb).max()
        assert_range_close(np.asarray(jrng.data), o["range"].data.numpy())
        assert int(ts["deramp"]) == int(js)


def test_deramp_state_carried_from_jax():
    """The JAX counter, carried mid-stream and across the wrap, into the
    port (``states_from_numpy`` takes the uint32 to int64)."""
    jc, tc = cfgs(sweep_period=1000)
    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal(1700).astype(np.float32) for _ in range(5)]
    jblk = jf.ChirpDeramp(jc)
    meta = JMeta.start(48e3)
    start = 2 ** 32 - 4000
    mid = jax_deramp(jblk, blocks[:2], [1700, 1700], jnp.uint32(start), meta)
    carried = states_from_numpy(mid[-1][4], "cpu")
    assert carried.dtype == torch.int64
    jo = jax_deramp(jblk, blocks[2:], [1700] * 3, jnp.asarray(mid[-1][4]),
                    meta)
    to = port_deramp(tf.ChirpDeramp(tc, device="cpu"), blocks[2:],
                     [1700] * 3, carried, TMeta.start(48e3, device="cpu"))
    starts = [(start + (2 + i) * 1700) % 2 ** 32 for i in range(3)]
    assert_deramp_close(jo, to, tc, starts)


def test_fmcw_config_matches_jax():
    jc, tc = cfgs(block_size=1 << 14)
    assert tc.n_sweeps == jc.n_sweeps == 16
    assert tc.range_resolution() == jc.range_resolution()
    assert tc.bin_to_range(7) == jc.bin_to_range(7)
    assert tc.delay_to_bin(80) == jc.delay_to_bin(80) == 10.0
    with pytest.raises(ValueError):
        tf.RangeFFT(tf.FMCWConfig(block_size=1500), device="cpu")


def test_chip_smoke_fmcw_scene_on_the_cpu():
    """chip_smoke.py's FMCW scene and checks at 2^16-sample blocks on the
    CPU, from 0 and across the counter's 2^32 wrap: the echoes in their
    beat bins, tx equal to chirp_iq's real part, the counters."""
    import chip_smoke as cs
    cfg = tf.FMCWConfig(block_size=1 << 16)
    feeds = cs.fmcw_scene(torch.device("cpu"), cfg, n_blocks=2)
    for start in (0, cs.FMCW_WRAP):
        fg, _ = tf.build_fmcw(cfg, device="cpu")
        outs, after = cs.fmcw_run(fg, feeds, start)
        assert after == [(start + (b + 1) * cfg.block_size) % 2 ** 32
                         for b in range(2)]
        assert cs.check_fmcw_outputs(outs, cfg, start) == [10, 25]
