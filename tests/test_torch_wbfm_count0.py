"""Empty and all-zero blocks through the WBFM chains, the port against
the JAX step on the CPU, over ``chip_smoke.count0_runs``: the counts of
``count0_counts`` (full, empty, full, short, empty, full), and runs of
blocks of noise 80 dB down and of all-zero blocks between blocks of a
station, for the cascade and fractional chains, with
and without the squelch. Outputs up to their counts within the chain's
bar (1e-4 of the max) and counts equal. States are not compared with
JAX: its XLA path carries a rotated channel tail, the port the
unrotated one (``ROADMAP.md`` §C); the card holds them against the port
on the CPU (``chip_smoke.count0_phase``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.core.stream import StreamMeta as JMeta
from grbaz_tpu.models import wbfm as jwbfm
from grbaz_tpu_torch.models import wbfm as twbfm

N = 8192
FS = 3.2e6


def _station(n_total, seed=3):
    t = np.arange(n_total)
    ph = 2 * np.pi * 250e3 / FS * t + 75.0 * np.sin(2 * np.pi * 1e3 / FS * t)
    gen = np.random.default_rng(seed)
    noise = 0.02 * (gen.standard_normal(n_total)
                    + 1j * gen.standard_normal(n_total))
    return (np.exp(1j * ph) + noise).astype(np.complex64)


def _runs():
    return cs.count0_runs([_station(6 * N)[b * N:(b + 1) * N]
                           for b in range(6)])


@pytest.mark.parametrize("squelch_db", [None, -20.0])
@pytest.mark.parametrize("chain", ["cascade", "fractional"])
@pytest.mark.parametrize("run", ["counts", "near-zero", "zeros"])
def test_empty_and_zero_blocks_match_jax(run, chain, squelch_db):
    blocks, counts = _runs()[run]
    kw = dict(block_size=N, audio_chain=chain, center_freq=250e3,
              squelch_db=squelch_db)
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**kw))
    jstep = jax.jit(jfg.build_step())
    jst = jax.tree_util.tree_map(jnp.asarray, jfg.init_states())
    jpr = jfg.init_params()
    jmeta = JMeta.start(FS, abs_index=cs.COUNT0_START)
    jouts = []
    for x, c in zip(blocks, counts):
        jst, o = jstep(jst, jpr, {"iq": JStream(jnp.asarray(x), jnp.int32(c),
                                                jmeta)})
        jouts.append({k: (np.asarray(v.data)[:int(v.count)], int(v.count))
                      for k, v in o.items()})
        jmeta = jmeta.advanced(c)
    tcfg = twbfm.WBFMConfig(**kw)
    touts = cs.chain_steps(tcfg, torch.device("cpu"), blocks, counts)
    for b, ((to, _), jo) in enumerate(zip(touts, jouts)):
        assert set(to) == set(jo)
        for port, (ref, k) in jo.items():
            got, tk, _ = to[port]
            assert tk == k, (b, port)
            if k:
                scale = np.abs(ref).max()
                err = np.abs(got.numpy() - ref).max()
                assert err <= 1e-4 * scale, (b, port, err, scale)
