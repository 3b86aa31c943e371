"""Port WBFM chain, executor and weight conversion == grbaz_tpu."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.executor import InputSpec as JInputSpec
from grbaz_tpu.core.executor import StreamExecutor as JExecutor
from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.models import wbfm as jwbfm
from grbaz_tpu.ops.fir import FreqXlatingFIRDecimator as JChan
from grbaz_tpu_torch.convert import (params_from_numpy, states_from_numpy,
                                     to_numpy)
from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models import wbfm as twbfm
from grbaz_tpu_torch.ops.fir import FreqXlatingFIRDecimator as TChan
from tests.conftest import snr_db

CPU = "cpu"
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")
FS = 3.2e6


def _fm_station(n_total, seed=1, offset=250e3, tone=1e3, dev=75e3):
    t = np.arange(n_total)
    ph = 2 * np.pi * offset / FS * t \
        + (dev / tone) * np.sin(2 * np.pi * tone / FS * t)
    gen = np.random.default_rng(seed)
    noise = 0.05 * (gen.standard_normal(n_total)
                    + 1j * gen.standard_normal(n_total))
    return (np.exp(1j * ph) + noise).astype(np.complex64)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def test_wbfm_chain_matches_golden():
    fix = np.load(FIX)
    iq = fix["wbfm_in"]
    cfg = twbfm.WBFMConfig(block_size=len(iq), center_freq=250e3)
    fg, _ = twbfm.build_wbfm(cfg, device=CPU)
    _, o = fg.build_step()(fg.init_states(), fg.init_params(),
                           {"iq": Stream.full(torch.from_numpy(iq),
                                              sample_rate=cfg.sample_rate)})
    audio = o["audio"].data.numpy()[: int(o["audio"].count)]
    quad = o["quad"].data.numpy()[: int(o["quad"].count)]
    w = 64
    assert snr_db(fix["wbfm_quad"][w:len(quad)], quad[w:]) > 55.0
    aw = 16
    m = min(len(audio), len(fix["wbfm_audio"]))
    assert m > 900
    assert snr_db(fix["wbfm_audio"][aw:m], audio[aw:m]) > 50.0


@pytest.mark.parametrize("chan_backend", ["auto", "kernel"])
@pytest.mark.parametrize("squelch_db", [None, -20.0])
def test_cascade_chain_matches_jax_step(chan_backend, squelch_db):
    """The cascade config (the flagship bench shape at a small block)
    over 3 chained blocks, with a partial last block, == the JAX step."""
    n = 8192
    iq = _fm_station(3 * n)
    kw = dict(block_size=n, audio_chain="cascade", center_freq=250e3,
              squelch_db=squelch_db)
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**kw))
    tfg, _ = twbfm.build_wbfm(twbfm.WBFMConfig(chan_backend=chan_backend,
                                               **kw), device=CPU)
    jstep = jax.jit(jfg.build_step())
    tstep = tfg.build_step()
    jst = jax.tree_util.tree_map(jnp.asarray, jfg.init_states())
    tst = tfg.init_states()
    jpr, tpr = jfg.init_params(), tfg.init_params()
    counts = [n, n, n - 1000]
    for b, c in enumerate(counts):
        x = iq[b * n:(b + 1) * n]
        js = JStream.full(jnp.asarray(x), sample_rate=FS)
        js = JStream(js.data, jnp.int32(c), js.meta)
        ts = Stream.full(torch.from_numpy(x), sample_rate=FS)
        ts.count = torch.tensor(c, dtype=torch.int32)
        jst, jo = jstep(jst, jpr, {"iq": js})
        tst, to = tstep(tst, tpr, {"iq": ts})
        for port in ("audio", "quad"):
            k = int(jo[port].count)
            assert int(to[port].count) == k
            _close(to[port].data.numpy()[:k],
                   np.asarray(jo[port].data)[:k], 1e-4)


def test_fused_config_is_next_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        twbfm.build_wbfm(twbfm.WBFMConfig(fused=True), device=CPU)


def test_stream_executor_partial_block_and_retune():
    """Host-fed executor: a retune between steps and a partial last
    block, against the JAX executor on the same input."""
    n = 8192
    iq = _fm_station(3 * n, offset=-431.7e3)
    kw = dict(block_size=n, audio_chain="cascade", center_freq=250e3)
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**kw))
    tfg, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**kw), device=CPU)
    jex = JExecutor(jfg, {"iq": JInputSpec((n,), "complex64", FS)})
    tex = StreamExecutor(tfg, {"iq": InputSpec((n,), "complex64", FS)},
                         device=CPU)
    for b, count in enumerate([n, n, n // 2 + 8]):
        if b == 1:  # retune onto the station through params only
            jex.params["channel"] = JChan.freq_params(-431.7e3, FS)
            tex.params["channel"] = TChan.freq_params(-431.7e3, FS)
        x = iq[b * n:(b + 1) * n]
        jo = jex.step({"iq": x}, counts={"iq": count})
        to = tex.step({"iq": x}, counts={"iq": count})
        for port in ("audio", "quad"):
            (jd, jc), (td, tc) = jo[port], to[port]
            assert tc == jc and td.dtype == jd.dtype
            _close(td[:tc], jd[:jc], 1e-4)
    assert to["quad"][1] == (n // 2 + 8) // 8
    assert tex.stats["samples_in"] == 2 * n + n // 2 + 8
    assert tex._meta["iq"].abs_lo.item() == 2 * n + n // 2 + 8
    with pytest.raises(ValueError):
        tex.step({"iq": x[:-1]})
    with pytest.raises(KeyError):
        tex.step({"iq": x}, params=dict(nope={}))


def test_convert_round_trip_is_lossless():
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(
        block_size=8192, audio_chain="cascade", squelch_db=-10.0,
        center_freq=-1.1e6))
    for tree, conv in ((jfg.init_states(), states_from_numpy),
                       (jfg.init_params(), params_from_numpy)):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        back = to_numpy(conv(tree, CPU))
        flat_a, def_a = jax.tree_util.tree_flatten(tree)
        flat_b, def_b = jax.tree_util.tree_flatten(back)
        assert def_a == def_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_port_states_match_jax_layout():
    """The port's own init trees have the JAX trees' keys, shapes and
    (through the uint32 convention) dtypes, block by block."""
    kw = dict(block_size=8192, audio_chain="cascade", squelch_db=-10.0)
    jfg, _ = jwbfm.build_wbfm(jwbfm.WBFMConfig(**kw))
    tfg, _ = twbfm.build_wbfm(twbfm.WBFMConfig(**kw), device=CPU)
    assert [type(b).__name__ for b in jfg.blocks] == \
        [type(b).__name__ for b in tfg.blocks]
    for jb, tb in zip(jfg.blocks, tfg.blocks):
        for jt, tt in ((jb.init_state(), tb.init_state()),
                       (jb.init_params(), tb.init_params())):
            jt = jax.tree_util.tree_map(np.asarray, jt)
            tt = to_numpy(tt)
            assert jax.tree_util.tree_structure(jt) == \
                jax.tree_util.tree_structure(tt)
            for a, b in zip(jax.tree_util.tree_leaves(jt),
                            jax.tree_util.tree_leaves(tt)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(a, b)


def test_smoke_script_helpers_recover_tone():
    """chip_smoke.py's signal and SINAD helpers, rehearsed on the CPU
    with the cascade chain at a small block."""
    import chip_smoke
    n = 1 << 16
    cfg = twbfm.WBFMConfig(block_size=n, audio_chain="cascade",
                           center_freq=250e3)
    fg, _ = twbfm.build_wbfm(cfg, device=CPU)
    step = fg.build_step()
    st, pr = fg.init_states(), fg.init_params()
    iq = chip_smoke.synth_fm(8 * n, torch.device(CPU))
    audio = []
    for b in range(8):
        st, o = step(st, pr, {"iq": Stream.full(iq[b * n:(b + 1) * n])})
        audio.append(o["audio"].data[: int(o["audio"].count)])
    f, sinad = chip_smoke.tone_sinad(torch.cat(audio[1:]).numpy(),
                                     cfg.audio_rate)
    assert abs(f - chip_smoke.TONE_HZ) < 5.0
    assert sinad > 40.0
