"""The port's stage pipeline in a world of 4 gloo ranks on the CPU: the
WBFM chain over a 4-rank 'stage' mesh against the JAX package's
``build_wbfm_pipeline`` at the same mesh and against the port's serial
``build_wbfm``; the generic pipeline with ``tests/test_pipeline.py``'s
simple stages; dp x pp over a (data, stage) = (2, 2) mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from grbaz_tpu.models.wbfm import WBFMConfig as JConfig
from grbaz_tpu.parallel.pipeline import StagePipeline, build_wbfm_pipeline
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models.wbfm import WBFMConfig, build_wbfm
from tests.conftest import snr_db
from tests.torch_dist_worker import spawn

N = 4096
M = 6
SQUELCH_DB = -20.0


def make_fm(n, fs, offset, tone=1e3, dev=75e3, seed=0):
    """``tests/test_pipeline.py``'s FM station."""
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    msg = np.sin(2 * np.pi * tone * t + rng.uniform(0, 6))
    phase = 2 * np.pi * dev * np.cumsum(msg) / fs
    return np.exp(1j * (2 * np.pi * offset * t + phase)).astype(np.complex64)


def inputs():
    fs = WBFMConfig().sample_rate
    rng = np.random.default_rng(8)
    quiet = 1e-4 * (rng.standard_normal(N * 4) + 1j * rng.standard_normal(N * 4))
    return dict(
        iq=make_fm(N * M, fs, 0.0),
        quiet=quiet.astype(np.complex64),
        loud=make_fm(N * 4, fs, 0.0, seed=9),
        mb=np.arange(5 * 8, dtype=np.float32).reshape(5, 8),
        mb2=np.stack([np.arange(3 * 8, dtype=np.float32).reshape(3, 8),
                      -np.arange(3 * 8, dtype=np.float32).reshape(3, 8)
                      * 0.5 + 7.0]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = dict(case="pipeline", block=N, squelch_db=SQUELCH_DB, **inputs())
    return spawn(4, {"pipeline": inp},
                 tmp_path_factory.mktemp("world4"))["pipeline"]


def serial_audio(cfg, iq):
    """The port's serial chain on the CPU (``build_wbfm``, the fractional
    audio chain)."""
    fg, _ = build_wbfm(cfg, device="cpu")
    step = fg.compile().step
    states, params = fg.init_states(), fg.init_params()
    outs = []
    for blk in iq.reshape(-1, cfg.block_size):
        states, o = step(states, params, {"iq": Stream.full(
            torch.from_numpy(blk), sample_rate=cfg.sample_rate)})
        outs.append(o["audio"].data[:int(o["audio"].count)].numpy())
    return np.concatenate(outs)


def jax_pipeline_audio(cfg, runs):
    """JAX's 4-stage pipeline on the conftest's mesh; ``runs`` are the
    chained calls' blocks."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("stage",))
    pipe, encode, decode = build_wbfm_pipeline(cfg, mesh)
    states = pipe.init_states()
    got = []
    for blocks in runs:
        states, out = pipe.run(states, np.stack([encode(b) for b in blocks]))
        got += [decode(np.asarray(out[m]))[0] for m in range(len(blocks))]
    return np.concatenate(got), states


def same_on_every_rank(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys
    for o in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], ranks[0][k], err_msg=k)


def test_wbfm_pipeline_chained_matches_jax_and_serial(ranks):
    """6 microbatches as two chained ``run`` calls of 3: above 100 dB
    against JAX's pipeline (one run of 6) and the port's serial chain;
    the replicated stage states equal on every rank and close to JAX's."""
    iq = inputs()["iq"]
    blocks = iq.reshape(-1, N)
    ref, jstates = jax_pipeline_audio(JConfig(block_size=N), [blocks])
    serial = serial_audio(WBFMConfig(block_size=N), iq)
    got = ranks[0]["plain0_audio"]
    assert len(got) == len(ref) == len(serial)
    assert snr_db(ref, got) > 100
    assert snr_db(serial, got) > 100
    same_on_every_rank(ranks, "plain0_")
    o = ranks[0]
    assert int(o["plain0_state.0.phase"]) == int(jstates[0]["phase"])
    assert int(o["plain0_state.2.mu_int"]) == int(jstates[2]["mu_int"])
    assert int(o["plain0_state.2.mu_frac"]) == int(jstates[2]["mu_frac"])
    np.testing.assert_allclose(o["plain0_state.0.tail"],
                               np.asarray(jstates[0]["tail"]), atol=1e-5)
    np.testing.assert_allclose(o["plain0_state.3.y_prev"],
                               np.asarray(jstates[3]["y_prev"]), atol=1e-5)


def test_wbfm_pipeline_with_squelch(ranks):
    """``squelch_db`` folds the power squelch into the demod stage: quiet
    noise is muted as in JAX and the serial chain; a loud station passes
    above 100 dB against both."""
    inp = inputs()
    cfg = WBFMConfig(block_size=N, squelch_db=SQUELCH_DB)
    jcfg = JConfig(block_size=N, squelch_db=SQUELCH_DB)
    for r, name in enumerate(("quiet", "loud")):
        got = ranks[0][f"squelch{r}_audio"]
        ref, _ = jax_pipeline_audio(jcfg, [inp[name].reshape(-1, N)])
        serial = serial_audio(cfg, inp[name])
        assert len(got) == len(ref) == len(serial)
        if name == "quiet":
            np.testing.assert_allclose(got, 0.0, atol=1e-6)
            np.testing.assert_allclose(ref, 0.0, atol=1e-6)
            np.testing.assert_allclose(serial, 0.0, atol=1e-6)
        else:
            assert snr_db(ref, got) > 100
            assert snr_db(serial, got) > 100
    same_on_every_rank(ranks, "squelch")


def generic_serial(mb):
    """The serial model of the generic stages (``tests/test_pipeline.py``)."""
    st0 = st2 = np.float32(0)
    exp = []
    for b in mb:
        b = b + st0
        st0 += np.float32(1.0)
        b = b * np.float32(2.0)
        st2 += b.sum()
        b = b - np.float32(1.0)
        exp.append(b + np.float32(0.5))
    return np.stack(exp), st0, st2


def test_generic_pipeline_simple_stages(ranks):
    """Within 1e-6 of the serial model and of JAX's StagePipeline, with
    its states, on every rank; each rank runs M + S - 1 = 8 ticks and its
    own stage M = 5 times, no other."""
    mb = inputs()["mb"]
    exp, st0, st2 = generic_serial(mb)

    def s0(st, b):
        return st + 1.0, b + st

    def s1(st, b):
        return st, b * 2.0

    def s2(st, b):
        return st + jnp.sum(b), b - 1.0

    def s3(st, b):
        return st, b + 0.5

    jpipe = StagePipeline([s0, s1, s2, s3], [np.float32(0)] * 4, (8,),
                          Mesh(np.array(jax.devices()[:4]), ("stage",)))
    jstates, jout = jpipe.run(jpipe.init_states(), mb)
    for s, o in enumerate(ranks):
        np.testing.assert_allclose(o["generic_out"], exp, rtol=1e-6)
        np.testing.assert_allclose(o["generic_out"], np.asarray(jout),
                                   rtol=1e-6)
        np.testing.assert_allclose(o["generic_state.0"], st0)
        np.testing.assert_allclose(o["generic_state.2"], st2, rtol=1e-6)
        for i in range(4):
            np.testing.assert_allclose(o[f"generic_state.{i}"],
                                       np.asarray(jstates[i]), rtol=1e-6)
        assert int(o["generic_ticks"]) == 5 + 4 - 1
        np.testing.assert_array_equal(o["generic_calls"],
                                      [5 if i == s else 0 for i in range(4)])


def test_wbfm_pipeline_ticks(ranks):
    """M + S - 1 ticks a run on every rank: 3 + 3 for each chained half of
    the plain chain, 4 + 3 for each squelch run."""
    for o in ranks:
        assert int(o["plain0_ticks_3"]) == int(o["plain0_ticks_6"]) == 6
        assert int(o["squelch0_ticks_4"]) == int(o["squelch1_ticks_4"]) == 7


def test_dp_x_pp(ranks):
    """Two streams over a (data, stage) = (2, 2) mesh through a 2-stage
    pipeline: each stream equals its own serial run, and its states too;
    each rank holds its stream's."""
    mb2 = inputs()["mb2"]
    for o in ranks:
        assert int(o["dp_ticks"]) == 3 + 2 - 1
    for r, o in enumerate(ranks):
        stream = r // 2           # the data index of (data, stage) rank r
        st0 = st1 = np.float32(0)
        exp = []
        for b in mb2[stream]:
            b = b + st0
            st0 += np.float32(1.0)
            b = b * np.float32(2.0)
            st1 += b.sum()
            exp.append(b - np.float32(1.0))
        np.testing.assert_allclose(o["dp_out"][0], np.stack(exp), rtol=1e-6)
        np.testing.assert_allclose(o["dp_state.0"], [st0])
        np.testing.assert_allclose(o["dp_state.1"], [st1], rtol=1e-6)


def test_wbfm_pipeline_needs_four_stage_ranks():
    """``build_wbfm_pipeline`` raises, as JAX's does, on a stage dim that
    is not 4 ranks (here a one-rank world)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from grbaz_tpu_torch.parallel.pipeline import \
        build_wbfm_pipeline as tbuild

    with pytest.raises(ValueError, match="4 stages"):
        build_wbfm_pipeline(JConfig(block_size=N), Mesh(
            np.array(jax.devices()[:2]), ("stage",)))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
            with pytest.raises(ValueError, match="4 stages"):
                tbuild(WBFMConfig(block_size=N), mesh)
        finally:
            dist.destroy_process_group()
