"""Port fused WBFM front end (rotated-taps helpers, the plain twin of
the B2 kernel, ``WBFMFrontend``, the fused chain) == grbaz_tpu.

The JAX references run on the CPU: the XLA arm of ``WBFMFrontend``
directly and ``xlating_fir_frame_pallas`` in interpret mode. Bars are the
JAX package's own (``tests/test_wbfm_frontend.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.models import wbfm as jwbfm
from grbaz_tpu.ops import fir as jfir
from grbaz_tpu.ops.pallas import wbfm_frontend as jwf
from grbaz_tpu_torch.convert import params_from_numpy, to_numpy
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.models import wbfm as twbfm
from grbaz_tpu_torch.ops import fir as tfir
from grbaz_tpu_torch.ops import wbfm_frontend as twf
from grbaz_tpu_torch.ops.cuda import xlating_fir_ctaps as txc
from tests.conftest import snr_db

FS = 3.2e6
DECIM = 8
CPU = "cpu"
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")
WRAP_INCS = [3123456789, 0x9E3779B9, 1, 0xFFFFFFFF]


def _taps():
    return jfir.low_pass_taps(1.0, FS, 100e3, 75e3)


def _cnoise(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def _fm_station(n, offset=250e3, tone=1e3, dev=75e3, seed=1):
    t = np.arange(n)
    ph = 2 * np.pi * offset / FS * t \
        + (dev / tone) * np.sin(2 * np.pi * tone / FS * t)
    gen = np.random.default_rng(seed)
    noise = 0.05 * (gen.standard_normal(n) + 1j * gen.standard_normal(n))
    return (np.exp(1j * ph) + noise).astype(np.complex64)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _gate_flips_only(got, ref, rel=1e-4, limit=8):
    """Samples that differ beyond ``rel`` must be squelch-gate flips (a
    demodulated sample whose product is zero on one side), at most
    ``limit`` of them, as in the JAX package's fused-chain test."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    bad = np.where(np.abs(got - ref) > rel * np.abs(ref).max())[0]
    assert len(bad) <= limit, f"{len(bad)} mismatches"
    for i in bad:
        assert got[i] == 0.0 or ref[i] == 0.0, f"non-gate mismatch at {i}"


# ---------------------------------------------------------------------------
# the plain functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inc", WRAP_INCS)
def test_rotated_taps_match_jax(inc):
    h = jfir.prepare_taps(_taps(), DECIM)
    ref = np.asarray(jwf.rotated_taps(jnp.asarray(h), jnp.uint32(inc)))
    got = twf.rotated_taps(torch.from_numpy(h), torch.tensor(inc)).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() < 1e-6


@pytest.mark.parametrize("inc", WRAP_INCS)
def test_rotate_output_matches_jax(rng, inc):
    yf = _cnoise(rng, 4096)
    ph = 0xFFFFFF00
    ref = np.asarray(jwf.rotate_output(jnp.asarray(yf), jnp.uint32(ph),
                                       jnp.uint32(inc), DECIM))
    got = twf.rotate_output(torch.from_numpy(yf), torch.tensor(ph),
                            torch.tensor(inc), DECIM).numpy()
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("inc", WRAP_INCS)
def test_demod_unrotated_matches_jax(rng, inc):
    """Including zero products (squelch-gated samples) and a zero
    previous sample."""
    yf = _cnoise(rng, 4096)
    yf[100:140] = 0
    yf[-1] = 0
    prev = np.complex64(0.3 - 0.1j)
    d_ref, last_ref = jwf.demod_unrotated(jnp.asarray(yf), jnp.complex64(prev),
                                          jnp.float32(0.85), jnp.uint32(inc),
                                          DECIM)
    d, last = twf.demod_unrotated(torch.from_numpy(yf), torch.tensor(prev),
                                  torch.tensor(0.85), torch.tensor(inc), DECIM)
    assert d.dtype == torch.float32
    assert np.abs(d.numpy() - np.asarray(d_ref)).max() < 1e-4
    assert np.all(d.numpy()[100:141] == 0)
    assert complex(last) == complex(last_ref)


@pytest.mark.parametrize("inc", [123456789, 3123456789])
def test_ctaps_product_matches_jax(rng, inc):
    h = jfir.prepare_taps(_taps(), DECIM)
    frame = _cnoise(rng, h.shape[0] - 1 + 4096 + 5)
    g = jwf.rotated_taps(jnp.asarray(h), jnp.uint32(inc))
    ref = jfir._fir_decimate_poly_ctaps(jnp.asarray(frame), g, DECIM)
    got = tfir.fir_decimate_frame_ctaps(torch.from_numpy(frame),
                                        torch.from_numpy(np.array(g)), DECIM)
    _close(got.numpy(), ref, 1e-6)


# ---------------------------------------------------------------------------
# B2: plain twin of the CUDA kernel == the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inc", [123456789, 3123456789])
def test_b2_plain_twin_matches_jax_pallas_interpret(rng, inc):
    h = jfir.prepare_taps(_taps(), DECIM)
    tpad = h.shape[0]
    n_new = 8192
    x, tail = _cnoise(rng, n_new), _cnoise(rng, tpad)
    frame = np.concatenate([tail[1:], x])
    ref = np.asarray(jwf.xlating_fir_frame_pallas(
        jnp.asarray(frame), h, DECIM, jnp.uint32(inc), interpret=True))
    th, tinc = torch.from_numpy(h), torch.tensor(inc)
    got = txc.xlating_fir_ctaps_frame(torch.from_numpy(frame), th, DECIM, tinc)
    _close(got.numpy(), ref, 1e-5)
    blk = txc.xlating_fir_ctaps_block(torch.from_numpy(x),
                                      torch.from_numpy(tail), th, DECIM, tinc)
    _close(blk.numpy(), ref, 1e-5)


@pytest.mark.parametrize("inc", WRAP_INCS)
@pytest.mark.parametrize("decim,n", [(8, 8192), (4, 8192), (8, 8192 + 5),
                                     (5, 8190), (4, 1001), (5, 37), (8, 9)])
def test_b2_plain_twin_matches_jax_at_wrap_heavy_increments(rng, inc, decim,
                                                            n):
    """``xlating_fir_ctaps_block``'s plain twin, ragged and short blocks
    at decim 4, 5 and 8, against the JAX package as its own tests run it
    on the CPU: rotated by ``rotate_output``, against the XLA
    channelizer ``xlating_fir_decimate_frame``; unrotated, against
    ``xlating_fir_frame_pallas`` in interpret mode where that kernel takes
    the shape. The JAX side gets the frame cut to whole outputs: the last
    ``n % decim`` samples reach no output."""
    h = jfir.prepare_taps(_taps(), decim)
    x, tail = _cnoise(rng, n), _cnoise(rng, h.shape[0])
    th, tinc = torch.from_numpy(h), torch.tensor(inc)
    got = txc.xlating_fir_ctaps_block(torch.from_numpy(x),
                                      torch.from_numpy(tail), th, decim,
                                      tinc).numpy()
    n_out = n // decim
    assert got.shape == (n_out,)
    frame = jnp.asarray(np.concatenate([tail[1:], x[:n_out * decim]]))
    phase0 = 0xFFFFF000
    ref = jfir.xlating_fir_decimate_frame(frame, jnp.asarray(h), decim,
                                          jnp.uint32(phase0), jnp.uint32(inc))
    rot = twf.rotate_output(torch.from_numpy(got), torch.tensor(phase0), tinc,
                            decim)
    _close(rot.numpy(), ref, 1e-5)
    if jwf.supported(n_out * decim, decim):
        _close(got, jwf.xlating_fir_frame_pallas(frame, h, decim,
                                                 jnp.uint32(inc),
                                                 interpret=True), 1e-5)


def test_b2_wrappers_run_plain_on_the_cpu():
    """On CPU tensors the wrappers run the plain twin and count nothing."""
    h = torch.from_numpy(jfir.prepare_taps(_taps(), DECIM))
    before = (txc.xlating_fir_ctaps_block.launches,
              txc.xlating_fir_ctaps_frame.launches)
    x = torch.zeros(1000, dtype=torch.complex64)
    y = txc.xlating_fir_ctaps_block(x, torch.zeros(h.shape[0],
                                                   dtype=torch.complex64),
                                    h, DECIM, torch.tensor(7))
    assert y.shape == (1000 // DECIM,)
    assert (txc.xlating_fir_ctaps_block.launches,
            txc.xlating_fir_ctaps_frame.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        txc.xlating_fir_ctaps_block_kernel(x, x, h, DECIM, torch.tensor(7))


# ---------------------------------------------------------------------------
# WBFMFrontend == the JAX block
# ---------------------------------------------------------------------------

def _run_frontends(squelch, backend, blocks, counts, retune_at=1):
    gain = 0.85
    jfe = jwbfm.WBFMFrontend(_taps(), DECIM, 250e3, FS, gain,
                             squelch_db=squelch, backend="xla")
    tfe = twbfm.WBFMFrontend(_taps(), DECIM, 250e3, FS, gain,
                             squelch_db=squelch, backend=backend, device=CPU)
    jst = jax.tree_util.tree_map(jnp.asarray, jfe.init_state())
    tst = tfe.init_state()
    jpr = jfe.init_params()
    outs = dict(jax=[], port=[])
    for b, (x, c) in enumerate(zip(blocks, counts)):
        if b == retune_at:
            jpr = dict(jpr, **jwbfm.WBFMFrontend.freq_params(-431.7e3, FS))
        tpr = params_from_numpy(jpr, CPU)
        js = JStream(jnp.asarray(x), jnp.int32(c),
                     JStream.full(jnp.asarray(x)).meta)
        ts = TStream.full(torch.from_numpy(x))
        ts.count = torch.tensor(c, dtype=torch.int32)
        jst, (jo,) = jfe.apply(jst, jpr, js)
        tst, (to,) = tfe.apply(tst, tpr, ts)
        assert int(to.count) == int(jo.count) == c // DECIM
        outs["jax"].append(np.asarray(jo.data)[:c // DECIM])
        outs["port"].append(to.data.numpy()[:c // DECIM])
    return outs, jax.tree_util.tree_map(np.asarray, jst), to_numpy(tst)


@pytest.mark.parametrize("backend", ["auto", "kernel", "plain"])
@pytest.mark.parametrize("squelch", [None, -20.0])
def test_frontend_matches_jax_block(backend, squelch):
    """3 chained blocks, a retune between blocks 0 and 1, a partial last
    block; states through ``to_numpy``."""
    n = 8192
    x = _fm_station(3 * n) + _fm_station(3 * n, offset=-431.7e3, seed=2)
    blocks = [x[b * n:(b + 1) * n] for b in range(3)]
    outs, jst, tst = _run_frontends(squelch, backend, blocks,
                                    [n, n, n - 3 * DECIM - 5])
    got, ref = np.concatenate(outs["port"]), np.concatenate(outs["jax"])
    if squelch is None:
        _close(got, ref, 1e-4)
    else:
        assert np.any(ref == 0.0)  # the gate opens inside the first block
        _gate_flips_only(got, ref)
    assert sorted(jst) == sorted(tst)
    for k in jst:
        assert jst[k].dtype == tst[k].dtype and jst[k].shape == tst[k].shape
    np.testing.assert_array_equal(tst["tail"], jst["tail"])
    assert tst["phase"] == jst["phase"]
    np.testing.assert_allclose(tst["prev_yf"], jst["prev_yf"], rtol=1e-4)
    if squelch is not None:
        np.testing.assert_allclose(tst["sq_avg"], jst["sq_avg"], rtol=1e-4)


def test_frontend_invariant_to_block_split(rng):
    x = _cnoise(rng, 1 << 14)

    def run(split):
        fe = twbfm.WBFMFrontend(_taps(), DECIM, 250e3, FS, 0.85, device=CPU)
        st, pr, out = fe.init_state(), fe.init_params(), []
        for xb in np.split(x, split):
            st, (o,) = fe.apply(st, pr, TStream.full(torch.from_numpy(xb)))
            out.append(o.data.numpy()[:int(o.count)])
        return np.concatenate(out)

    _close(run(2), run(1), 1e-6)


def test_frontend_retune_and_backend_validation():
    fe = twbfm.WBFMFrontend(_taps(), DECIM, 0.0, FS, 1.0, device=CPU)
    pr = dict(fe.init_params(), **params_from_numpy(
        twbfm.WBFMFrontend.freq_params(250e3, FS), CPU))
    assert int(pr["lo_inc"]) == int(jwbfm.WBFMFrontend.freq_params(250e3, FS)
                                    ["lo_inc"])
    with pytest.raises(ValueError, match="backend"):
        twbfm.WBFMFrontend(_taps(), DECIM, 0.0, FS, 1.0, backend="pallas",
                           device=CPU)


# ---------------------------------------------------------------------------
# the fused chain
# ---------------------------------------------------------------------------

def _chain_outputs(fg, step, states, params, blocks, jax_side):
    audio, quad = [], []
    for x in blocks:
        if jax_side:
            s = JStream.full(jnp.asarray(x), sample_rate=FS)
        else:
            s = TStream.full(torch.from_numpy(x), sample_rate=FS)
        states, o = step(states, params, {"iq": s})
        audio.append(np.asarray(o["audio"].data)[:int(o["audio"].count)])
        quad.append(np.asarray(o["quad"].data)[:int(o["quad"].count)])
    return np.concatenate(audio), np.concatenate(quad), states


@pytest.mark.parametrize("fused_backend", ["auto", "kernel"])
@pytest.mark.parametrize("squelch", [None, -20.0])
def test_fused_chain_matches_jax_chain(fused_backend, squelch):
    n = 1 << 13
    x = _fm_station(3 * n)
    blocks = [x[b * n:(b + 1) * n] for b in range(3)]
    kw = dict(block_size=n, center_freq=250e3, squelch_db=squelch, fused=True)
    jfg, jh = jwbfm.build_wbfm(jwbfm.WBFMConfig(**kw))
    tfg, th = twbfm.build_wbfm(twbfm.WBFMConfig(fused_backend=fused_backend,
                                                **kw), device=CPU)
    assert sorted(th) == sorted(jh) == ["channel", "frontend", "resampler"]
    assert th["channel"] is th["frontend"]
    ja, jq, _ = _chain_outputs(
        jfg, jax.jit(jfg.build_step()),
        jax.tree_util.tree_map(jnp.asarray, jfg.init_states()),
        jfg.init_params(), blocks, True)
    ta, tq, _ = _chain_outputs(tfg, tfg.build_step(), tfg.init_states(),
                               tfg.init_params(), blocks, False)
    assert len(ta) == len(ja) and len(tq) == len(jq)
    if squelch is None:
        _close(tq, jq, 1e-4)
    else:
        assert np.any(jq == 0.0)  # the gate opens inside the first block
        _gate_flips_only(tq, jq)
    assert snr_db(ja, ta) > 90.0


def test_fused_chain_matches_golden():
    """The fused chain against the golden unfused chain's outputs, at the
    bars of ``test_wbfm_chain_matches_golden``."""
    fix = np.load(FIX)
    iq = fix["wbfm_in"]
    cfg = twbfm.WBFMConfig(block_size=len(iq), center_freq=250e3, fused=True)
    fg, _ = twbfm.build_wbfm(cfg, device=CPU)
    audio, quad, _ = _chain_outputs(fg, fg.build_step(), fg.init_states(),
                                    fg.init_params(), [iq], False)
    w = 64
    assert snr_db(fix["wbfm_quad"][w:len(quad)], quad[w:]) > 55.0
    aw = 16
    m = min(len(audio), len(fix["wbfm_audio"]))
    assert m > 900
    assert snr_db(fix["wbfm_audio"][aw:m], audio[aw:m]) > 50.0
