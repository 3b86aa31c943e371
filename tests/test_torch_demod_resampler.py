"""Port demod blocks, one-pole scan and resampler == grbaz_tpu."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.ops import demod as jdemod
from grbaz_tpu.ops import iir as jiir
from grbaz_tpu.ops import resampler as jres
from grbaz_tpu_torch.convert import params_from_numpy
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.ops import demod as tdemod
from grbaz_tpu_torch.ops import iir as tiir
from grbaz_tpu_torch.ops import resampler as tres
from tests.conftest import snr_db

CPU = "cpu"
REL = 1e-5


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if ref.size:
        assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


def _run(jblk, tblk, blocks, counts, params_seq=None, compare_state=True):
    jst = jax.tree_util.tree_map(jnp.asarray, jblk.init_state())
    tst = tblk.init_state()
    params_seq = params_seq or [jblk.init_params()] * len(blocks)
    for x, c, pr in zip(blocks, counts, params_seq):
        js = JStream(jnp.asarray(x), jnp.int32(c),
                     JStream.full(jnp.asarray(x)).meta)
        ts = TStream.full(torch.from_numpy(x))
        ts.count = torch.tensor(c, dtype=torch.int32)
        jst, (jy,) = jblk.apply(jst, pr, js)
        tst, (ty,) = tblk.apply(tst, params_from_numpy(pr, CPU), ts)
        assert int(ty.count) == int(jy.count)
        n = int(jy.count)
        _close(ty.data.numpy()[:n], np.asarray(jy.data)[:n])
        if compare_state:
            _close(ty.data.numpy(), np.asarray(jy.data))
            for k in jst:
                _close(tst[k].numpy(), np.asarray(jst[k]))


def _fm(rng, n, blocks=3):
    t = np.arange(n * blocks)
    ph = 2 * np.pi * 0.05 * t + 3 * np.sin(2 * np.pi * 1e-3 * t)
    x = (np.exp(1j * ph) * (1 + 0.1 * rng.standard_normal(t.size))) \
        .astype(np.complex64)
    return [x[i * n:(i + 1) * n] for i in range(blocks)]


@pytest.mark.parametrize("a", [0.0, 0.3, 0.756, 0.9999, 1.0])
@pytest.mark.parametrize("n", [1, 5, 1000, 70_000])
def test_onepole_scan_matches_jax(rng, a, n):
    b = rng.standard_normal(n).astype(np.float32)
    y0 = np.float32(0.7)
    ref = np.asarray(jiir.onepole_scan(jnp.asarray(b), a, jnp.float32(y0)))
    got = tiir.onepole_scan(torch.from_numpy(b), a, torch.tensor(y0))
    # both are f32 sums in another order: 1e-5 of the run's magnitude
    _close(got.numpy(), ref)


def test_onepole_scan_tensor_pole_and_serial(rng):
    b = rng.standard_normal(3000).astype(np.float32)
    a = np.float32(0.995)
    want, y = np.empty(3000), 0.25
    for k in range(3000):
        y = float(a) * y + float(b[k])
        want[k] = y
    got = tiir.onepole_scan(torch.from_numpy(b), torch.tensor(a),
                            torch.tensor(0.25))
    _close(got.numpy(), want)


def test_state_at_count(rng):
    y = torch.from_numpy(rng.standard_normal(10).astype(np.float32))
    fb = torch.tensor(-1.0)
    for c in (0, 1, 7, 10):
        got = tiir.state_at_count(y, torch.tensor(c, dtype=torch.int32), fb)
        want = jiir.state_at_count(jnp.asarray(y.numpy()), jnp.int32(c),
                                   jnp.float32(-1.0))
        assert float(got) == float(want)


@pytest.mark.parametrize("partial", [False, True])
def test_quadrature_demod_matches_jax(rng, partial):
    n = 4096
    blocks = _fm(rng, n)
    counts = [n, 0 if partial else n, n - 100 if partial else n]
    _run(jdemod.QuadratureDemod(1.3), tdemod.QuadratureDemod(1.3, device=CPU),
         blocks, counts)


@pytest.mark.parametrize("partial", [False, True])
def test_power_squelch_matches_jax(rng, partial):
    n = 4096
    blocks = _fm(rng, n)
    blocks[1][: n // 2] *= 0.01  # a quiet stretch the gate closes on
    counts = [n, n - 1000 if partial else n, 0 if partial else n]
    _run(jdemod.PowerSquelch(-3.0, alpha=1e-2),
         tdemod.PowerSquelch(-3.0, alpha=1e-2, device=CPU), blocks, counts)


@pytest.mark.parametrize("partial", [False, True])
def test_fm_deemphasis_matches_jax(rng, partial):
    n = 3000
    blocks = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    counts = [n, n - 1234 if partial else n, 0 if partial else n]
    _run(jdemod.FMDeemphasis(48e3), tdemod.FMDeemphasis(48e3, device=CPU),
         blocks, counts)


def _resampler_case(rng, ratio, n, dtype):
    t = np.arange(3 * n)
    x = np.exp(2j * np.pi * 0.013 * t) + 0.3 * np.exp(-2j * np.pi * 0.05 * t)
    x = x.astype(np.complex64)
    if dtype == np.float32:
        x = x.real.copy()
    return [x[i * n:(i + 1) * n] for i in range(3)]


@pytest.mark.parametrize("ratio", [25 / 24, 8.333333333333334, 1.7, 0.8])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_fractional_resampler_matches_jax(rng, ratio, dtype):
    """The port's block (generic form) == the JAX block, which takes its
    polyphase form for the rational ratios; a ppb-scale retune and a
    partial block are included."""
    n = 2048
    blocks = _resampler_case(rng, ratio, n, dtype)
    jblk = jres.FractionalResampler(n, ratio, dtype=dtype)
    tblk = tres.FractionalResampler(
        n, ratio, dtype=torch.from_numpy(blocks[0]).dtype, device=CPU)
    assert tblk.capacity == jblk.capacity
    p0 = jblk.init_params()
    p1 = jres.FractionalResampler.ratio_params(ratio * (1 + 3e-7))
    _run(jblk, tblk, blocks, [n, n, n - 333], [p0, p1, p1],
         compare_state=False)


@pytest.mark.parametrize("mu_int", [3, 7, 70, -2])
def test_rational_form_equals_generic_and_jax(rng, mu_int):
    """Both forms of the port, and the JAX rational form, agree; a
    start outside [0, 64] makes the guard select the generic result."""
    p, q = 25, 24
    cap = 2200
    frame = rng.standard_normal(tres.HIST + 2048).astype(np.float32)
    inc_int, inc_frac = jres.exact.ratio_to_fixed(p / q)
    args_j = (jnp.asarray(frame), jnp.int32(mu_int), jnp.uint32(123456),
              jnp.int32(inc_int), jnp.uint32(inc_frac), cap,
              jres.TAPS_TABLE)
    taps = torch.from_numpy(tres.TAPS_TABLE)
    args_t = (torch.from_numpy(frame), torch.tensor(mu_int, dtype=torch.int32),
              torch.tensor(123456), torch.tensor(int(inc_int),
                                                 dtype=torch.int32),
              torch.tensor(int(inc_frac)), cap, taps)
    ref = jres.resample_block_rational(*args_j, p, q)
    fast = tres.resample_block_rational(*args_t, p, q)
    gen = tres.resample_block(*args_t)
    for got in (fast, gen):
        assert int(got[1]) == int(ref[1])
        assert int(got[2]) == int(ref[2])
        assert int(got[3]) == int(ref[3])
        _close(got[0].numpy(), np.asarray(ref[0]))


def test_resampler_matches_golden():
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "golden.npz"))
    x = torch.from_numpy(fix["rs_in"])
    n = int(x.shape[0])
    rs = tres.FractionalResampler(n, float(fix["rs_ratio"]), device=CPU)
    _, (y,) = rs.apply(rs.init_state(), rs.init_params(), TStream.full(x))
    got = y.data.numpy()[: int(y.count)]
    want = fix["rs_out"]
    m = min(len(got), len(want))
    assert m >= len(want) - 2
    assert snr_db(want[:m], got[:m]) > 90.0


def test_rational_of_matches_jax():
    for r in (25 / 24, 125 / 24, 8.333333333333334, 1.7, np.pi):
        assert tres._rational_of(r) == jres._rational_of(r)


# ---------------------------------------------------------------------------
# AMDemod, onepole_lowpass
# ---------------------------------------------------------------------------

def _am(rng, n, blocks=3):
    t = np.arange(n * blocks)
    x = (0.5 * (1 + 0.8 * np.sin(2 * np.pi * 1e-3 * t))
         * np.exp(2j * np.pi * 0.01 * t)
         + 0.01 * (rng.standard_normal(t.size)
                   + 1j * rng.standard_normal(t.size))).astype(np.complex64)
    return [x[i * n:(i + 1) * n] for i in range(blocks)]


@pytest.mark.parametrize("partial", [False, True])
def test_am_demod_matches_jax(rng, partial):
    n = 4096
    blocks = _am(rng, n)
    counts = [n, n - 1000 if partial else n, 0 if partial else n]
    _run(jdemod.AMDemod(1e-3, 2.0), tdemod.AMDemod(1e-3, 2.0, device=CPU),
         blocks, counts)


def test_am_demod_retunes(rng):
    n = 2048
    blocks = _am(rng, n)
    p0 = jdemod.AMDemod(1e-3, 2.0).init_params()
    p1 = dict(alpha=np.float32(5e-3), gain=np.float32(0.5))
    _run(jdemod.AMDemod(1e-3, 2.0), tdemod.AMDemod(1e-3, 2.0, device=CPU),
         blocks, [n] * 3, [p0, p1, p1])


def test_am_demod_partial_block_state_invariance(rng):
    """As tests/test_agc_demod.py holds the JAX block: the stream cut into
    full blocks and into partial blocks of a larger capacity gives the
    same outputs bit for bit."""
    n, bs, cap = 8192, 1024, 2048
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)

    def run(capacity):
        blk = tdemod.AMDemod(1e-3, device=CPU)
        st, pr, out = blk.init_state(), blk.init_params(), []
        for i in range(0, n, bs):
            d = np.zeros(capacity, np.complex64)
            d[:bs] = x[i:i + bs]
            s = TStream.full(torch.from_numpy(d))
            s.count = torch.tensor(bs, dtype=torch.int32)
            st, (y,) = blk.apply(st, pr, s)
            out.append(y.data.numpy()[:int(y.count)])
        return np.concatenate(out)

    np.testing.assert_array_equal(run(bs), run(cap))


@pytest.mark.parametrize("alpha", [1e-3, 0.25, 1.0])
def test_onepole_lowpass_matches_jax(rng, alpha):
    x = rng.standard_normal(5000).astype(np.float32)
    ref = np.asarray(jiir.onepole_lowpass(jnp.asarray(x), alpha,
                                          jnp.float32(0.3)))
    got = tiir.onepole_lowpass(torch.from_numpy(x), alpha, torch.tensor(0.3))
    _close(got.numpy(), ref)
    got_t = tiir.onepole_lowpass(torch.from_numpy(x),
                                 torch.tensor(np.float32(alpha)),
                                 torch.tensor(0.3))
    _close(got_t.numpy(), ref)


# ---------------------------------------------------------------------------
# VariableRatioResampler (the ratio-stream mode)
# ---------------------------------------------------------------------------

def _vrr_run(jblk, tblk, xs, rrs, counts):
    """Both blocks over chained blocks: per block (counts, q, mu, flags)
    equal, outputs within 1e-6 of the max."""
    jst = jax.tree_util.tree_map(jnp.asarray, jblk.init_state())
    tst = tblk.init_state()
    outs = []
    for x, r, c in zip(xs, rrs, counts):
        jm = JStream.full(jnp.asarray(x)).meta
        jst, (jy,) = jblk.apply(
            jst, None, JStream(jnp.asarray(x), jnp.int32(c), jm),
            JStream(jnp.asarray(r), jnp.int32(c), jm))
        tx = TStream.full(torch.from_numpy(x))
        tx.count = torch.tensor(c, dtype=torch.int32)
        tst, (ty,) = tblk.apply(tst, None, tx,
                                TStream.full(torch.from_numpy(r)))
        assert int(ty.count) == int(jy.count)
        assert int(ty.meta.flags) == int(jy.meta.flags)
        assert int(tst["q_int"]) == int(jst["q_int"])
        assert int(tst["mu_frac"]) == int(jst["mu_frac"])
        np.testing.assert_array_equal(tst["tail"].numpy(),
                                      np.asarray(jst["tail"]))
        np.testing.assert_array_equal(tst["rr_tail"].numpy(),
                                      np.asarray(jst["rr_tail"]))
        _close(ty.data.numpy(), np.asarray(jy.data), rel=1e-6)
        outs.append((int(ty.count), int(ty.meta.flags)))
    return outs


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("per_input,partial", [(2.0, False), (2.0, True),
                                               (0.6, False)])
def test_variable_ratio_resampler_matches_jax(rng, dtype, per_input,
                                              partial):
    """Counts, q_int, mu_frac, tails and flags equal, outputs within 1e-6
    of the max; too small an output budget (0.6 outputs an input against
    a ratio near 1.3) raises BUFFER_OVERRUN as the JAX block does."""
    n, blocks = 512, 3
    x = rng.standard_normal(n * blocks).astype(np.float32)
    if dtype == np.complex64:
        x = (x + 1j * rng.standard_normal(n * blocks)).astype(np.complex64)
    rr = (1.3 + 0.05 * np.sin(np.arange(n * blocks) * 0.01)) \
        .astype(np.float32)
    jdt = jnp.float32 if dtype == np.float32 else jnp.complex64
    tdt = torch.float32 if dtype == np.float32 else torch.complex64
    jblk = jres.VariableRatioResampler(n, per_input, dtype=jdt)
    tblk = tres.VariableRatioResampler(n, per_input, dtype=tdt, device=CPU)
    assert tblk.capacity == jblk.capacity
    counts = [n, n - 77 if partial else n, n]
    outs = _vrr_run(jblk, tblk, [x[b * n:(b + 1) * n] for b in range(blocks)],
                    [rr[b * n:(b + 1) * n] for b in range(blocks)], counts)
    overrun = TStream.full(torch.zeros(1)).meta.flags | 0x04
    if per_input < 1.0:
        assert all(f == int(overrun) for _, f in outs)
    elif not partial:
        assert all(f == 0 for _, f in outs)


def test_variable_ratio_stream_mode_against_serial_model(rng):
    """tests/test_resampler.py's serial model of the reference loop (emit
    at (ii, mu), read inc = rr[ii], mu += inc, ii += floor), the port on
    the CPU within 80 dB."""
    from grbaz_tpu_torch.ops.mmse import NSTEPS_LOG2, NTAPS, TAPS_TABLE
    n, blocks = 512, 3
    gen = np.random.default_rng(31)
    x = gen.standard_normal(n * blocks).astype(np.float32)
    rr = (1.3 + 0.05 * np.sin(np.arange(n * blocks) * 0.01)) \
        .astype(np.float32)
    frame = np.concatenate([np.zeros(tres.HIST, np.float32), x])
    rrf = np.concatenate([np.zeros(tres.HIST, np.float32), rr])
    q, mu, ref = tres.HIST, 0, []
    shift = 32 - NSTEPS_LOG2 - 1
    while q + NTAPS <= len(frame):
        bin_ = ((mu >> 1) + (1 << (shift - 1))) >> shift
        ref.append(float(frame[q:q + NTAPS] @ TAPS_TABLE[bin_]))
        inc = float(rrf[q])
        ip = int(np.floor(inc))
        fr = int(np.float32(inc - ip) * (2.0 ** 32)) & 0xFFFFFFFF
        s = mu + fr
        q += ip + (s >> 32)
        mu = s & 0xFFFFFFFF
    ref = np.asarray(ref, np.float32)
    blk = tres.VariableRatioResampler(n, dtype=torch.float32, device=CPU)
    st, got = blk.init_state(), []
    for b in range(blocks):
        st, (y,) = blk.apply(
            st, None, TStream.full(torch.from_numpy(x[b * n:(b + 1) * n])),
            TStream.full(torch.from_numpy(rr[b * n:(b + 1) * n])))
        got.append(y.data.numpy()[:int(y.count)])
    got = np.concatenate(got)
    m = min(len(got), len(ref))
    assert m > 0.9 * len(ref)
    assert snr_db(ref[:m], got[:m]) > 80


def test_chip_smoke_am_path_on_the_cpu():
    """chip_smoke.py's AM scene and graph (channel at decim 16, AMDemod,
    the ratio-stream resampler into 48 kHz, the channel's spectrum),
    rehearsed on the CPU over three blocks: the tone back within 5 Hz
    above 30 dB SINAD and the carrier in the spectrum's centre bin."""
    import chip_smoke as cs
    feeds = cs.am_scene(torch.device(CPU))[:3]
    outs, flags, _ = cs.run_inputs(cs.am_graph(CPU), feeds, cs.AM_FS)
    audio = torch.cat(cs.valid(outs, "audio")[1:]).numpy()
    f, sinad = cs.tone_sinad(audio, cs.AUDIO_RATE)
    assert abs(f - cs.TONE_HZ) < 5.0 and sinad > 30.0
    spec = outs[-1]["spectra"][0][: int(outs[-1]["spectra"][1])]
    assert int(spec.mean(dim=0).argmax()) == cs.AM_FFT // 2
    assert not any(fl["audio"] for fl in flags)
