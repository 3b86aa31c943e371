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
