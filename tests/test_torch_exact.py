"""Port exact arithmetic and tap tables == grbaz_tpu, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.ops import exact as jexact
from grbaz_tpu.ops import fir as jfir
from grbaz_tpu.ops import mmse as jmmse
from grbaz_tpu_torch.core.stream import limbs_add, limbs_add_i32
from grbaz_tpu_torch.ops import exact as texact
from grbaz_tpu_torch.ops import fir as tfir
from grbaz_tpu_torch.ops import mmse as tmmse

# wrap-heavy (phase0, inc) pairs: near 0, near 2^32, half turn, odd
PHASE_CASES = [(0, 1), (0xFFFFFFFF, 0xFFFFFFFF), (0x80000000, 0x7FFFFFFF),
               (987654321, 123456789), (0xFFFFFF00, 0x9E3779B9)]


def _t(v):
    return torch.tensor(int(v), dtype=torch.int64)


def _u32(a):
    return np.asarray(a).astype(np.uint32)


@pytest.mark.parametrize("phase0,inc", PHASE_CASES)
def test_phase_ramp_bit_exact(phase0, inc):
    n = 5000
    want = np.asarray(jexact.phase_ramp_u32(n, jnp.uint32(phase0),
                                            jnp.uint32(inc)))
    got = texact.phase_ramp_u32(n, _t(phase0), _t(inc)).numpy()
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("phase0,inc", PHASE_CASES)
def test_radians_and_oscillator(phase0, inc):
    n = 4096
    ph_j = jexact.phase_ramp_u32(n, jnp.uint32(phase0), jnp.uint32(inc))
    ph_t = texact.phase_ramp_u32(n, _t(phase0), _t(inc))
    # the angle conversion is the same f32 rounding: bit for bit
    np.testing.assert_array_equal(
        texact.turns_u32_to_radians(ph_t).numpy(),
        np.asarray(jexact.turns_u32_to_radians(ph_j)))
    for conj in (False, True):
        lo_j, after_j = jexact.oscillator(n, jnp.uint32(phase0),
                                          jnp.uint32(inc), conj=conj)
        lo_t, after_t = texact.oscillator(n, _t(phase0), _t(inc), conj=conj)
        assert int(after_t) == int(after_j)
        np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j),
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [1000, 1 << 16, (1 << 16) + 1, 200_000])
@pytest.mark.parametrize("mu0,inc_int,inc_frac", [
    (0, 1, 0x0AAAAAAB), (0xFFFFFFFF, 0, 0xFFFFFFFF),
    (0x12345678, 8, 0x80000001), (7, 3, 1)])
def test_fixed_positions_both_carry_forms(n, mu0, inc_int, inc_frac):
    """n <= 2^16 hits the JAX limb-product carries, n > 2^16 its cumsum
    of wrap-downs; the port's int64 closed form must equal both."""
    idx_j, frac_j = jexact.fixed_positions(n, jnp.uint32(mu0),
                                           jnp.int32(inc_int),
                                           jnp.uint32(inc_frac))
    idx_t, frac_t = texact.fixed_positions(
        n, _t(mu0), torch.tensor(inc_int, dtype=torch.int32), _t(inc_frac))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(_u32(frac_t.numpy()), np.asarray(frac_j))


def test_frac_to_phase_bin_exact(rng):
    frac = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    frac[:4] = [0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000]
    for log2 in (5, 7):
        want = np.asarray(jexact.frac_to_phase_bin(jnp.asarray(frac), log2))
        got = texact.frac_to_phase_bin(
            torch.from_numpy(frac.astype(np.int64)), log2).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("freq,rate", [(-250e3, 3.2e6), (1e3, 48e3),
                                       (3.3e6, 3.2e6), (0.0, 1.0)])
def test_host_converters_equal(freq, rate):
    assert texact.freq_to_turns_u32(freq, rate) == \
        jexact.freq_to_turns_u32(freq, rate)
    for ratio in (25 / 24, 8.333333, 1.0, 0.5):
        assert texact.ratio_to_fixed(ratio) == jexact.ratio_to_fixed(ratio)
    assert texact.ppb_to_fixed(1, 5e8) == jexact.ppb_to_fixed(1, 5e8)


def test_limbs_add_bit_exact(rng):
    lo = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    lo[:3] = 0xFFFFFFFF
    hi[:3] = 0xFFFFFFFF
    d = rng.integers(-2 ** 31, 2 ** 31, 1000).astype(np.int32)
    from grbaz_tpu.core.stream import limbs_add as jadd
    from grbaz_tpu.core.stream import limbs_add_i32 as jadd_i32
    t = (torch.from_numpy(lo.astype(np.int64)),
         torch.from_numpy(hi.astype(np.int64)))
    for jfn, tfn, delta in ((jadd, limbs_add, d.astype(np.uint32)),
                            (jadd_i32, limbs_add_i32, d)):
        wl, wh = jfn(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(delta))
        gl, gh = tfn(*t, torch.from_numpy(delta.astype(np.int64)))
        np.testing.assert_array_equal(_u32(gl.numpy()), np.asarray(wl))
        np.testing.assert_array_equal(_u32(gh.numpy()), np.asarray(wh))


def test_mmse_table_equal():
    np.testing.assert_array_equal(tmmse.TAPS_TABLE, jmmse.TAPS_TABLE)
    np.testing.assert_array_equal(tmmse.design_taps(6, 32, 0.4),
                                  jmmse.design_taps(6, 32, 0.4))


@pytest.mark.parametrize("window", ["hamming", "hann", "blackman",
                                    "blackmanharris", "rect"])
def test_tap_design_equal(window):
    args = (1.0, 3.2e6, 112.5e3, 75e3)
    lp_t = tfir.low_pass_taps(*args, window=window)
    np.testing.assert_array_equal(lp_t, jfir.low_pass_taps(*args,
                                                           window=window))
    bp = (2.0, 48e3, 3e3, 6e3, 2e3)
    np.testing.assert_array_equal(tfir.band_pass_taps(*bp, window=window),
                                  jfir.band_pass_taps(*bp, window=window))
    for decim in (1, 3, 8):
        np.testing.assert_array_equal(tfir.prepare_taps(lp_t, decim),
                                      jfir.prepare_taps(lp_t, decim))
