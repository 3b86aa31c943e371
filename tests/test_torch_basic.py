"""Port basic blocks (ops/basic.py) == grbaz_tpu on the CPU.

Each block runs over chained blocks with partial counts through the JAX
package and the port (tests/torch_parity.py). The integer, conversion,
delay, keep-one-in-n, bit-packing and hysteresis blocks are bit-equal,
counts included: the three wire conversions keep their input's count, as
the JAX package's ``block_from_fn`` gives them. Float math whose
rounding the two libraries may place differently (``abs``, ``atan2``,
``PowCC``'s exp/log) agrees within 1e-6 of the max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.ops import basic as jb
from grbaz_tpu_torch.convert import params_from_numpy, to_numpy
from grbaz_tpu_torch.ops import basic as tb
from tests.torch_parity import jax_run, port_run, split

CPU = "cpu"


def assert_outputs(jo, to, rel=None):
    """Every port of every block: counts equal, data bit-equal (or within
    ``rel`` of the max)."""
    assert len(jo) == len(to)
    for j, t in zip(jo, to):
        for (jd, jc), (td, tc) in zip(j, t):
            assert jc == tc
            assert jd.shape == td.shape and jd.dtype == td.dtype, \
                (jd.shape, td.shape, jd.dtype, td.dtype)
            if rel is None:
                np.testing.assert_array_equal(jd, td)
            elif jd.size:
                scale = max(float(np.abs(jd).max()), 1e-30)
                assert float(np.abs(jd - td).max()) <= rel * scale


def assert_state(js, ts):
    if js is None:
        assert ts is None
        return
    for k, v in js.items():
        np.testing.assert_array_equal(np.asarray(v), to_numpy(ts[k]), k)


def cplx(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def run_both(jblk, tblk, blocks, counts, params_seq=None):
    """Both blocks over ``blocks``; ``params_seq`` (numpy params per
    block) retunes them between blocks."""
    if params_seq is None:
        jo, js = jax_run(jblk, blocks, counts)
        to, ts = port_run(tblk, blocks, counts)
        return jo, js, to, ts
    jo, to, js, ts = [], [], None, None
    for b, (d, c, pr) in enumerate(zip(blocks, counts, params_seq)):
        o, js = jax_run(jblk, [d], [c], state=js, params=pr)
        jo += o
        o, ts = port_run(tblk, [d], [c], state=ts,
                         params=params_from_numpy(pr, CPU))
        to += o
    return jo, js, to, ts


PARTIAL = [256, 256, 200]    # the last block partial


def three_blocks(x, bs=256):
    blocks, _ = split(np.concatenate([x, x[:bs]])[:3 * bs], bs)
    return blocks


# ---------------------------------------------------------------------------
# element-wise blocks
# ---------------------------------------------------------------------------

UNARY_EXACT = ["conjugate", "complex_to_mag_squared", "real_part",
               "imag_part"]


@pytest.mark.parametrize("name", UNARY_EXACT)
def test_unary_complex_blocks_bit_equal(rng, name):
    blocks = three_blocks(cplx(rng, 768))
    jo, _, to, _ = run_both(getattr(jb, name)(), getattr(tb, name)(),
                            blocks, PARTIAL)
    assert_outputs(jo, to)


@pytest.mark.parametrize("name", ["complex_to_mag", "complex_to_arg"])
def test_unary_complex_blocks_within_rounding(rng, name):
    x = cplx(rng, 768)
    x[:4] = [0, 1, -1j, -1]   # the axes and the origin
    jo, _, to, _ = run_both(getattr(jb, name)(), getattr(tb, name)(),
                            three_blocks(x), PARTIAL)
    assert_outputs(jo, to, rel=1e-6)


@pytest.mark.parametrize("k", [2.5, -0.75])
@pytest.mark.parametrize("name", ["multiply_const", "add_const"])
def test_const_blocks(rng, name, k):
    for x in (cplx(rng, 768), rng.standard_normal(768).astype(np.float32)):
        jo, _, to, _ = run_both(getattr(jb, name)(k), getattr(tb, name)(k),
                                three_blocks(x), PARTIAL)
        assert_outputs(jo, to)


@pytest.mark.parametrize("name", ["multiply", "add", "float_to_complex"])
def test_binary_blocks(rng, name):
    a = rng.standard_normal(768).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    blocks = list(zip(three_blocks(a), three_blocks(b)))
    counts = [(c, c) for c in PARTIAL]
    jo, _, to, _ = run_both(getattr(jb, name)(), getattr(tb, name)(),
                            blocks, counts)
    assert_outputs(jo, to)


# ---------------------------------------------------------------------------
# wire conversions (count keeps the input's, as in the JAX package)
# ---------------------------------------------------------------------------

def test_uchar_iq_to_complex_bit_equal_and_count(rng):
    x = rng.integers(0, 256, 1536).astype(np.uint8)
    x[:4] = [0, 255, 127, 128]
    blocks, _ = split(x, 512)
    counts = [512, 512, 300]
    jo, _, to, _ = run_both(jb.uchar_iq_to_complex(),
                            tb.uchar_iq_to_complex(), blocks, counts)
    assert_outputs(jo, to)
    assert [o[0][1] for o in to] == counts      # twice the samples
    assert to[0][0][0].shape == (256,)


def test_ishort_to_complex_bit_equal_and_count(rng):
    x = rng.integers(-32768, 32768, 1024).astype(np.int16)
    x[:4] = [-32768, 32767, 0, -1]
    blocks, _ = split(x, 512)
    jo, _, to, _ = run_both(jb.ishort_to_complex(), tb.ishort_to_complex(),
                            blocks, [512, 100])
    assert_outputs(jo, to)
    assert [o[0][1] for o in to] == [512, 100]


def test_complex_to_ishort_rounds_half_to_even_and_saturates(rng):
    x = cplx(rng, 512) * 0.3
    # exact halves after the 32767 scale, and values past full scale
    halves = (np.arange(-6, 6) + 0.5) / 32767.0
    x[:12] = (halves + 1j * halves[::-1]).astype(np.complex64)
    x[12:16] = [2 + 0j, -2 + 0j, 1.5j, -1.5j]
    blocks, _ = split(x, 256)
    jo, _, to, _ = run_both(jb.complex_to_ishort(), tb.complex_to_ishort(),
                            blocks, [256, 99])
    assert_outputs(jo, to)
    assert to[0][0][0].dtype == np.int16
    assert [o[0][1] for o in to] == [256, 99]   # half its values


def test_int16_round_trip(rng):
    """complex -> int16 -> complex comes back within half an LSB a
    component, in the port alone."""
    from grbaz_tpu_torch.core.stream import Stream, StreamMeta
    x = np.clip(cplx(rng, 512).view(np.float32) * 0.25, -0.99, 0.99).view(
        np.complex64)  # inside full scale
    meta = StreamMeta.start(1.0, device=CPU)
    _, (w,) = tb.complex_to_ishort()(Stream.full(torch.from_numpy(x), meta))
    _, (back,) = tb.ishort_to_complex()(w)
    err = np.abs(back.data.numpy() - x).max()
    assert err <= 0.5 / 32767.0 * np.sqrt(2) + 1e-7


# ---------------------------------------------------------------------------
# PowCC and SwapIQ (runtime params)
# ---------------------------------------------------------------------------

def test_pow_cc_within_1e6_across_retunes(rng):
    x = cplx(rng, 768)
    x[5] = 0
    blocks = three_blocks(x)
    jblk, tblk = jb.PowCC(2.0, 0.5), tb.PowCC(2.0, 0.5, device=CPU)
    ps = [dict(exponent=np.float32(e), div_exp=np.float32(d))
          for e, d in ((2.0, 0.5), (3.0, 0.0), (0.5, 1.5))]
    jo, _, to, _ = run_both(jblk, tblk, blocks, PARTIAL, ps)
    assert_outputs(jo, to, rel=1e-6)


def test_swap_iq_both_ways(rng):
    blocks = three_blocks(cplx(rng, 768))
    ps = [dict(swap=np.bool_(s)) for s in (True, False, True)]
    jo, _, to, _ = run_both(jb.SwapIQ(), tb.SwapIQ(device=CPU), blocks,
                            PARTIAL, ps)
    assert_outputs(jo, to)


# ---------------------------------------------------------------------------
# blocks with stream memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_variable_delay_changes_mid_run(rng, dtype):
    x = cplx(rng, 1280) if dtype == np.complex64 else \
        rng.standard_normal(1280).astype(np.float32)
    blocks, _ = split(x, 256)
    ps = [dict(delay=np.int32(d)) for d in (5, 5, 40, 12, 64)]
    jdt = jnp.complex64 if dtype == np.complex64 else jnp.float32
    tdt = torch.complex64 if dtype == np.complex64 else torch.float32
    jblk = jb.VariableDelay(64, 5, dtype=jdt)
    tblk = tb.VariableDelay(64, 5, dtype=tdt, device=CPU)
    jo, js, to, ts = run_both(jblk, tblk, blocks, [256, 256, 256, 100, 256],
                              ps)
    assert_outputs(jo, to)
    assert_state(js, ts)
    assert not to[2][0][0][:35].any()   # the zero-fill of a longer delay


@pytest.mark.parametrize("n,bs", [(7, 256), (1000, 256), (3, 100)])
def test_keep_one_in_n_across_blocks(rng, n, bs):
    x = cplx(rng, 6 * bs)
    blocks, _ = split(x, bs)
    counts = [bs, bs, bs // 2, bs, bs, bs - 3]
    jblk = jb.KeepOneInN(n, bs)
    tblk = tb.KeepOneInN(n, bs, device=CPU)
    jo, js, to, ts = run_both(jblk, tblk, blocks, counts)
    assert_outputs(jo, to)
    assert_state(js, ts)


@pytest.mark.parametrize("msb", [True, False])
def test_bit_packing_both_ways(rng, msb):
    bits = rng.integers(0, 2, 512).astype(np.uint8)
    blocks, _ = split(bits, 128)
    counts = [128, 128, 64, 120]
    jo, _, to, _ = run_both(jb.UnpackedToPacked(msb),
                            tb.UnpackedToPacked(msb, device=CPU), blocks,
                            counts)
    assert_outputs(jo, to)
    packed = [o[0][0] for o in to]
    jo, _, to, _ = run_both(jb.PackedToUnpacked(msb),
                            tb.PackedToUnpacked(msb, device=CPU), packed,
                            [16, 16, 8, 15])
    assert_outputs(jo, to)
    np.testing.assert_array_equal(to[0][0][0], blocks[0])


@pytest.mark.parametrize("initial", [0.0, 1.0])
def test_hysteresis_bit_equal_with_partial_blocks(rng, initial):
    x = np.repeat(rng.uniform(-1.5, 1.5, 96), 8).astype(np.float32)
    x[:200] = 0.0          # a first block with no decisive sample at its head
    blocks, _ = split(x, 256)
    jblk = jb.Hysteresis(-0.5, 0.5, initial)
    tblk = tb.Hysteresis(-0.5, 0.5, initial, device=CPU)
    jo, js, to, ts = run_both(jblk, tblk, blocks, [256, 100, 256])
    assert_outputs(jo, to)
    assert_state(js, ts)
