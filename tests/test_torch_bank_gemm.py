"""The channel bank's filter as one real-form matrix product, on the CPU.

``csrc/channel_bank.cu`` computes the bank's body as ``A @ B``: row k of
``A`` is the window of the block behind output k, re and im interleaved
(a strided view of the block: consecutive rows ``2*decim`` floats apart,
overlapping), and ``B`` packs each slot's rotated taps
``g_c[t] = h[t] * lo((t-(tpad-1))*inc_c)`` as ``[[Re g, Im g], [-Im g,
Re g]]``. The head outputs, which reach into each slot's rotated tail,
are summed in rotate-then-filter form; the body is rotated by
``lo_c(k*decim)``. This file builds that form in torch and holds it to the
bank's plain version (``ops/cuda/channel_bank.channel_bank_plain``), then
emulates TF32 operands (round to nearest, ties away, to 10 mantissa bits)
at the bank's shape: the split-precision product (3xTF32) stays inside
the port's 1e-5 bar, a plain TF32 product does not.
"""

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.ops import exact, fir
from grbaz_tpu_torch.ops.cuda import channel_bank as cb

FS = 3.2e6
TWO32 = 1 << 32


def _taps(decim, cutoff=112.5e3, transition=75e3):
    return torch.from_numpy(fir.prepare_taps(
        fir.low_pass_taps(1.0, FS, cutoff, transition), decim))


def _inputs(slots, n, decim, wrap, seed, **taps):
    gen = np.random.default_rng(seed)
    h = _taps(decim, **taps)

    def cn(*shape):
        return torch.from_numpy((gen.standard_normal(shape) + 1j
                                 * gen.standard_normal(shape)).astype(
                                     np.complex64))
    x, tail = cn(n), cn(slots, h.shape[0] - 1)
    if wrap:  # phases and increments that wrap every few samples
        ph = gen.integers(TWO32 - 4096, TWO32, slots)
        inc = gen.integers(2 ** 31, TWO32, slots)
    else:
        ph = gen.integers(0, TWO32, slots)
        inc = gen.integers(0, 2 ** 26, slots)
    return x, tail, h, decim, torch.from_numpy(ph), torch.from_numpy(inc)


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (cvt.rna.tf32.f32): to nearest, ties away
    from zero, the low 13 mantissa bits zero."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def product(a, b, operands="f32", ks=None):
    """``a @ b`` in float32 with ``f32`` operands, TF32 operands
    (``1xtf32``), or operands split as ``hi + lo`` with the ``lo @ lo``
    term dropped (``3xtf32``); with ``ks``, summed over slabs of ``ks``
    taps (``2*ks`` rows of ``b``), as the kernel takes a long filter."""
    if ks is not None:
        return sum(product(a[:, k:k + 2 * ks], b[k:k + 2 * ks], operands)
                   for k in range(0, b.shape[0], 2 * ks))
    if operands == "f32":
        return a @ b
    an, bn = a.numpy(), b.numpy()
    ah, bh = tf32(an), tf32(bn)
    if operands == "1xtf32":
        return torch.from_numpy(ah @ bh)
    al, bl = tf32(an - ah), tf32(bn - bh)
    return torch.from_numpy(al @ bh + ah @ bl + ah @ bh)


def real_form(x, tail, h, decim, phase0, lo_inc, operands="f32", ks=None):
    """The kernel's decomposition of the bank's filter: ``(y [C, n_out],
    new_tail [C, tpad-1])``."""
    slots, hist = tail.shape
    tpad, n = h.shape[0], x.shape[0]
    n_out = n // decim
    k_head = -(-hist // decim)
    kh = min(k_head, n_out)
    # A: overlapping rows of a front-padded block (rows k < k_head read the
    # padding; the head replaces them)
    xf = torch.view_as_real(torch.cat([x.new_zeros(hist), x])).reshape(-1)
    a = xf.as_strided((n_out, 2 * tpad), (2 * decim, 1))
    t = torch.arange(-hist, 1)
    g = h * exact.lo_at(torch.zeros((), dtype=torch.int64),
                        lo_inc[:, None], t)                   # [C, tpad]
    b = torch.empty(tpad, 2, slots, 2)
    b[:, 0, :, 0], b[:, 0, :, 1] = g.real.T, g.imag.T
    b[:, 1, :, 0], b[:, 1, :, 1] = -g.imag.T, g.real.T
    p = product(a, b.reshape(2 * tpad, 2 * slots), operands, ks)
    body = torch.complex(p[:, 0::2], p[:, 1::2]).T            # [C, n_out]
    k = torch.arange(n_out)
    y = body * exact.lo_at(phase0[:, None], lo_inc[:, None], k * decim)
    # head outputs, rotate-then-filter from the rotated tail
    i = torch.arange(kh * decim)
    head = torch.cat([tail, x[:kh * decim] * exact.lo_at(
        phase0[:, None], lo_inc[:, None], i)], dim=1)
    for c in range(slots):
        y[c, :kh] = fir.fir_decimate_frame(head[c], h, decim)
    # the new tail: the frame's last hist samples
    j = torch.arange(n - hist, n)
    rot = x[j.clamp(min=0)] * exact.lo_at(phase0[:, None], lo_inc[:, None],
                                          j)
    old = tail[:, (j + hist).clamp(max=hist - 1)]
    return y, torch.where(j < 0, old, rot)


def _rel(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("n,decim", [(1 << 17, 8), (8192 + 24, 8), (1000, 4),
                                     (37, 8)])
@pytest.mark.parametrize("slots", [1, 3, 16, 20])
def test_real_form_equals_the_plain_version(slots, n, decim, wrap):
    """The real-form product, the head from the rotated tail, the output
    rotation and the new tail equal the bank's plain version within 1e-5
    of its max, for short blocks (all head, n < tpad-1) and long."""
    args = _inputs(slots, n, decim, wrap, seed=slots * 1000 + n + wrap)
    y, tail = real_form(*args)
    ref_y, ref_tail = cb.channel_bank_plain(*args)
    assert y.shape == ref_y.shape == (slots, n // decim)
    assert tail.shape == ref_tail.shape == args[1].shape
    if n // decim:
        assert _rel(y, ref_y) < 1e-5
    assert _rel(tail, ref_tail) < 1e-5


def test_tf32_rounding():
    """Round to nearest with ties away from zero, 10 mantissa bits kept."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    v = np.array([one, one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                  -(one + ulp / 2), np.float32(3.0e-3)], np.float32)
    got = tf32(v)
    np.testing.assert_array_equal(got[:5], [one, one + ulp, one, one + ulp,
                                            -(one + ulp)])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(got[5] - v[5]) <= v[5] * 2.0 ** -11


@pytest.mark.parametrize("operands,inside", [("3xtf32", True),
                                             ("1xtf32", False)])
def test_split_tf32_meets_the_bar_at_the_bank_shape(operands, inside):
    """16 slots over a 2^17-sample block of noise at the scanner's
    channels: the 3xTF32 product within 1e-5 of the plain version's max
    (about 1e-6), a plain TF32 product outside it (about 3e-4)."""
    x, tail, h, decim, ph, _ = _inputs(16, 1 << 17, 8, False, seed=7)
    inc = torch.tensor([int(exact.freq_to_turns_u32(-f, FS))
                        for f in np.linspace(-1.2e6, 1.2e6, 16)])
    ref, _ = cb.channel_bank_plain(x, tail, h, decim, ph, inc)
    got, _ = real_form(x, tail, h, decim, ph, inc, operands)
    err = _rel(got, ref)
    assert (err < 1e-5) == inside, err
    if inside:
        assert err > 1e-8  # the emulation rounds
    else:
        assert err > 1e-4


@pytest.mark.parametrize("operands,ks", [("f32", 392), ("3xtf32", 392),
                                         ("3xtf32", 80)])
def test_long_filter_in_slabs_meets_the_bar(operands, ks):
    """A narrow-band plan (12.5 kHz channels, 5 kHz transition: 1544
    taps), its product summed over slabs of taps as the kernel takes it
    (392 taps: 4 slabs; 80: 20), within 1e-5 of the plain version's max,
    the 3xTF32 product too."""
    x, tail, h, decim, ph, inc = _inputs(4, 1 << 15, 8, True, seed=11,
                                         cutoff=8.75e3, transition=5e3)
    assert h.shape[0] == 1544
    ref, ref_tail = cb.channel_bank_plain(x, tail, h, decim, ph, inc)
    got, got_tail = real_form(x, tail, h, decim, ph, inc, operands, ks)
    assert _rel(got, ref) < 1e-5
    assert _rel(got_tail, ref_tail) < 1e-5
