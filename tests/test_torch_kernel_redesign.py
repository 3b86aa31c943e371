"""The arithmetic and the tiling of the redesigned polyphase FIR kernels
(``csrc/polyphase_fir.cuh``: the channelizer B1/B4 and the decimating
FIR B3), on the CPU.

* B1's factored form -- B2's rotated taps over the raw samples, then one
  LO rotation per output -- equals rotate-then-filter (the plain twins)
  and the JAX kernels in interpret mode, under the block and the frame
  conventions;
* B3's block entry point equals the JAX kernel on ``concat(tail[1:], x)``;
* the host's launch geometry covers every output exactly once, fits in
  shared memory and keeps the window loads free of bank conflicts;
* a step-by-step model of the kernel's staging and register window
  (same slots, same loop order, NaN in every slot it never stages)
  reproduces the plain twins of B1, B2 and B3 for every geometry it may
  be given;
* the kernel library is rebuilt when a shared header changes.

Bar: max-abs error < 1e-5 * max|reference|.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from grbaz_tpu.ops import fir as jfir
from grbaz_tpu.ops.pallas import fir_decimate_frame_pallas
from grbaz_tpu.ops.pallas import wbfm_frontend as jwf
from grbaz_tpu_torch.ops.cuda import build, tiling
from grbaz_tpu_torch.ops.cuda import fir_decimate as tfd
from grbaz_tpu_torch.ops.cuda import xlating_fir as txf
from grbaz_tpu_torch.ops.cuda import xlating_fir_ctaps as txc
from grbaz_tpu_torch.ops.wbfm_frontend import rotate_output, rotated_taps

FS = 3.2e6
WRAPS = [(0xFFFFF000, 0x9E3779B9), (3123456789, 3123456789),
         (0x9E3779B9, 0xFFFFF000)]


def _cnoise(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def _taps(decim, cutoff=112.5e3, transition=75e3):
    return jfir.prepare_taps(jfir.low_pass_taps(1.0, FS, cutoff, transition),
                             decim)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < rel * np.abs(ref).max()


def _t(v):
    return torch.tensor(v)


# ---------------------------------------------------------------------------
# B1 / B4: the factored form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ph,inc", WRAPS)
@pytest.mark.parametrize("decim,n", [(8, 8192), (4, 8192), (5, 8190),
                                     (8, 8192 + 3), (4, 1001), (8, 37),
                                     (5, 9)])
def test_b1_factored_form_matches_rotate_then_filter(rng, ph, inc, decim, n):
    h = _taps(decim)
    x, tail = _cnoise(rng, n), _cnoise(rng, h.shape[0])
    args = (torch.from_numpy(x), torch.from_numpy(tail), torch.from_numpy(h),
            decim)
    got = rotate_output(txc.xlating_fir_ctaps_block_plain(*args, _t(inc)),
                        _t(ph), _t(inc), decim).numpy()
    ref = txf.xlating_fir_block_plain(*args, _t(ph), _t(inc)).numpy()
    assert got.shape == (n // decim,)
    _close(got, ref)
    if jwf.supported(n, decim) and n % 128 == 0:
        jref = jwf.xlating_fir_block_pallas_xal(
            jnp.asarray(x), jnp.asarray(tail), h, decim, jnp.uint32(ph),
            jnp.uint32(inc), precision="highest", interpret=True)
        _close(got, jref)


@pytest.mark.parametrize("ph,inc", WRAPS)
@pytest.mark.parametrize("decim,n", [(8, 8192), (4, 8192), (5, 1005),
                                     (8, 99)])
def test_b4_factored_form_matches_frame_rtf(rng, ph, inc, decim, n):
    h = _taps(decim)
    frame = _cnoise(rng, h.shape[0] - 1 + n)
    ft, ht = torch.from_numpy(frame), torch.from_numpy(h)
    got = rotate_output(txc.xlating_fir_ctaps_frame_plain(ft, ht, decim,
                                                          _t(inc)),
                        _t(ph), _t(inc), decim).numpy()
    _close(got, txf.xlating_fir_frame_rtf_plain(ft, ht, decim, _t(ph),
                                                _t(inc)).numpy())
    if jwf.supported(n, decim) and n % 128 == 0:
        jref = jwf.xlating_fir_frame_pallas_rtf(
            jnp.asarray(frame), h, decim, jnp.uint32(ph), jnp.uint32(inc),
            precision="highest", interpret=True)
        _close(got, jref)


# ---------------------------------------------------------------------------
# B3: the block entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("complex_frame", [False, True])
@pytest.mark.parametrize("decim,spec", [(8, (21.6e3, 9.6e3)),
                                        (8, (112.5e3, 75e3)),
                                        (4, (45e3, 30e3))])
def test_b3_block_entry_matches_jax_on_concat(rng, complex_frame, decim, spec):
    h = _taps(decim, *spec)
    x, tail = _cnoise(rng, 512 * decim), _cnoise(rng, h.shape[0])
    if not complex_frame:
        x, tail = x.real.copy(), tail.real.copy()
    ref = fir_decimate_frame_pallas(jnp.asarray(np.concatenate([tail[1:], x])),
                                    h, decim, interpret=True)
    got = tfd.fir_decimate_block(torch.from_numpy(x), torch.from_numpy(tail),
                                 torch.from_numpy(h), decim)
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got.numpy(), ref)


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

SHAPES = [(131072, 8, 104), (16384, 8, 176), (131072, 8, 1024),
          (1, 1, 1), (7, 3, 9), (1000, 5, 1020), (4097, 16, 1024),
          (3000, 1, 1024), (2049, 2, 64), (640, 16, 16), (333, 7, 700),
          (4000, 1, 13500), (1000, 5, 4000), (37, 3, 999)]


@pytest.mark.parametrize("sample_bytes,tap_bytes", [(4, 4), (8, 4), (8, 8)])
@pytest.mark.parametrize("n_out,decim,taps", SHAPES)
def test_geometry_covers_every_output_once_within_shared_memory(
        n_out, decim, taps, sample_bytes, tap_bytes):
    tpad = -(-taps // decim) * decim
    geo = tiling.geometry(n_out, tpad, decim, sample_bytes, tap_bytes, 132)
    assert (tiling.output_counts(geo, n_out) == 1).all()
    assert tiling.smem_bytes(geo, tpad, decim, sample_bytes,
                             tap_bytes) <= tiling.SMEM_PER_BLOCK
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= tiling.MAX_THREADS
    assert geo.r in (1, 2, 4, 8) and geo.split in (1, 2, 4, 8)
    assert geo.split <= decim and geo.r <= tpad // decim
    # the last row a lane group reads lies inside its plane
    rows = tiling.tile_rows(geo.threads, geo.r, geo.split, tpad, decim)
    plane = tiling.plane_stride(rows, geo.r, geo.split, sample_bytes)
    assert tiling.row_slot(rows - 1, geo.r) < plane


def test_geometry_regimes_at_the_main_path_shapes():
    """The channel shapes get 8-output windows in 512-output tiles, two
    blocks or fewer per SM; the audio_aa shape lanes that share outputs
    and more blocks than SMs; taps are checked. B2 at the fused path's
    shape (complex samples, complex taps) takes B1's geometry."""
    chan = tiling.geometry(131072, 104, 8, 8, 8, 132)
    assert (chan.threads, chan.r, chan.split) == (256, 8, 4)
    assert tiling.taps_per_phase(104, 8, chan.r) == 16
    tile = tiling.tile_outputs(chan.threads, chan.r, chan.split)
    assert tile == 512 and -(-131072 // tile) <= 132 * 2
    # B3 over complex samples: the same geometry, real taps
    b3 = tiling.geometry(131072, 104, 8, 8, 4, 132)
    assert (b3.threads, b3.r, b3.split) == (256, 8, 4)
    aa = tiling.geometry(16384, 176, 8, 4, 4, 132)
    assert (aa.threads, aa.r, aa.split) == (128, 4, 8)
    assert 16384 // tiling.tile_outputs(aa.threads, aa.r, aa.split) > 132
    with pytest.raises(ValueError):
        tiling.geometry(100, 30, 8, 4, 4, 132)
    with pytest.raises(ValueError):
        tiling.geometry(100, 4, 8, 4, 4, 132)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.geometry(100, 40000, 1, 8, 8, 132)


@pytest.mark.parametrize("n_out,decim,taps,want", [
    (131072, 8, 1024, (256, 8, 4)), (131072, 1, 1024, (256, 8, 1)),
    (4096, 16, 1024, (128, 4, 8)), (1000, 2, 4, (128, 2, 2)),
    (1000, 8, 8, (128, 1, 8)), (10 ** 6, 1, 13500, (32, 8, 1))])
def test_geometry_fits_long_taps_by_fewer_threads(n_out, decim, taps, want):
    """Few taps a phase shrink the window; taps too many for shared
    memory halve the threads before the window."""
    geo = tiling.geometry(n_out, taps, decim, 8, 8, 132)
    assert (geo.threads, geo.r, geo.split) == want
    assert tiling.smem_bytes(geo, taps, decim, 8, 8) <= tiling.SMEM_PER_BLOCK


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("mp", range(1, 25))
def test_tap_loads_are_free_of_bank_conflicts(mp, split):
    """The lanes of a group read the taps of ``split`` phases at once,
    ``tap_stride(mp)`` apart: distinct banks for float and float2 taps."""
    ts = tiling.tap_stride(mp)
    assert ts >= mp and ts % 2 == 0
    for words in (32, 16):  # float or float2 taps per wavefront
        assert len({s * ts % words for s in range(split)}) == split


@pytest.mark.parametrize("sample_bytes", [4, 8])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_window_loads_are_free_of_bank_conflicts(sample_bytes, r, split):
    """The lanes of one wavefront (32 floats or 16 float2) read distinct
    banks: lane (g, s) reads plane s at slot g*Q + row_slot(c)."""
    decim = 8
    rows = tiling.tile_rows(256, r, split, 13 * decim, decim)
    plane = tiling.plane_stride(rows, r, split, sample_bytes)
    q = r + 1 if r % 2 == 0 else r
    per_wave = tiling.WAVEFRONT_BYTES // sample_bytes
    lane = np.arange(32)
    g, s = lane // split, lane % split
    for c in range(2 * r + 3):
        addr = s * plane + g * q + tiling.row_slot(c, r)
        for w0 in range(0, 32, per_wave):
            banks = addr[w0:w0 + per_wave] % per_wave
            assert len(set(banks.tolist())) == per_wave


# ---------------------------------------------------------------------------
# a step-by-step model of the kernel
# ---------------------------------------------------------------------------

def model_kernel(hist, body, n, g, n_out, decim, geo):
    """The kernel's loops in numpy: lay the taps out phase-major, each
    phase padded with zero taps to ``mp``; stage each tile phase-planar
    into the slots ``p*plane + row_slot(r)`` (NaN in every other slot);
    then for every lane slide the R-sample window down its phases in
    whole R-step chunks and sum the lanes of each group."""
    tpad = g.shape[0]
    r_out, split = geo.r, geo.split
    m_ph = tiling.taps_per_phase(tpad, decim, r_out)
    gt = np.zeros((decim, m_ph), g.dtype)
    gt[:, :tpad // decim] = g.reshape(tpad // decim, decim).T
    tile = tiling.tile_outputs(geo.threads, r_out, split)
    rows = tiling.tile_rows(geo.threads, r_out, split, tpad, decim)
    plane = tiling.plane_stride(rows, r_out, split, 8)
    q = r_out + 1 if r_out % 2 == 0 else r_out
    y = np.full(n_out, np.nan, np.complex128)
    for t in range(-(-n_out // tile)):
        ring = np.full(decim * plane, np.nan, np.complex128)
        i0 = t * tile * decim - (tpad - 1)
        for j in range(rows * decim):
            row, p = divmod(j, decim)
            i = i0 + j
            slot = p * plane + tiling.row_slot(row, r_out)
            assert np.isnan(ring[slot])
            ring[slot] = hist[tpad + i] if i < 0 else (
                body[i] if i < n else 0)
        for grp in range(geo.threads // split):
            acc = np.zeros(r_out, np.complex128)
            for s in range(split):
                for p in range(s, decim, split):
                    pl = p * plane + grp * q
                    w = [None] * r_out
                    for c in range(r_out - 1):
                        w[c] = ring[pl + tiling.row_slot(c, r_out)]
                    for m0 in range(0, m_ph, r_out):
                        pc = pl + tiling.row_slot(m0, r_out)
                        for jj in range(r_out):
                            w[(jj + r_out - 1) % r_out] = ring[
                                pc + tiling.row_slot(jj + r_out - 1,
                                                     r_out)]
                            for i in range(r_out):
                                acc[i] += gt[p, m0 + jj] * \
                                    w[(jj + i) % r_out]
            for i in range(r_out):
                k = t * tile + grp * r_out + i
                if k < n_out:
                    assert np.isnan(y[k])
                    y[k] = acc[i]
    return y


@pytest.mark.parametrize("layout", [
    None, (32, 8, 4), (64, 4, 2), (32, 2, 8), (32, 1, 1), (64, 8, 4)])
@pytest.mark.parametrize("decim,n", [(8, 2051), (5, 803), (3, 310),
                                     (1, 97), (8, 30)])
def test_kernel_model_matches_plain_twins(rng, layout, decim, n):
    """The model under the host's geometry (None) and under every window
    and split the kernel is compiled for, with tiles of 8-64 outputs so
    that several tiles, ragged ends and the tail straddle are covered."""
    h = _taps(decim)
    x, tail = _cnoise(rng, n), _cnoise(rng, h.shape[0])
    ph, inc = 0xFFFFF000, 0x9E3779B9
    g = rotated_taps(torch.from_numpy(h), _t(inc)).numpy()
    n_out = n // decim
    if layout is None:
        geo = tiling.geometry(n_out, h.shape[0], decim, 8, 8, 4)
    else:
        threads, r, split = layout
        geo = tiling.Geometry(threads=threads, r=r, split=min(split, decim))
    yf = model_kernel(tail, x, n, g.astype(np.complex128), n_out, decim, geo)
    args = (torch.from_numpy(x), torch.from_numpy(tail), torch.from_numpy(h),
            decim)
    # B2: the model's sums with complex taps, unrotated
    _close(yf, txc.xlating_fir_ctaps_block_plain(*args, _t(inc)).numpy())
    # B1: the same sums, rotated per output as the epilogue does
    got = rotate_output(torch.from_numpy(yf.astype(np.complex64)), _t(ph),
                        _t(inc), decim).numpy()
    _close(got, txf.xlating_fir_block_plain(*args, _t(ph), _t(inc)).numpy())
    # B3: real taps
    y3 = model_kernel(tail, x, n, h.astype(np.float64), n_out, decim, geo)
    _close(y3, tfd.fir_decimate_block_plain(args[1], args[0], args[2],
                                            decim).numpy())


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_library_path_follows_every_header(tmp_path, monkeypatch):
    csrc = build.CSRC
    for f in ("xlating_fir.cu", "polyphase_fir.cuh"):
        (tmp_path / f).write_bytes((csrc / f).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("xlating_fir")
    assert before == build.library_path("xlating_fir")
    (tmp_path / "polyphase_fir.cuh").write_text(
        (tmp_path / "polyphase_fir.cuh").read_text() + "\n// edited\n")
    assert build.library_path("xlating_fir") != before
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert build.library_path("xlating_fir") != before
    # the package's own sources name every header they include
    for name in build.KERNEL_SOURCES:
        src = (csrc / f"{name}.cu").read_text()
        for line in src.splitlines():
            if line.startswith("#include \""):
                assert (csrc / line.split('"')[1]).exists()
