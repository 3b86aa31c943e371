"""Port framing, spectra, FAC, colouriser and the config-3 analyzer
chains (build_spectrum, build_fac) == grbaz_tpu."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core import checkpoint as jckpt
from grbaz_tpu.models import spectral as jmodel
from grbaz_tpu.ops import colour as jcolour
from grbaz_tpu.ops import spectral as jspec
from grbaz_tpu_torch.core import checkpoint as tckpt
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models import spectral as tmodel
from grbaz_tpu_torch.ops import colour as tcolour
from grbaz_tpu_torch.ops import spectral as tspec
from tests.torch_parity import jax_run, port_run, split

CPU = "cpu"


def _iq(n, seed=0, tone=0.1):
    gen = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.exp(1j * tone * t) + 0.3 * np.exp(-1j * 0.7 * t) \
        + 0.01 * (gen.standard_normal(n) + 1j * gen.standard_normal(n))
    return x.astype(np.complex64)


def _power(db, scale):
    """dB back to linear power (``scale`` 10 for power, 20 for FAC)."""
    return 10.0 ** (np.asarray(db, np.float64) / scale)


def _close_spectra(got, want, scale):
    """Linear power within 1e-5 of each frame's max; dB equal to 1e-3
    where the power is above 1e-6 of the max (low bins differ by the two
    FFTs' rounding)."""
    assert got.shape == want.shape
    pg, pw = _power(got, scale), _power(want, scale)
    fmax = pw.max(axis=-1, keepdims=True)
    assert np.all(np.abs(pg - pw) <= 1e-5 * fmax)
    loud = pw > 1e-6 * fmax
    assert np.abs(got[loud] - want[loud]).max() < 1e-3


@pytest.mark.parametrize("size,overlap", [(64, 0), (64, 16), (64, 48)])
@pytest.mark.parametrize("counts", [(768, 768, 768), (768, 100, 768, 0)])
def test_framing_bit_equal(size, overlap, counts):
    """Vectorize / Overlap frames, counts and the carried tail, over
    chained blocks with partial ones."""
    bs = 768
    x = _iq(bs * len(counts))
    blocks = [x[i * bs:(i + 1) * bs] for i in range(len(counts))]
    if overlap:
        jb = jspec.Overlap(size, overlap)
        tb = tspec.Overlap(size, overlap, device=CPU)
    else:
        jb, tb = jspec.Vectorize(size), tspec.Vectorize(size)
    jo, js = jax_run(jb, blocks, counts)
    to, ts = port_run(tb, blocks, counts)
    for (jd, jc), (td, tc) in zip((o[0] for o in jo), (o[0] for o in to)):
        assert jc == tc and td.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(jd, td)
    if overlap:
        np.testing.assert_array_equal(np.asarray(js["tail"]),
                                      ts["tail"].numpy())


@pytest.mark.parametrize("shape", [(300,), (7, 40)])
@pytest.mark.parametrize("vmin,vmax", [(-120.0, 0.0), (-3.0, 5.0),
                                       (1.0, 1.0)])
def test_colouriser_bytes_bit_equal(shape, vmin, vmax):
    """RGB bytes of values inside, at the edges of and outside the range
    (truncation toward zero before the clip), 1-D (count*3) and 2-D."""
    gen = np.random.default_rng(len(shape))
    x = (gen.standard_normal(shape) * 80 - 50).astype(np.float32)
    x.flat[:4] = [vmin, vmax, -1e-3, 0.0]
    jb, tb = jcolour.Colouriser(vmin, vmax), \
        tcolour.Colouriser(vmin, vmax, device=CPU)
    (jo,), _ = jax_run(jb, [x], [shape[0] - 2])
    (to,), _ = port_run(tb, [x], [shape[0] - 2])
    assert to[0][0].dtype == np.uint8
    np.testing.assert_array_equal(jo[0][0], to[0][0])
    assert jo[0][1] == to[0][1]
    np.testing.assert_array_equal(jcolour.thermal_gradient(77),
                                  tcolour.thermal_gradient(77))


@pytest.mark.parametrize("alpha", [1.0, 0.25])
@pytest.mark.parametrize("shift", [True, False])
def test_power_spectrum_matches_jax(alpha, shift):
    size = 256
    x = _iq(size * 24).reshape(-1, size)
    blocks = [x[:8], x[8:16], x[16:]]
    jb = jspec.PowerSpectrum(size, avg_alpha=alpha, shift=shift)
    tb = tspec.PowerSpectrum(size, avg_alpha=alpha, shift=shift, device=CPU)
    jo, js = jax_run(jb, blocks, [8, 8, 5])
    to, ts = port_run(tb, blocks, [8, 8, 5])
    for j, t in zip(jo, to):
        assert j[0][1] == t[0][1]
        _close_spectra(t[0][0], j[0][0], 10.0)
    np.testing.assert_allclose(ts["avg"].numpy(), np.asarray(js["avg"]),
                               rtol=1e-5, atol=1e-5 * float(js["avg"].max()))


def test_single_pole_iir_vector_matches_jax():
    gen = np.random.default_rng(4)
    x = gen.random((30, 16)).astype(np.float32)
    blocks = [x[:10], x[10:20], x[20:]]
    jo, js = jax_run(jspec.SinglePoleIIRVector(0.3, 16), blocks)
    to, ts = port_run(tspec.SinglePoleIIRVector(0.3, 16, device=CPU), blocks)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(t[0][0], j[0][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts["prev"].numpy(), np.asarray(js["prev"]),
                               rtol=1e-6)


@pytest.mark.parametrize("keep,counts", [(1, (12, 12, 7)), (5, (12, 12, 7)),
                                         (7, (12, 3, 12, 12)),
                                         (30, (12, 12, 12, 12))])
def test_fac_spectrum_matches_jax(keep, counts):
    """Kept frames, their count and the keep-one-in-n phase carried across
    blocks (int32), and the FAC spectra in linear power."""
    size = 128
    x = _iq(size * 12 * len(counts), seed=2).reshape(-1, size)
    blocks = [x[i * 12:(i + 1) * 12] for i in range(len(counts))]
    jb = jspec.FACSpectrum(size, keep_one_in_n=keep, avg_alpha=0.25)
    tb = tspec.FACSpectrum(size, keep_one_in_n=keep, avg_alpha=0.25,
                           device=CPU)
    jst = jax.tree_util.tree_map(jnp.asarray, jb.init_state())
    tst = tb.init_state()
    for i, b in enumerate(blocks):
        (jo,), jst = jax_run(jb, [b], [counts[i]], state=jst)
        (to,), tst = port_run(tb, [b], [counts[i]], state=tst)
        (jd, jc), (td, tc) = jo[0], to[0]
        assert jc == tc and jd.shape == td.shape
        assert tst["phase"].dtype == torch.int32
        assert int(tst["phase"]) == int(jst["phase"])
        if jc:
            _close_spectra(td[:jc], jd[:jc], 20.0)
    np.testing.assert_allclose(tst["avg"].numpy(), np.asarray(jst["avg"]),
                               rtol=1e-5, atol=1e-5 * float(jst["avg"].max()))


def _run_graph(fg, blocks, counts, rate, torch_side):
    step = fg.build_step() if torch_side else jax.jit(fg.build_step())
    st = fg.init_states() if torch_side else \
        jax.tree_util.tree_map(jnp.asarray, fg.init_states())
    pr = fg.init_params()
    outs = []
    for b, c in zip(blocks, counts):
        if torch_side:
            s = Stream.full(torch.from_numpy(b), sample_rate=rate)
            s.count = torch.tensor(c, dtype=torch.int32)
        else:
            from grbaz_tpu.core.stream import Stream as JStream
            s = JStream.full(jnp.asarray(b), sample_rate=rate)
            s = JStream(s.data, jnp.int32(c), s.meta)
        st, o = step(st, pr, {"iq": s})
        outs.append({k: (np.asarray(v.data) if not torch_side
                         else v.data.numpy(), int(v.count))
                     for k, v in o.items()})
    return outs, st


@pytest.mark.parametrize("waterfall", [False, True])
@pytest.mark.parametrize("overlap", [0, 256])
def test_build_spectrum_matches_jax(waterfall, overlap):
    """The config-3 spectrum analyzer over 3 chained blocks, the last
    partial. The raster is the JAX colouriser's bytes of the port's
    spectra (bytes of spectra that differ by FFT rounding may fall one
    LUT step apart)."""
    kw = dict(fft_size=512, block_size=1 << 13, waterfall=waterfall,
              overlap=overlap)
    x = _iq(3 << 13, seed=5)
    blocks, counts = split(x[: (3 << 13) - 3000], 1 << 13)
    jfg, _ = jmodel.build_spectrum(jmodel.SpectralConfig(**kw))
    tfg, th = tmodel.build_spectrum(tmodel.SpectralConfig(**kw), device=CPU)
    jo, _ = _run_graph(jfg, blocks, counts, 250e3, False)
    to, _ = _run_graph(tfg, blocks, counts, 250e3, True)
    assert set(jo[0]) == set(to[0]) == ({"spectra", "raster"} if waterfall
                                        else {"spectra"})
    for j, t in zip(jo, to):
        assert j["spectra"][1] == t["spectra"][1]
        _close_spectra(t["spectra"][0], j["spectra"][0], 10.0)
        if waterfall:
            col = jcolour.Colouriser(-120.0, 0.0)
            (ref,), _ = jax_run(col, [t["spectra"][0]], [t["spectra"][1]])
            np.testing.assert_array_equal(t["raster"][0], ref[0][0])
            assert t["raster"][1] == j["raster"][1]
            assert t["raster"][0].shape == (t["spectra"][0].shape[0],
                                            3 * 512)


def test_build_fac_matches_jax(tmp_path):
    """The FAC analyzer at its defaults (one frame in 162 kept) over 4
    chained blocks, the last partial, and its state through both
    packages' checkpoints."""
    cfg = dict(block_size=1 << 16)
    x = _iq(4 << 16, seed=6, tone=0.2)
    blocks, counts = split(x[: (4 << 16) - 5000], 1 << 16)
    jfg, _ = jmodel.build_fac(jmodel.FACConfig(**cfg))
    tfg, th = tmodel.build_fac(tmodel.FACConfig(**cfg), device=CPU)
    assert th["fac"].keep == 162
    jo, jst = _run_graph(jfg, blocks, counts, 250e3, False)
    to, tst = _run_graph(tfg, blocks, counts, 250e3, True)
    kept = 0
    for j, t in zip(jo, to):
        (jd, jc), (td, tc) = j["fac"], t["fac"]
        assert jc == tc
        kept += jc
        if jc:
            _close_spectra(td[:jc], jd[:jc], 20.0)
    assert kept == 3
    p = str(tmp_path / "fac.npz")
    tckpt.save_state(p, tst)
    back, _, _ = jckpt.load_state(p, jfg.init_states())
    assert int(back["fac"]["phase"]) == int(jst["fac"]["phase"])
    assert np.asarray(back["fac"]["phase"]).dtype == np.int32
