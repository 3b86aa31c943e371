"""The port's export sinks (``grbaz_tpu_torch/viz``): the JAX package's
sink cases on the port, the PNG and CSV bytes equal to the JAX sinks' on
the same input, and each sink fed a torch tensor (the same products as
from numpy)."""

import numpy as np
import pytest
import torch

import grbaz_tpu.viz as jviz
from grbaz_tpu.viz.sinks import HistoSink as JHistoSink
from grbaz_tpu_torch.viz import (DoACompass, EyeSink, PlotSink, StaticText,
                                 TimePanel, WaterfallSink, write_csv,
                                 write_image)
from grbaz_tpu_torch.viz.sinks import HistoSink


def _spectra(i):
    return np.linspace(-80, 0, 64) * (i % 2)


def test_waterfall_sink_png(tmp_path):
    wf = WaterfallSink(width=64, rows=16, vmin=-80, vmax=0,
                       center_freq=100e6, span=1e6)
    for i in range(20):
        wf.push(_spectra(i))
    rgb = wf.to_rgb()
    assert rgb.shape == (16, 64, 3) and rgb.dtype == np.uint8
    assert not np.array_equal(rgb[-1], rgb[-2])
    assert wf.count == 20
    p = tmp_path / "wf.png"
    wf.save_png(str(p))
    assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    ax = wf.freq_axis()
    assert ax[0] == pytest.approx(99.5e6) and ax[-1] == pytest.approx(100.5e6)


def test_plot_and_eye_sinks(tmp_path):
    ps = PlotSink(keep=3, x_label="bin", y_label="dB")
    for i in range(5):
        ps.push(np.full(8, i, np.float32))
    assert len(ps.history()) == 3
    assert ps.latest()[0] == 4
    ps.save_csv(str(tmp_path / "p.csv"))
    assert (tmp_path / "p.csv").read_text().startswith("bin,dB")
    sps = 8
    rng = np.random.default_rng(3)
    sym = np.repeat(rng.choice([1.0, -1.0], 32), sps).astype(np.float32)
    eye = EyeSink(samples_per_symbol=sps, traces=16)
    eye.push(sym)
    assert eye.traces().shape[1] == 2 * sps
    assert abs(eye.eye_opening()) == pytest.approx(2.0)


def test_compass_text_timepanel():
    c = DoACompass()
    c.update([0.0, 90.0], [1.0, 0.5])
    lines = c.ascii_rose(width=33).splitlines()
    assert lines[0][0] == "N" and lines[1][0] == "^"
    assert lines[1][8] == "^"
    changes = []
    st = StaticText("freq", formatter=lambda v: f"{v/1e6:.3f} MHz",
                    on_change=changes.append)
    st.set_value(100e6)
    st.set_value(100e6)
    assert st.text == "freq: 100.000 MHz" and len(changes) == 1
    tp = TimePanel(sample_rate=1e6)
    tp.set_epoch(1000, 0.5)
    tp.advance(2_000_000)
    assert tp.stream_time() == pytest.approx(1002.5)
    assert tp.snapshot()["samples"] == 2_000_000


def _feed(mod, wrap, tmp_path, tag):
    """Every sink of ``mod`` fed the same inputs (through ``wrap``): the
    bytes of each file it writes, and its other products."""
    rng = np.random.default_rng(5)
    out = {}
    wf = mod.WaterfallSink(width=48, rows=10, vmin=-90, vmax=-10)
    for i in range(13):
        wf.push(wrap(rng.uniform(-100, 0, 50).astype(np.float32)))
    wf.save_png(str(tmp_path / f"{tag}wf.png"))
    out["wf.png"] = (tmp_path / f"{tag}wf.png").read_bytes()
    out["raster"] = wf.raster()
    ps = mod.PlotSink(keep=4, x_label="f", y_label="p")
    for i in range(6):
        ps.push(wrap(rng.standard_normal(16).astype(np.float32)))
    ps.set_marker(3.5)
    ps.save_csv(str(tmp_path / f"{tag}p.csv"))
    out["p.csv"] = (tmp_path / f"{tag}p.csv").read_bytes()
    out["history"] = np.stack(ps.history())
    eye = mod.EyeSink(samples_per_symbol=4, traces=6)
    for _ in range(3):
        eye.push(wrap(rng.standard_normal(21).astype(np.float32)))
    eye.save_csv(str(tmp_path / f"{tag}eye.csv"))
    out["eye.csv"] = (tmp_path / f"{tag}eye.csv").read_bytes()
    out["eye_opening"] = eye.eye_opening()
    c = mod.DoACompass()
    c.update(wrap(np.array([10.0, 370.5, -20.0])),
             wrap(np.array([0.9, 0.5, 0.25])))
    out["rose"] = c.ascii_rose()
    out["bearings"] = (c.bearings, c.confidences)
    tp = mod.TimePanel(sample_rate=48e3)
    tp.set_epoch(7, 0.25)
    tp.advance(wrap(np.int64(96000)))
    out["stream_time"] = tp.stream_time()
    h = mod.HistoSink(n_bins=8)
    h.push(wrap(rng.standard_normal(300).astype(np.float32)))
    out["histo"] = (h.counts.copy(), h.total, h.render(20))
    rows = [[i, rng.standard_normal()] for i in range(5)]
    mod.write_csv(str(tmp_path / f"{tag}rows.csv"), rows, header=["a", "b"])
    out["rows.csv"] = (tmp_path / f"{tag}rows.csv").read_bytes()
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    mod.write_image(str(tmp_path / f"{tag}img.png"), img)
    out["img.png"] = (tmp_path / f"{tag}img.png").read_bytes()
    return out


class _JaxSinks:
    WaterfallSink, PlotSink, EyeSink = (jviz.WaterfallSink, jviz.PlotSink,
                                        jviz.EyeSink)
    DoACompass, TimePanel, HistoSink = (jviz.DoACompass, jviz.TimePanel,
                                        JHistoSink)
    write_csv, write_image = jviz.write_csv, jviz.write_image


class _PortSinks:
    WaterfallSink, PlotSink, EyeSink = WaterfallSink, PlotSink, EyeSink
    DoACompass, TimePanel, HistoSink = DoACompass, TimePanel, HistoSink
    write_csv, write_image = staticmethod(write_csv), staticmethod(write_image)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif isinstance(a[k], tuple) and isinstance(a[k][0], np.ndarray):
            np.testing.assert_array_equal(a[k][0], b[k][0], err_msg=k)
            assert a[k][1:] == b[k][1:], k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("feed", ["numpy", "tensor"])
def test_sinks_bytes_equal_to_jax(tmp_path, feed):
    """The port's sinks, fed numpy arrays or CPU tensors, write the bytes
    the JAX sinks write from numpy, and hold the same products."""
    wrap = (lambda a: a) if feed == "numpy" else torch.as_tensor
    jax_out = _feed(_JaxSinks, lambda a: a, tmp_path, "jax_")
    port_out = _feed(_PortSinks, wrap, tmp_path, "port_")
    _same(port_out, jax_out)


@pytest.mark.parametrize("sink", ["waterfall", "plot", "eye", "compass",
                                  "time", "histo"])
def test_each_sink_takes_a_tensor(sink, tmp_path):
    """One case per sink: a CPU tensor gives what its numpy array gives."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(64).astype(np.float32)
    made = []
    for v in (x, torch.from_numpy(x.copy())):
        if sink == "waterfall":
            s = WaterfallSink(width=64, rows=4, vmin=-3, vmax=3)
            s.push(v)
            made.append(s.to_rgb())
        elif sink == "plot":
            s = PlotSink()
            s.push(v)
            assert isinstance(s.latest(), np.ndarray)
            made.append(s.latest())
        elif sink == "eye":
            s = EyeSink(samples_per_symbol=8)
            s.push(v)
            made.append(s.traces())
        elif sink == "compass":
            s = DoACompass()
            s.update(v[:3] * 100, v[3:6])
            made.append(np.array([s.bearings, s.confidences]))
        elif sink == "time":
            s = TimePanel(sample_rate=1e3)
            s.advance(v[0].to(torch.int64) if torch.is_tensor(v) else
                      np.int64(x[0]))
            made.append(np.array(s.samples))
        else:
            s = HistoSink(n_bins=16)
            s.push(v)
            made.append(s.counts)
    np.testing.assert_array_equal(made[0], made[1])


def test_image_writer_png_layout(tmp_path):
    """The PNG decodes (filter 0 rows under one zlib stream) back to the
    raster it was given."""
    import struct
    import zlib
    rgb = np.random.default_rng(2).integers(0, 256, (9, 11, 3),
                                            dtype=np.uint8)
    p = tmp_path / "x.png"
    write_image(str(p), rgb)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (11, 9)
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(rows[:, 0] == 0)
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 3), rgb)
