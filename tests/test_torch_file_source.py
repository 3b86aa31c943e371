"""The port's file source (``grbaz_tpu_torch/io/file_source.py``): the
JAX package's five cases (WAV + auxi, raw c64 and seek, timing-file gap
padding and skip, playlist and loop) on the port, then the same files
read by both packages: equal samples, flags and offsets."""

import numpy as np
import pytest

from grbaz_tpu.io import file_source as jfs
from grbaz_tpu_torch.core.stream import stream_flags
from grbaz_tpu_torch.io.file_source import _AUXI, CaptureFile, FileSource
from tests.test_file_source import make_wav


def test_wav_auxi_parsing(tmp_path):
    iq = (np.exp(2j * np.pi * 0.05 * np.arange(1000)) * 0.5).astype(
        np.complex64)
    p = tmp_path / "cap.wav"
    make_wav(str(p), iq, rate=192000, freq=98.5e6)
    cf = CaptureFile(str(p))
    assert cf.sample_rate == 192000
    assert cf.freq == 98.5e6
    assert cf.length == 1000
    assert cf.time_start is not None
    assert cf.time_start.year == 2024 and cf.time_start.second == 45
    assert cf.time_end.minute == 31
    got = cf.read_at(0, 1000)
    assert np.max(np.abs(got - iq)) < 1e-3
    cf.close()
    assert _AUXI.size == jfs._AUXI.size


def test_raw_c64_and_seek(tmp_path):
    x = np.arange(5000, dtype=np.complex64)
    p = tmp_path / "cap.c64"
    x.tofile(str(p))
    src = FileSource(str(p), fmt="c64", sample_rate=1e6)
    src.seek(1200)
    out, flags = src.read_samples(100)
    np.testing.assert_array_equal(out, x[1200:1300])
    src.seek_time(0.003)  # 3000 samples at 1 MHz
    out, _ = src.read_samples(10)
    np.testing.assert_array_equal(out, x[3000:3010])
    assert src.offset() == 3010
    assert src.duration() == pytest.approx(0.005)
    src.close()


def test_timing_file_gap_padding(tmp_path):
    x = (np.arange(200) + 1).astype(np.complex64)
    p = tmp_path / "cap.c64"
    x.tofile(str(p))
    t = tmp_path / "cap.timing"
    t.write_text("# timing\nR1000\n0,0\n150,100\n")
    src = FileSource(str(p), fmt="c64", timing_paths=[str(t)], pad=True)
    assert src.sample_rate == 1000.0
    assert src.files[0].padded_length == 250
    out, flags = src.read_samples(250)
    np.testing.assert_array_equal(out[:100], x[:100])
    assert np.all(out[100:150] == 0)
    np.testing.assert_array_equal(out[150:250], x[100:200])
    assert flags & stream_flags.EMPTY_PAYLOAD
    _, flags2 = src.read_samples(10)
    assert flags2 & stream_flags.STREAM_END
    src.close()


def test_timing_gap_skip_mode(tmp_path):
    x = (np.arange(200) + 1).astype(np.complex64)
    p = tmp_path / "cap.c64"
    x.tofile(str(p))
    t = tmp_path / "cap.timing"
    t.write_text("R1000\n0,0\n150,100\n")
    src = FileSource(str(p), fmt="c64", timing_paths=[str(t)], pad=False)
    out, _ = src.read_samples(200)
    np.testing.assert_array_equal(out, x)
    src.close()


def test_playlist_and_loop(tmp_path):
    a = np.full(100, 1.0, np.complex64)
    b = np.full(50, 2.0, np.complex64)
    pa, pb = tmp_path / "a.c64", tmp_path / "b.c64"
    a.tofile(str(pa))
    b.tofile(str(pb))
    src = FileSource([str(pa), str(pb)], fmt="c64", sample_rate=1000)
    out, flags = src.read_samples(130)
    assert np.all(out[:100] == 1.0) and np.all(out[100:130] == 2.0)
    assert src.file_index == 1
    out2, flags2 = src.read_samples(40)
    assert np.all(out2[:20] == 2.0) and np.all(out2[20:] == 0)
    assert flags2 & stream_flags.STREAM_END
    src2 = FileSource([str(pa), str(pb)], fmt="c64", sample_rate=1000,
                      loop=True)
    out3, flags3 = src2.read_samples(300)
    assert np.all(out3[:100] == 1.0)
    assert np.all(out3[100:150] == 2.0)
    assert np.all(out3[150:250] == 1.0)
    assert not (flags3 & stream_flags.STREAM_END)
    src.close()
    src2.close()


def _files(tmp_path):
    """Every format the source reads, with a timing file on one: (paths,
    FileSource kwargs) cases."""
    rng = np.random.default_rng(11)
    iq = (0.4 * (rng.standard_normal(3000)
                 + 1j * rng.standard_normal(3000))).astype(np.complex64)
    iq = np.clip(iq.real, -1, 1) + 1j * np.clip(iq.imag, -1, 1)
    cases = {}
    wav = tmp_path / "cap.wav"
    make_wav(str(wav), iq, rate=240000, freq=101.1e6)
    cases["wav"] = ([str(wav)], dict())
    wav_plain = tmp_path / "plain.wav"
    make_wav(str(wav_plain), iq[:1001], rate=48000, with_auxi=False)
    cases["wav_no_auxi"] = ([str(wav_plain)], dict())
    c64 = tmp_path / "cap.c64"
    iq.astype(np.complex64).tofile(str(c64))
    cases["c64"] = ([str(c64)], dict(fmt="c64", sample_rate=1e5))
    i16 = tmp_path / "cap.i16"
    (rng.integers(-32768, 32767, 2 * 777, dtype=np.int16)).tofile(str(i16))
    cases["i16"] = ([str(i16)], dict(fmt="i16", sample_rate=1e5))
    u8 = tmp_path / "cap.u8"
    (rng.integers(0, 256, 2 * 999, dtype=np.uint8)).tofile(str(u8))
    cases["u8"] = ([str(u8)], dict(fmt="u8", sample_rate=2.4e6))
    f32 = tmp_path / "cap.f32"
    rng.standard_normal(500).astype(np.float32).tofile(str(f32))
    cases["f32"] = ([str(f32)], dict(fmt="f32", sample_rate=8e3))
    timing = tmp_path / "cap.timing"
    timing.write_text("R1000\n0,0\n1500,1000\n2600,2000\n")
    cases["timing_pad"] = ([str(c64)], dict(fmt="c64",
                                            timing_paths=[str(timing)]))
    cases["timing_skip"] = ([str(c64)], dict(fmt="c64", pad=False,
                                             timing_paths=[str(timing)]))
    cases["playlist_loop"] = ([str(wav_plain), str(c64), str(wav)],
                              dict(fmt="auto", sample_rate=1e5, loop=True))
    return cases


CASES = ("wav", "wav_no_auxi", "c64", "i16", "u8", "f32", "timing_pad",
         "timing_skip", "playlist_loop")


@pytest.mark.parametrize("case", CASES)
def test_same_reads_as_the_jax_source(tmp_path, case):
    """Both packages read the same file in the same pieces, with seeks
    between: the samples, flags, offsets and metadata are equal."""
    paths, kw = _files(tmp_path)[case]
    srcs = [FileSource(paths, **kw), jfs.FileSource(paths, **kw)]
    pieces = (1, 100, 777, 1, 2500, 64, 4000)
    for s in srcs:
        s.got = []
    for i, n in enumerate(pieces):
        if i == 3:
            for s in srcs:
                s.seek(123)
        if i == 5:
            for s in srcs:
                s.seek_time(0.0007)
        for s in srcs:
            out, flags = s.read_samples(n)
            s.got.append((out, flags, s.offset(), s.file_index))
    for (a, fa, oa, ia), (b, fb, ob, ib) in zip(srcs[0].got, srcs[1].got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert (fa, oa, ia) == (fb, ob, ib)
    assert srcs[0].duration() == srcs[1].duration()
    assert srcs[0].sample_rate == srcs[1].sample_rate
    assert srcs[0].freq == srcs[1].freq
    assert srcs[0].start_time() == srcs[1].start_time()
    for s in srcs:
        s.close()
