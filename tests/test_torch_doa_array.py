"""The MUSIC direction-finding station's chain: B1 over an array's [n, M]
rows, the UCA steering vectors, the conjugated-steering convention, the
framing, and the whole chain through ``StreamExecutor`` against the
benchmark's plain reference (``radiobench/reference/doa.py``), at small
sizes on the CPU; the row kernel on the card.

This file imports neither JAX nor ``grbaz_tpu``: the card's case runs
there as ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_doa_array.py``.
"""

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core import trace
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import doa, fir
from grbaz_tpu_torch.ops.cuda import tiling
from grbaz_tpu_torch.ops.cuda import xlating_fir as xf
from radiobench import manifest

CPU = torch.device("cpu")
FS = 2.4e6
M = 5
R_UCA = 0.4253


def _taps():
    return fir.low_pass_taps(1.0, FS, 112.5e3, 75e3)


def _rows(gen, n, m=M):
    x = gen.standard_normal((n, m)) + 1j * gen.standard_normal((n, m))
    return torch.from_numpy(x.astype(np.complex64))


def _chain(blk, blocks, counts):
    st, pr, out = blk.init_state(), blk.init_params(), []
    for x, c in zip(blocks, counts):
        st, (y,) = blk.apply(st, pr, Stream.full(x).like(x, count=c))
        out.append((y.data, int(y.count)))
    return out, st


@pytest.mark.parametrize("sizes,partial", [((4096,), False),
                                           ((1000, 3096), False),
                                           ((37, 2048, 2011), False),
                                           ((2048, 1999), True)])
def test_rows_plain_arm_equals_one_stream_calls(sizes, partial):
    """[n, M] through the plain arm equals M one-stream blocks fed a row
    each, bit for bit, outputs, counts and the carried tails, over block
    splits and a partial last block."""
    gen = np.random.default_rng(sum(sizes))
    blocks = [_rows(gen, n) for n in sizes]
    counts = [n for n in sizes]
    if partial:
        counts[-1] -= 77
    rows = fir.FreqXlatingFIRDecimator(_taps(), 8, 250e3, FS, rows=M,
                                       backend="plain", device=CPU)
    got, st = _chain(rows, blocks, counts)
    for r in range(M):
        one = fir.FreqXlatingFIRDecimator(_taps(), 8, 250e3, FS,
                                          backend="plain", device=CPU)
        want, st1 = _chain(one, [b[:, r].contiguous() for b in blocks],
                           counts)
        for (y, c), (y1, c1) in zip(got, want):
            assert c == c1 and torch.equal(y[:, r], y1)
        assert torch.equal(st["tail"][:, r], st1["tail"])
        assert torch.equal(st["phase"], st1["phase"])


def test_rows_kernel_arm_on_the_cpu_equals_the_plain_arm():
    """The kernel arm's bookkeeping (the tail derotated for the launch,
    the rotated tail carried) over the row entry's plain twin agrees with
    the plain arm within float32 rounding, so the state moves between
    the arms."""
    gen = np.random.default_rng(11)
    blocks = [_rows(gen, n) for n in (1000, 64, 3000)]
    outs = {}
    for backend in ("kernel", "plain"):
        blk = fir.FreqXlatingFIRDecimator(_taps(), 8, 250e3, FS, rows=M,
                                          backend=backend, device=CPU)
        outs[backend] = _chain(blk, blocks, [b.shape[0] for b in blocks])
    (yk, sk), (yp, sp) = outs["kernel"], outs["plain"]
    for (a, ca), (b, cb) in zip(yk, yp):
        assert ca == cb and a.shape == b.shape == (ca, M)
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert (sk["tail"] - sp["tail"]).abs().max() <= 1e-6 * sp["tail"].abs(
    ).max()


def test_rows_refuse_a_block_of_other_rows():
    blk = fir.FreqXlatingFIRDecimator(_taps(), 8, 250e3, FS, rows=M,
                                      backend="plain", device=CPU)
    with pytest.raises(ValueError):
        blk.apply(blk.init_state(), blk.init_params(),
                  Stream.full(torch.zeros((64, M + 1), dtype=torch.complex64)))
    with pytest.raises(ValueError):
        fir.FreqXlatingFIRDecimator(_taps(), 8, 250e3, FS, rows=0, device=CPU)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows", [(1 << 18, 5), (4096 + 13, 5), (77, 2),
                                    (1 << 20, 1)])
def test_row_kernel_matches_plain_and_one_stream_launches(dev, n, rows):
    """The row entry, one launch for every row, against its plain twin at
    B1's 1e-5 of the max, and against one-stream launches of each row:
    bit for bit where both take one geometry, else at 1e-5."""
    gen = np.random.default_rng(n + rows)
    h = torch.from_numpy(fir.prepare_taps(_taps(), 8)).to(dev)
    x, tail = _rows(gen, n, rows).to(dev), _rows(gen, h.shape[0], rows).to(dev)
    ph = torch.tensor(0xFFFFF000, device=dev)
    inc = torch.tensor(0x9E3779B9, device=dev)
    before = xf.xlating_fir_rows.launches
    got = xf.xlating_fir_rows(x, tail, h, 8, ph, inc)
    assert xf.xlating_fir_rows.launches == before + 1
    ref = xf.xlating_fir_rows_plain(x, tail, h, 8, ph, inc)
    torch.cuda.synchronize()
    scale = ref.abs().max()
    assert got.shape == ref.shape == (n // 8, rows)
    assert (got - ref).abs().max() <= 1e-5 * scale
    same = tiling.for_tensor(x, n // 8 * rows, h.shape[0], 8, 8)
    one = tiling.for_tensor(x, n // 8, h.shape[0], 8, 8)
    for r in range(rows):
        y1 = xf.xlating_fir_block_kernel(x[:, r].contiguous(),
                                         tail[:, r].contiguous(), h, 8, ph,
                                         inc)
        torch.cuda.synchronize()
        if (same.threads, same.r, same.split) == (one.threads, one.r,
                                                  one.split):
            assert torch.equal(y1, got[:, r])
        else:
            assert (y1 - got[:, r]).abs().max() <= 1e-5 * scale


def test_uca_steering_vectors_closed_form():
    """a_m(theta_k) = exp(j 2 pi r cos(2 pi k / A - 2 pi m / M)); the
    neighbours of the 0.4253-wavelength circle half a wavelength apart;
    conj(a(theta)) = a(theta + pi)."""
    a = doa.uca_steering_vectors(M, R_UCA, 360)
    assert a.shape == (360, M) and a.dtype == np.complex64
    k, m = np.meshgrid(np.arange(360), np.arange(M), indexing="ij")
    want = np.exp(2j * np.pi * R_UCA * np.cos(np.radians(k) - 2 * np.pi
                                                * m / M))
    assert np.abs(a - want).max() < 1e-6
    assert abs(2 * R_UCA * np.sin(np.pi / M) - 0.5) < 1e-4
    assert np.abs(np.conj(a) - np.roll(a, -180, axis=0)).max() < 1e-5


def _array_rows(gen, navg, degrees, snr_db=20.0):
    """[navg, M] snapshot rows s * a(theta) of uncorrelated sources plus
    noise, as an array delivers them (complex128)."""
    a = doa.uca_steering_vectors(M, R_UCA, 360).astype(np.complex128)
    amp = 10 ** (snr_db / 20)
    x = (gen.standard_normal((navg, M)) + 1j * gen.standard_normal((navg, M))
         ) / np.sqrt(2)
    for d in degrees:
        s = amp * np.exp(2j * np.pi * gen.random(navg))
        x = x + s[:, None] * a[d][None, :]
    return x


@pytest.mark.parametrize("degrees", [(40, 130), (200, 355), (90,)])
def test_conjugated_steering_gives_grbaz_spectrum(degrees):
    """The port's spectrum (``x^H x`` of rows) with the conjugated
    steering equals gr-baz's (``R = x x^H`` of column snapshots,
    ``1 / ||G^H a||^2`` with a itself) within 1e-5 dB; in float32 with
    the subspace method the peaks are gr-baz's, and with a itself they
    read 180 degrees off."""
    gen = np.random.default_rng(sum(degrees))
    n = len(degrees)
    x = _array_rows(gen, 512, degrees)
    a = doa.uca_steering_vectors(M, R_UCA, 360).astype(np.complex128)
    cols = x.T
    r = cols @ cols.conj().T / cols.shape[1]
    g = np.linalg.eigh(r)[1][:, :M - n]
    want = 1.0 / (np.abs(g.conj().T @ a.T) ** 2).sum(axis=0)
    got, _ = doa.music_spectrum(torch.from_numpy(x),
                                torch.from_numpy(np.conj(a)), n,
                                method="eigh")
    assert np.abs(10 * np.log10(got.numpy() / want)).max() < 1e-5
    want_pk, _ = doa.top_n_peaks(torch.from_numpy(want), n)
    x32 = torch.from_numpy(x.astype(np.complex64))
    sub, _ = doa.music_spectrum(x32, torch.from_numpy(np.conj(a).astype(
        np.complex64)), n)
    pk, _ = doa.top_n_peaks(sub, n)
    assert sorted(pk.tolist()) == sorted(want_pk.tolist()) == sorted(degrees)
    flipped, _ = doa.music_spectrum(x32, torch.from_numpy(
        a.astype(np.complex64)), n)
    pk, _ = doa.top_n_peaks(flipped, n)
    assert sorted(pk.tolist()) == sorted((d + 180) % 360 for d in degrees)


def test_snapshot_frames():
    """[n, M] rows with count c -> [n / navg, navg M] frames with count c
    // navg, each frame its snapshots in order; a block of other than
    whole frames is refused."""
    x = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    blk = doa.SnapshotFrames(8)
    _, (y,) = blk.apply(None, None, Stream.full(x).like(x, count=21))
    assert y.data.shape == (3, 24) and int(y.count) == 2
    assert torch.equal(y.data[1], x[8:16].reshape(-1))
    with pytest.raises(ValueError):
        blk.apply(None, None, Stream.full(x[:20]))


def _small():
    cfg = dict(manifest.config("doa"), navg=256)
    return cfg, manifest.program("doa"), manifest.reference("doa")


def test_chain_through_the_executor_matches_the_reference():
    """3 blocks of 2^12 snapshots, 2 frames of 256 each, from a seeded
    ring of 3 through ``StreamExecutor``: no bearing more than one bin
    from the reference's and the spectrum within the cell's limits; the
    reference finds the planted bearings within a bin."""
    cfg, prog, ref = _small()
    seed = 2 ** 31 + 27
    ring = prog.ring(cfg, 1, 3, 1 << 12, seed, CPU)[0]
    assert ring.shape == (3, 1 << 12, M) and ring.dtype == np.complex64
    planted = prog.bearings(cfg, 3, seed, 0)
    ex = prog.executor(cfg, 1 << 12, CPU)
    for j in range(3):
        outs = ex.step({"iq": ring[j]})
        assert outs["spectrum"][0].shape == (2, 360) and \
            outs["spectrum"][1] == outs["doas"][1] == 2
        want = ref.outputs(cfg, ring, j, "f64", CPU)
        nums = ref.numbers({p: outs[p] for p in prog.PORTS}, want)
        for name, v in nums.items():
            assert v <= ref.LIMITS[name], (j, nums)
        for f in range(2):  # 256 snapshots: within a bin of the truth
            d = np.abs(want["doas"][f][:, None] - planted[j][None, :]) % 360
            assert (np.minimum(d, 360 - d).min(axis=0) <= 1).all(), (j, f)


def test_executor_refuses_a_block_of_partial_frames():
    cfg, prog, _ = _small()
    with pytest.raises(ValueError):
        prog.executor(cfg, 3000, CPU)


def test_music_spans_a_step():
    """Under ``trace.enable()`` one step gives one ``music.cov``, one
    ``music.subspace`` with n >= 24 (the iteration floor) and at least
    one ``music.sync``, all of the step's block; ``music.spectrum``
    once."""
    cfg, prog, _ = _small()
    ring = prog.ring(cfg, 1, 1, 1 << 12, 7, CPU)[0]
    ex = prog.executor(cfg, 1 << 12, CPU)
    ex.step({"iq": ring[0]})
    trace.clear()
    trace.enable()
    try:
        ex.step({"iq": ring[0]})
    finally:
        trace.disable()
    got = trace.spans()
    trace.clear()
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    assert len(by["music.cov"]) == len(by["music.subspace"]) == 1
    assert len(by["music.spectrum"]) == 1 and len(by["block.music"]) == 1
    assert by["music.subspace"][0].n >= 24
    syncs = by["music.sync"]
    assert len(syncs) >= 1 and all(s.parent == "music.subspace"
                                   for s in syncs)
    seq = by["block.music"][0].seq
    assert all(s.seq == seq for s in syncs + by["music.cov"])
    assert syncs[-1].n == 0
