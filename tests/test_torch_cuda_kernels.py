"""The port's CUDA kernels == their plain PyTorch twins, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor ``grbaz_tpu`` (the machine with the
card has no JAX), so run it there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import time

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core.executor import InputSpec, StreamExecutor
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models import wbfm
from grbaz_tpu_torch.ops import exact, fir
from grbaz_tpu_torch.ops.cuda import audio_tail as at
from grbaz_tpu_torch.ops.cuda import channel_bank as cb
from grbaz_tpu_torch.ops.cuda import fir_decimate as fd
from grbaz_tpu_torch.ops.cuda import tiling
from grbaz_tpu_torch.ops.cuda import xlating_fir as xf
from grbaz_tpu_torch.ops.cuda import xlating_fir_ctaps as xc
from grbaz_tpu_torch.ops.demod import FMDeemphasis
from grbaz_tpu_torch.ops.resampler import FractionalResampler

pytestmark = pytest.mark.cuda

FS = 3.2e6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cn(gen, n, dev):
    x = gen.standard_normal(n) + 1j * gen.standard_normal(n)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


def _err(got, ref):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    return np.abs(got - ref).max() / np.abs(ref).max()


def _taps(decim, dev, cutoff=112.5e3, transition=75e3):
    h = fir.prepare_taps(fir.low_pass_taps(1.0, FS, cutoff, transition), decim)
    return torch.from_numpy(h).to(dev)


@pytest.mark.parametrize("n,decim", [(8192, 8), (8192 + 24, 8), (1000, 4),
                                     (640, 5)])
@pytest.mark.parametrize("ph,inc", [(0, 1), (0xFFFFF000, 0x9E3779B9)])
def test_xlating_fir_kernels_match_plain(dev, n, decim, ph, inc):
    gen = np.random.default_rng(n + decim)
    h = _taps(decim, dev)
    x, tail = _cn(gen, n, dev), _cn(gen, h.shape[0], dev)
    ph = torch.tensor(ph, device=dev)
    inc = torch.tensor(inc, device=dev)
    ref = xf.xlating_fir_block_plain(x, tail, h, decim, ph, inc)
    got = xf.xlating_fir_block_kernel(x, tail, h, decim, ph, inc)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5
    frame = torch.cat([tail[1:], x])
    ref = xf.xlating_fir_frame_rtf_plain(frame, h, decim, ph, inc)
    got = xf.xlating_fir_frame_rtf_kernel(frame, h, decim, ph, inc)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("ph,inc", [(0, 1), (0xFFFFF000, 0x9E3779B9)])
def test_rotating_kernels_store_plus_zeros_on_zero_input(dev, ph, inc):
    """An all-zero block after an all-zero tail: B1, B4 and the bank give
    +0 in every output component, as their plain versions do (a zero
    rotated by a negative cosine would be -0, and atan2 downstream reads
    the sign of a zero)."""
    n, decim, slots = 8192, 8, 4
    h = _taps(decim, dev)
    x = torch.zeros(n, dtype=torch.complex64, device=dev)
    tail = torch.zeros(h.shape[0], dtype=torch.complex64, device=dev)
    ph_t, inc_t = torch.tensor(ph, device=dev), torch.tensor(inc, device=dev)
    outs = [xf.xlating_fir_block_kernel(x, tail, h, decim, ph_t, inc_t),
            xf.xlating_fir_frame_rtf_kernel(torch.cat([tail[1:], x]), h,
                                            decim, ph_t, inc_t),
            cb.channel_bank(x, tail[1:].expand(slots, -1).contiguous(), h,
                            decim, ph_t.expand(slots).contiguous(),
                            inc_t.expand(slots).contiguous())[0]]
    ref = xf.xlating_fir_block_plain(x, tail, h, decim, ph_t, inc_t)
    torch.cuda.synchronize()
    assert not torch.signbit(torch.view_as_real(ref)).any()
    for y in outs:
        re = torch.view_as_real(y)
        assert not re.any() and not torch.signbit(re).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("n,decim,spec", [(131072, 8, (21.6e3, 9.6e3)),
                                          (4000, 8, (112.5e3, 75e3)),
                                          (999, 3, (300e3, 100e3)),
                                          (512, 1, (300e3, 100e3))])
def test_fir_decimate_kernel_matches_plain(dev, dtype, n, decim, spec):
    gen = np.random.default_rng(n)
    h = _taps(decim, dev, *spec)
    frame = _cn(gen, h.shape[0] - 1 + n, dev)
    if dtype == torch.float32:
        frame = frame.real.contiguous()
    ref = fd.fir_decimate_frame_plain(frame, h, decim)
    got = fd.fir_decimate_frame_kernel(frame, h, decim)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    assert _err(got, ref) < 1e-5


def test_wrappers_count_launches_and_reject_bad_input(dev):
    h = _taps(8, dev)
    x = torch.zeros(1024, dtype=torch.complex64, device=dev)
    tail = torch.zeros(h.shape[0], dtype=torch.complex64, device=dev)
    z = torch.zeros((), dtype=torch.int64, device=dev)
    before = xf.xlating_fir_block.launches
    xf.xlating_fir_block(x, tail, h, 8, z, z)
    assert xf.xlating_fir_block.launches == before + 1
    with pytest.raises(TypeError):
        xf.xlating_fir_block(x.real, tail, h, 8, z, z)
    with pytest.raises(ValueError):
        xf.xlating_fir_block(x, tail.cpu(), h, 8, z, z)
    before = fd.fir_decimate_frame.launches
    fd.fir_decimate_frame(torch.zeros(2000, device=dev), h, 8)
    assert fd.fir_decimate_frame.launches == before + 1


@pytest.mark.parametrize("n", [1 << 14, 64, 1000])
def test_channel_block_kernel_arm_equals_plain_arm(dev, n):
    """The block on the card through the kernel's block entry point, for
    full, short and ragged blocks, and the plain arm agree over chained
    blocks: outputs, and the rotated tail both arms carry."""
    taps = fir.low_pass_taps(1.0, FS, 112.5e3, 75e3)
    gen = np.random.default_rng(7)
    blocks = [_cn(gen, n, dev) for _ in range(3)]
    outs, states = {}, {}
    for backend in ("kernel", "plain"):
        blk = fir.FreqXlatingFIRDecimator(taps, 8, 250e3, FS,
                                          backend=backend, device=dev)
        st, pr, ys = blk.init_state(), blk.init_params(), []
        for x in blocks:
            st, (y,) = blk.apply(st, pr, Stream.full(x))
            ys.append(y.data)
        outs[backend], states[backend] = torch.cat(ys), st
    assert _err(outs["kernel"], outs["plain"]) < 1e-5
    assert _err(states["kernel"]["tail"], states["plain"]["tail"]) < 1e-6
    assert torch.equal(states["kernel"]["phase"], states["plain"]["phase"])


def test_cascade_checkpoint_from_the_card_resumes_on_the_cpu(dev, tmp_path):
    """The cascade chain's state saved on the card after two blocks and a
    retune, loaded into the chain on the CPU: its next blocks equal the
    card's own continuation at the chain bar (1e-4 of the max). The card
    runs the audio tail on its kernels (each launched once a step); the
    resampler's positions continue on the CPU bit for bit."""
    from grbaz_tpu_torch.core import checkpoint
    launches = (at.fractional_resample.launches, at.fm_deemphasis.launches)
    cfg = wbfm.WBFMConfig(block_size=1 << 14, audio_chain="cascade",
                          center_freq=250e3)
    gen = np.random.default_rng(12)
    blocks = [_cn(gen, 1 << 14, dev) for _ in range(4)]
    fg, _ = wbfm.build_wbfm(cfg, device=dev)
    step = fg.compile().step
    states, params = fg.init_states(), fg.init_params()
    for x in blocks[:2]:
        states, _ = step(states, params, {"iq": Stream.full(x)})
    assert (at.fractional_resample.launches - launches[0],
            at.fm_deemphasis.launches - launches[1]) == (2, 2)
    retune = fir.FreqXlatingFIRDecimator.freq_params(-431.7e3, FS)
    path = str(tmp_path / "cascade.npz")
    checkpoint.save_state(path, states)
    fg_cpu, _ = wbfm.build_wbfm(cfg, device="cpu")
    step_cpu = fg_cpu.compile().step
    st_cpu, _, _ = checkpoint.load_state(path, fg_cpu.init_states())
    pr_cpu = fg_cpu.init_params()
    for pr, d in ((params, dev), (pr_cpu, "cpu")):
        pr["channel"]["lo_inc"] = torch.tensor(int(retune["lo_inc"]),
                                               device=d)
    for x in blocks[2:]:
        states, card = step(states, params, {"iq": Stream.full(x)})
        st_cpu, cpu = step_cpu(st_cpu, pr_cpu, {"iq": Stream.full(x.cpu())})
        for port in ("quad", "audio"):
            got, ref = card[port], cpu[port]
            c = int(ref.count)
            assert int(got.count) == c
            assert _err(got.data[:c], ref.data[:c]) < 1e-4, port
        for k in ("mu_int", "mu_frac"):
            assert torch.equal(states["resampler"][k].cpu(),
                               st_cpu["resampler"][k]), k


@pytest.mark.parametrize("n,decim", [(1 << 20, 8), (8192 + 24, 8), (1000, 4),
                                     (640, 5), (37, 8)])
@pytest.mark.parametrize("inc", [1, 3123456789, 0x9E3779B9])
def test_xlating_fir_ctaps_kernel_matches_plain(dev, n, decim, inc):
    gen = np.random.default_rng(n + decim)
    h = _taps(decim, dev)
    x, tail = _cn(gen, n, dev), _cn(gen, h.shape[0], dev)
    inc = torch.tensor(inc, device=dev)
    ref = xc.xlating_fir_ctaps_block_plain(x, tail, h, decim, inc)
    got = xc.xlating_fir_ctaps_block_kernel(x, tail, h, decim, inc)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (n // decim,)
    assert _err(got, ref) < 1e-5
    frame = torch.cat([tail[1:], x])
    got = xc.xlating_fir_ctaps_frame_kernel(frame, h, decim, inc)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


def test_ctaps_wrappers_count_launches_and_reject_bad_input(dev):
    h = _taps(8, dev)
    x = torch.zeros(1024, dtype=torch.complex64, device=dev)
    tail = torch.zeros(h.shape[0], dtype=torch.complex64, device=dev)
    inc = torch.zeros((), dtype=torch.int64, device=dev)
    before = xc.xlating_fir_ctaps_block.launches
    xc.xlating_fir_ctaps_block(x, tail, h, 8, inc)
    assert xc.xlating_fir_ctaps_block.launches == before + 1
    before = xc.xlating_fir_ctaps_frame.launches
    xc.xlating_fir_ctaps_frame(torch.cat([tail[1:], x]), h, 8, inc)
    assert xc.xlating_fir_ctaps_frame.launches == before + 1
    with pytest.raises(TypeError):
        xc.xlating_fir_ctaps_block(x.real, tail, h, 8, inc)
    with pytest.raises(ValueError):
        xc.xlating_fir_ctaps_block(x, tail.cpu(), h, 8, inc)
    with pytest.raises(ValueError):
        xc.xlating_fir_ctaps_block(x, tail[1:], h, 8, inc)
    with pytest.raises(TypeError):
        xc.xlating_fir_ctaps_block(x, tail, h, 8, inc.to(torch.int32))
    with pytest.raises(ValueError):
        xc.xlating_fir_ctaps_block(x, tail, h[1:], 8, inc)
    with pytest.raises(ValueError):
        xc.xlating_fir_ctaps_frame(x[:50], h, 8, inc)


def test_polyphase_launch_refuses_a_geometry_it_does_not_take(dev):
    """A Geometry field left at 0 (a ctypes structure built without it)
    or out of range is refused with cudaErrorInvalidValue (1), never
    launched; the host's own geometry launches."""
    h = _taps(8, dev)
    tpad = h.shape[0]
    x = torch.zeros(8192, dtype=torch.complex64, device=dev)
    tail = torch.zeros(tpad, dtype=torch.complex64, device=dev)
    inc = torch.zeros((), dtype=torch.int64, device=dev)
    y = torch.empty(1024, dtype=torch.complex64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    good = tiling.for_tensor(x, 1024, tpad, 8, 8)
    lib = xc._lib()
    for field, value in (("threads", 0), ("r", 0), ("split", 0),
                         ("threads", 288), ("r", 3), ("split", 3)):
        geo = tiling.Geometry(good.threads, good.r, good.split)
        setattr(geo, field, value)
        err = lib.xlating_fir_ctaps_block(
            x.data_ptr(), tail.data_ptr(), 8192, h.data_ptr(),
            inc.data_ptr(), y.data_ptr(), 1024, tpad, 8, geo, stream)
        assert err == 1, (field, value, err)
    assert lib.xlating_fir_ctaps_block(
        x.data_ptr(), tail.data_ptr(), 8192, h.data_ptr(), inc.data_ptr(),
        y.data_ptr(), 1024, tpad, 8, good, stream) == 0
    torch.cuda.synchronize()


def _random_taps(gen, taps, decim, dev):
    h = fir.prepare_taps(gen.standard_normal(taps).astype(np.float32), decim)
    return torch.from_numpy(h).to(dev)


def _polyphase_cases(gen, n, h, decim, dev):
    """(label, kernel output, plain output) of every polyphase entry point
    on a block ``x`` whose data starts 8 bytes past a 16-byte boundary:
    B1 and B4 (rotated output), B2's two entry points (unrotated output),
    B3's two entry points for both sample types."""
    tpad = h.shape[0]
    x, tail = _cn(gen, n + 1, dev)[1:], _cn(gen, tpad, dev)
    assert x.data_ptr() % 16 == 8
    frame = torch.cat([tail[1:], x])
    ph, inc = torch.tensor(0xFFFFF000, device=dev), \
        torch.tensor(0x9E3779B9, device=dev)
    out = [("B1", xf.xlating_fir_block_kernel(x, tail, h, decim, ph, inc),
            xf.xlating_fir_block_plain(x, tail, h, decim, ph, inc)),
           ("B4", xf.xlating_fir_frame_rtf_kernel(frame, h, decim, ph, inc),
            xf.xlating_fir_frame_rtf_plain(frame, h, decim, ph, inc)),
           ("B2 block", xc.xlating_fir_ctaps_block_kernel(x, tail, h, decim,
                                                          inc),
            xc.xlating_fir_ctaps_block_plain(x, tail, h, decim, inc)),
           ("B2 frame", xc.xlating_fir_ctaps_frame_kernel(frame, h, decim,
                                                          inc),
            xc.xlating_fir_ctaps_frame_plain(frame, h, decim, inc))]
    for xs, ts in ((x, tail), (x.real, tail.real)):
        fs = torch.cat([ts[1:], xs])
        out.append((f"B3 frame {xs.dtype}",
                    fd.fir_decimate_frame_kernel(fs, h, decim),
                    fd.fir_decimate_frame_plain(fs, h, decim)))
        out.append((f"B3 block {xs.dtype}",
                    fd.fir_decimate_block_kernel(xs, ts, h, decim),
                    fd.fir_decimate_block_plain(ts, xs, h, decim)))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("n_out", [1, 7, 37, 1000, 4099])
@pytest.mark.parametrize("taps", [176, 1024])
@pytest.mark.parametrize("decim", [1, 3, 4, 5, 8])
def test_polyphase_kernels_at_ragged_shapes(dev, decim, taps, n_out):
    """Outputs below one tile and not a multiple of R or of the tile, a
    first tile that straddles the tail and a block at a non-16-byte
    offset, decim 1-8, 176 and 1024 taps; the block ragged by decim-1."""
    gen = np.random.default_rng(n_out * 31 + decim * 7 + taps)
    h = _random_taps(gen, taps, decim, dev)
    n = n_out * decim + decim - 1
    for label, got, ref in _polyphase_cases(gen, n, h, decim, dev):
        assert got.shape == ref.shape == (n_out,), label
        assert _err(got, ref) < 1e-5, label


@pytest.mark.parametrize("n,decim,taps,want", [
    (1 << 20, 8, 104, (256, 8, 4)), (131072, 8, 176, (128, 4, 8)),
    (1 << 20, 8, 1024, (256, 8, 4)), (1 << 17, 1, 1024, (256, 8, 1)),
    (8000, 2, 4, (128, 2, 2)), (8000, 8, 8, (128, 1, 8)),
    (4000, 1, 13500, (32, 1, 1))])
def test_polyphase_kernels_for_every_window_and_split(dev, n, decim, taps,
                                                      want):
    """Shapes whose host geometry reaches every window (8, 4, 2, 1), every
    split (1, 2, 4, 8), fewer threads for long taps, and shared memory
    above 48 KB (1024 taps at decim 8; 13500 taps at decim 1, ~211 KB,
    the longest that fit with complex taps): B1, B2 and B3."""
    gen = np.random.default_rng(decim + taps)
    h = _random_taps(gen, taps, decim, dev)
    tpad = h.shape[0]
    x, tail = _cn(gen, n, dev), _cn(gen, tpad, dev)
    geo = tiling.for_tensor(x, n // decim, tpad, decim, 8)
    assert (geo.threads, geo.r, geo.split) == want
    if taps >= 1024 and decim == 8:
        assert tiling.smem_bytes(geo, tpad, decim, 8, 8) > 48 * 1024
    ph, inc = torch.tensor(12345, device=dev), torch.tensor(3123456789,
                                                            device=dev)
    got = xf.xlating_fir_block_kernel(x, tail, h, decim, ph, inc)
    ref = xf.xlating_fir_block_plain(x, tail, h, decim, ph, inc)
    assert _err(got, ref) < 1e-5, geo
    # B2 takes B1's geometry (complex samples and taps); both entry points
    ref2 = xc.xlating_fir_ctaps_block_plain(x, tail, h, decim, inc)
    got2 = xc.xlating_fir_ctaps_block_kernel(x, tail, h, decim, inc)
    assert _err(got2, ref2) < 1e-5, geo
    got2 = xc.xlating_fir_ctaps_frame_kernel(torch.cat([tail[1:], x]), h,
                                             decim, inc)
    assert _err(got2, ref2) < 1e-5, geo
    for xs, ts in ((x, tail), (x.real.contiguous(), tail.real.contiguous())):
        got3 = fd.fir_decimate_block_kernel(xs, ts, h, decim)
        ref3 = fd.fir_decimate_block_plain(ts, xs, h, decim)
        assert _err(got3, ref3) < 1e-5, (xs.dtype, geo)


@pytest.mark.parametrize("n", [16384, 1000, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_fir_decimator_block_entry_equals_plain_arm(dev, n, dtype):
    """FIRDecimator over 3 chained blocks: the kernel arm (the block entry
    point, tail read in place) against the plain arm, outputs and tails."""
    taps = fir.low_pass_taps(1.0, 400e3, 21.6e3, 9.6e3,
                             window="blackmanharris")
    gen = np.random.default_rng(n)
    blocks = [_cn(gen, n, dev) for _ in range(3)]
    if dtype == torch.float32:
        blocks = [b.real.contiguous() for b in blocks]
    outs, tails = {}, {}
    before = fd.fir_decimate_block.launches
    for backend in ("kernel", "plain"):
        blk = fir.FIRDecimator(taps, 8, dtype=dtype, backend=backend,
                               device=dev)
        st, ys = blk.init_state(), []
        for x in blocks:
            st, (y,) = blk.apply(st, {}, Stream.full(x))
            ys.append(y.data)
        outs[backend], tails[backend] = torch.cat(ys), st["tail"]
    assert fd.fir_decimate_block.launches == before + 3
    assert outs["kernel"].dtype == dtype
    assert _err(outs["kernel"], outs["plain"]) < 1e-5
    assert torch.equal(tails["kernel"], tails["plain"])


@pytest.mark.parametrize("squelch", [None, -20.0])
@pytest.mark.parametrize("n", [1 << 14, 1000])
def test_frontend_kernel_arm_equals_plain_arm(dev, squelch, n):
    taps = fir.low_pass_taps(1.0, FS, 112.5e3, 75e3)
    gen = np.random.default_rng(11)
    # loud enough that the squelch gate opens within the first block
    blocks = [10 * _cn(gen, n, dev) for _ in range(3)]
    outs, states = {}, {}
    for backend in ("kernel", "plain"):
        fe = wbfm.WBFMFrontend(taps, 8, 250e3, FS, 0.85, squelch_db=squelch,
                               backend=backend, device=dev)
        st, pr, ys = fe.init_state(), fe.init_params(), []
        for x in blocks:
            st, (y,) = fe.apply(st, pr, Stream.full(x))
            ys.append(y.data)
        outs[backend], states[backend] = torch.cat(ys), st
    got, ref = outs["kernel"].cpu().numpy(), outs["plain"].cpu().numpy()
    bad = np.where(np.abs(got - ref) > 1e-4 * np.abs(ref).max())[0]
    # a squelch gate may flip where the average meets the threshold
    # within rounding: one side zeroed, at most 8 samples
    assert len(bad) <= (0 if squelch is None else 8)
    assert all(got[i] == 0 or ref[i] == 0 for i in bad)
    assert np.abs(ref).max() > 0
    assert torch.equal(states["kernel"]["tail"], states["plain"]["tail"])
    assert torch.equal(states["kernel"]["phase"], states["plain"]["phase"])


def test_dispatch_does_not_wait_for_the_card(dev):
    """dispatch returns while a queued sleep still holds the card, and a
    retune written to ex.params reaches the next dispatched block."""
    n = 1 << 14
    cfg = wbfm.WBFMConfig(block_size=n, center_freq=250e3, fused=True)
    fg, _ = wbfm.build_wbfm(cfg, device=dev)
    ex = StreamExecutor(fg, {"iq": InputSpec((n,), "complex64", FS)},
                        device=dev)
    x = np.exp(2j * np.pi * 250e3 / FS * np.arange(n)).astype(np.complex64)
    ex.step({"iq": x})  # warm-up: builds the kernel, fills the caches
    ex.params["frontend"] = dict(ex.params["frontend"],
                                 **wbfm.WBFMFrontend.freq_params(0.0, FS))
    ex.step({"iq": x})  # the numpy lo_inc is uploaded once here
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # ~1 s of card time
    t0 = time.perf_counter()
    step = ex.dispatch({"iq": x})
    host_s = time.perf_counter() - t0
    done = torch.cuda.Event()
    done.record()
    busy = not done.query()
    assert busy and host_s < 0.5, \
        f"dispatch took {host_s:.3f} s; card still busy after it: {busy}"
    quad_off = ex.fetch(step)["quad"][0]
    ex.params["frontend"] = dict(ex.params["frontend"],
                                 **wbfm.WBFMFrontend.freq_params(250e3, FS))
    ex.step({"iq": x})  # tail and phase settle on the new tuning
    quad_on = ex.step({"iq": x})["quad"][0]
    # tuned onto the carrier the discriminator reads ~0; 250 kHz off it
    # reads the 250 kHz phase step
    assert np.abs(quad_on).max() < 1e-3
    assert np.abs(quad_off).mean() > 0.1


def test_executor_fetch_does_not_wait_for_later_work(dev):
    """fetch brings a step's outputs back while work queued after the step
    on the executor's compute stream (a sleep, as its next steps in
    flight would be) still runs: its copies wait for their step alone.
    The outputs equal the same step's before."""
    n = 1 << 14
    cfg = wbfm.WBFMConfig(block_size=n, center_freq=250e3, fused=True)
    fg, _ = wbfm.build_wbfm(cfg, device=dev)
    ex = StreamExecutor(fg, {"iq": InputSpec((n,), "complex64", FS)},
                        device=dev)
    x = np.exp(2j * np.pi * 250e3 / FS * np.arange(n)).astype(np.complex64)
    want = ex.step({"iq": x})  # warm-up: builds the kernel, fills the caches
    ex.reset()
    step = ex.dispatch({"iq": x})
    with torch.cuda.stream(ex._compute):
        torch.cuda._sleep(int(2e9))  # ~1 s of card time behind the step
    t0 = time.perf_counter()
    got = ex.fetch(step)
    host_s = time.perf_counter() - t0
    done = torch.cuda.Event()
    done.record(ex._compute)
    busy = not done.query()
    assert busy and host_s < 0.5, \
        f"fetch took {host_s:.3f} s; card still busy after it: {busy}"
    assert got.keys() == want.keys()
    for port, (data, count) in want.items():
        assert got[port][1] == count
        assert np.array_equal(got[port][0], data), port


def _bank_inputs(gen, slots, n, decim, dev, wrap):
    h = _taps(decim, dev)
    tail = _cn(gen, slots * (h.shape[0] - 1), dev).reshape(slots, -1)
    if wrap:  # phases and increments that wrap every few samples
        ph = gen.integers(2 ** 32 - 4096, 2 ** 32, slots)
        inc = gen.integers(2 ** 31, 2 ** 32, slots)
    else:
        ph = gen.integers(0, 2 ** 32, slots)
        inc = gen.integers(0, 2 ** 26, slots)
    return (_cn(gen, n, dev), tail, h, torch.from_numpy(ph).to(dev),
            torch.from_numpy(inc).to(dev))


@pytest.mark.parametrize("slots", [1, 3, 16, 20])
@pytest.mark.parametrize("n,decim", [(1 << 17, 8), (8192 + 24, 8), (1000, 4),
                                     (37, 8)])
@pytest.mark.parametrize("wrap", [False, True])
def test_channel_bank_kernel_matches_plain(dev, slots, n, decim, wrap):
    """The bank's kernel against its plain version over two chained
    blocks, one launch a call (20 slots: two slot groups), the second call
    on the first's new tail with every other slot retuned (its tail
    rotated under the old increment); y and the new tail within 1e-5.
    Each slot of the first call also against B1's single-slot kernel over
    the derotated tail."""
    gen = np.random.default_rng(slots * 1000 + n + decim + wrap)
    x, tail, h, ph, inc = _bank_inputs(gen, slots, n, decim, dev, wrap)
    x2 = _cn(gen, n, dev)
    inc2 = torch.where(torch.arange(slots, device=dev) % 2 == 0,
                       inc ^ 0x5A5A5A5, inc)
    ph2 = (ph + n * inc) & 0xFFFFFFFF
    before = cb.channel_bank.launches
    y, t = cb.channel_bank(x, tail, h, decim, ph, inc)
    y2, t2 = cb.channel_bank(x2, t, h, decim, ph2, inc2)
    ref, ref_t = cb.channel_bank_plain(x, tail, h, decim, ph, inc)
    ref2, ref_t2 = cb.channel_bank_plain(x2, ref_t, h, decim, ph2, inc2)
    torch.cuda.synchronize()
    assert cb.channel_bank.launches == before + 2
    assert y.shape == ref.shape == (slots, n // decim)
    assert t.shape == ref_t.shape == tail.shape
    if n // decim:
        assert _err(y, ref) < 1e-5
        assert _err(y2, ref2) < 1e-5
    assert _err(t, ref_t) < 1e-5
    assert _err(t2, ref_t2) < 1e-5
    if n // decim == 0:
        return
    hist = tail.shape[1]
    past = torch.arange(-hist, 0, device=dev)
    zero = torch.zeros(1, dtype=torch.complex64, device=dev)
    for c in range(slots):
        unrot = tail[c] * exact.lo_at(ph[c], inc[c], past, conj=True)
        one = xf.xlating_fir_block_kernel(x, torch.cat([zero, unrot]), h,
                                          decim, ph[c], inc[c])
        assert _err(one, y[c]) < 1e-5, c


def test_channel_bank_kernel_takes_a_misaligned_view(dev):
    """x one sample into its storage (8-byte, not 16-byte aligned), and a
    tail view: the kernel copies samples one by one and the wrapper makes
    the tail contiguous."""
    gen = np.random.default_rng(9)
    x, tail, h, ph, inc = _bank_inputs(gen, 5, 8192 + 9, 8, dev, True)
    xv = x[1:]
    assert xv.data_ptr() % 16 == 8
    wide = torch.cat([tail, tail], dim=1)[:, :tail.shape[1]]
    y, t = cb.channel_bank(xv, wide, h, 8, ph, inc)
    ref, ref_t = cb.channel_bank_plain(xv, tail, h, 8, ph, inc)
    torch.cuda.synchronize()
    assert _err(y, ref) < 1e-5 and _err(t, ref_t) < 1e-5


def test_channel_bank_refuses_bad_input(dev):
    gen = np.random.default_rng(5)
    x, tail, h, ph, inc = _bank_inputs(gen, 4, 4096, 8, dev, False)
    with pytest.raises(TypeError):
        cb.channel_bank(x, tail, h, 8, ph[:3], inc)
    with pytest.raises(TypeError):
        cb.channel_bank(x, tail, h, 8, ph, inc.to(torch.int32))
    with pytest.raises(ValueError):
        cb.channel_bank(x, tail[:, 1:], h, 8, ph, inc)
    with pytest.raises(ValueError):
        cb.channel_bank(x, tail.cpu(), h, 8, ph, inc)
    with pytest.raises(TypeError):
        cb.channel_bank(x.real, tail, h, 8, ph, inc)
    with pytest.raises(ValueError):
        cb.channel_bank(x, tail, h[1:], 8, ph, inc)
    # straight through the C entry point: no slot, a bad decim, taps that
    # are no multiple of decim, an output count that is not n // decim, or
    # taps or a decim past the kernel's int sizes (MAX_TAPS, MAX_DECIM) are
    # refused with cudaErrorInvalidValue (1) and never launched; 8192 taps
    # (several slabs) are taken
    tpad, n_out = h.shape[0], 512
    y = torch.empty(4, n_out, dtype=torch.complex64, device=dev)
    nt = torch.empty_like(tail)
    big = torch.zeros(8192, device=dev)
    big_tail = torch.zeros(4, 8191, dtype=torch.complex64, device=dev)
    big_nt = torch.empty_like(big_tail)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = cb._lib()

    def launch(slots=4, decim=8, taps=tpad, outs=n_out, hp=h, tl=tail,
               ntl=nt):
        return lib.channel_bank(
            x.data_ptr(), tl.data_ptr(), 4096, hp.data_ptr(),
            ph.data_ptr(), inc.data_ptr(), y.data_ptr(), ntl.data_ptr(), outs,
            taps, decim, slots, stream)
    assert launch(slots=0) == 1
    assert launch(decim=0) == 1
    assert launch(taps=tpad - 1) == 1
    assert launch(outs=n_out - 1) == 1
    assert launch(taps=(1 << 24) + 8) == 1
    assert launch(decim=1 << 21, taps=1 << 21, outs=0) == 1
    assert launch(taps=8192, hp=big, tl=big_tail, ntl=big_nt) == 0
    torch.cuda.synchronize()
    assert not y.any()  # zero taps, zero tail
    assert launch() == 0
    torch.cuda.synchronize()
    # pfir::launch checks every Geometry field before it divides by r:
    # r = 0 is refused through B1's single-slot entry point
    good = tiling.for_tensor(x, n_out, tpad, 8, 8)
    one = torch.empty(n_out, dtype=torch.complex64, device=dev)
    full = torch.cat([torch.zeros(1, dtype=torch.complex64, device=dev),
                      tail[0]])
    for geo in (tiling.Geometry(good.threads, 0, good.split), good):
        err = xf._lib().xlating_fir_block(
            x.data_ptr(), full.data_ptr(), 4096, h.data_ptr(),
            ph[0].data_ptr(), inc[0].data_ptr(), one.data_ptr(), n_out,
            tpad, 8, geo, stream)
        assert err == (0 if geo is good else 1)
    torch.cuda.synchronize()


def _hann(n):
    return lambda: np.hanning(n).astype(np.float32)


def _nbfm(transition):
    return lambda: fir.low_pass_taps(1.0, FS, 6.25e3 + transition / 2,
                                     transition)


# name: (taps, decim, block). 1544 taps at decim 8 (4 slabs of taps),
# 8192 at decim 8 (21 slabs), 4096 at decim 256 (slabs of fewer taps than
# decim; 2 head passes of 2 frame slabs), 5000 at decim 1 (157 head
# passes of 2 frame slabs)
LONG_FILTERS = {"nbfm-1544": (_nbfm(5e3), 8, 1 << 17),
                "hann-8192": (_hann(8192), 8, 1 << 15),
                "nbfm-4096-decim256": (_nbfm(2e3), 256, 40000),
                "hann-5000-decim1": (_hann(5000), 1, 12000)}


@pytest.mark.parametrize("name", list(LONG_FILTERS))
@pytest.mark.parametrize("slots", [4, 20])
def test_channel_bank_kernel_takes_long_filters(dev, name, slots):
    """Filters far longer than the scanner's, which the kernel takes in
    slabs of taps, against the plain version over two chained blocks, the
    second retuned; y and the new tail within 1e-5."""
    taps, decim, n = LONG_FILTERS[name]
    gen = np.random.default_rng(slots + decim + n)
    h = torch.from_numpy(fir.prepare_taps(taps(), decim)).to(dev)
    ph = torch.from_numpy(gen.integers(2 ** 32 - 4096, 2 ** 32, slots))
    inc = torch.from_numpy(gen.integers(2 ** 31, 2 ** 32, slots))
    ph, inc = ph.to(dev), inc.to(dev)
    tail = _cn(gen, slots * (h.shape[0] - 1), dev).reshape(slots, -1)
    x, x2 = _cn(gen, n, dev), _cn(gen, n, dev)
    inc2 = inc ^ 0x5A5A5A5
    ph2 = (ph + n * inc) & 0xFFFFFFFF
    y, t = cb.channel_bank(x, tail, h, decim, ph, inc)
    y2, t2 = cb.channel_bank(x2, t, h, decim, ph2, inc2)
    ref, ref_t = cb.channel_bank_plain(x, tail, h, decim, ph, inc)
    ref2, ref_t2 = cb.channel_bank_plain(x2, ref_t, h, decim, ph2, inc2)
    torch.cuda.synchronize()
    for got, want in ((y, ref), (t, ref_t), (y2, ref2), (t2, ref_t2)):
        assert got.shape == want.shape
        assert _err(got, want) < 1e-5


BANK_TUNINGS = (-1.2e6, -400e3, 250e3, 900e3, 600e3, -700e3)


def _stations(gen, n, dev, deviation=5e3):
    """4 blocks of n samples: an FM station on every frequency the bank
    tunes to (tone 1 kHz + 100 Hz a station), noise 50 dB down."""
    t = torch.arange(4 * n, dtype=torch.float64, device=dev) / FS
    x = 0.003 * _cn(gen, 4 * n, dev)
    for k, f in enumerate(BANK_TUNINGS):
        tone = 1e3 + 100 * k
        ph = 2 * np.pi * f * t + deviation / tone * torch.sin(
            2 * np.pi * tone * t)
        x = x + torch.polar(torch.ones_like(t), ph).to(torch.complex64)
    return list(x.reshape(4, n))


def _arm_vs_plain(dev, n, capacity, width, transition, stations=False):
    """DynamicChannelBank over 4 chained blocks with inactive slots, a
    removal, a retune and a reused slot: the kernel arm (one launch per
    block) against the plain arm, outputs and state. Over noise, or over
    a station on every channel (a narrow channel of noise demodulates to
    angles of samples near zero, where rounding flips them)."""
    gen = np.random.default_rng(n)
    blocks = (_stations(gen, n, dev) if stations
              else [_cn(gen, n, dev) for _ in range(4)])
    from grbaz_tpu_torch.parallel.channel_bank import DynamicChannelBank
    outs, states = {}, {}
    before = cb.channel_bank.launches
    for backend in ("kernel", "plain"):
        bank = DynamicChannelBank(capacity, FS, 8, width, transition,
                                  backend=backend, device=dev)
        st, pr, qs = bank.init_state(), bank.init_params(), []
        for f in BANK_TUNINGS[:4]:
            bank.add_channel(pr, f)
        for b, x in enumerate(blocks):
            if b == 1:
                bank.remove_channel(pr, 1)
                bank.retune(pr, 2, BANK_TUNINGS[4])
            if b == 2:
                assert bank.add_channel(pr, BANK_TUNINGS[5]) == 1
            st, (q, act) = bank.apply(st, pr, Stream.full(x))
            qs.append(q.data)
        outs[backend], states[backend] = torch.cat(qs, dim=1), st
    assert cb.channel_bank.launches == before + len(blocks)
    assert _err(outs["kernel"], outs["plain"]) < 1e-4
    assert not outs["kernel"][4:].any()  # never-active slots stay zero
    for k in ("tail", "prev"):
        assert _err(states["kernel"][k], states["plain"][k]) < 1e-5, k
    assert torch.equal(states["kernel"]["phase"], states["plain"]["phase"])


@pytest.mark.parametrize("n", [1 << 17, 1000])
def test_channel_bank_kernel_arm_equals_plain_arm(dev, n):
    """The scanner's plan: 16 slots of 150 kHz channels."""
    _arm_vs_plain(dev, n, 16, 150e3, 75e3)


def test_narrow_band_bank_kernel_arm_equals_plain_arm(dev):
    """A narrow-band plan: 12.5 kHz channels with a 5 kHz transition, 1544
    taps, which the kernel takes in several slabs; a station on every
    channel."""
    _arm_vs_plain(dev, 1 << 17, 4, 12.5e3, 5e3, stations=True)


# ---------------------------------------------------------------------------
# the lockout / look-ahead peak FSM (csrc/peak_fsm.cu)
# ---------------------------------------------------------------------------

FSM_CASES = [dict(min_diff=0.5, lockout=64),
             dict(min_diff=0.3, min_len=2, lockout=10, drop=0.1),
             dict(min_diff=0.3, lockout=5, look_ahead=4, alpha=0.3),
             dict(min_diff=1.0, look_ahead=3)]


# (chunk, warm) of the speculative walk: the defaults, no warm-up at the
# smallest chunk (most guesses miss), odd sizes, a warm-up past a chunk
FSM_CHUNKS = [(256, 128), (8, 0), (37, 5), (1024, 300)]


@pytest.mark.parametrize("chunk,warm", FSM_CHUNKS)
@pytest.mark.parametrize("kw", FSM_CASES)
@pytest.mark.parametrize("rows,n", [(1, 5000), (3, 4096), (64, 1 << 14),
                                    (2, 12345)])
def test_peak_fsm_kernel_matches_plain(dev, kw, rows, n, chunk, warm):
    """Marks, idx_diff and every state field bit for bit over two chained
    calls: rows of independent streams, chunks whole and ragged, peaks of
    the first call landing on sample 0, whatever the chunk and warm-up."""
    from grbaz_tpu_torch.ops.cuda import peak_fsm as pf
    from grbaz_tpu_torch.ops.detect import PeakDetector
    gen = np.random.default_rng(rows * n)
    pd = PeakDetector(**kw, device="cpu")
    st_p = {k: v.reshape(1).expand(rows).clone()
            for k, v in pd.init_state().items()}
    st_k = {k: v.to(dev) for k, v in st_p.items()}
    thr = torch.tensor([0.2])
    for _ in range(2):
        x = gen.random((rows, n)).astype(np.float32)
        x[:, ::97] += 2.0
        x[:, -3:] = np.linspace(0.5, 3.0, 3)   # a rise open at the end
        x = torch.from_numpy(x)
        mp, ip, st_p = pf.peak_fsm(x, st_p, thr, **pd.fsm_config())
        mk, ik, st_k = pf.peak_fsm(x.to(dev), st_k, thr.to(dev),
                                   **pd.fsm_config(), chunk=chunk, warm=warm)
        torch.cuda.synchronize()
        assert torch.equal(mk.cpu(), mp) and torch.equal(ik.cpu(), ip)
        for k in st_p:
            assert torch.equal(st_k[k].cpu(), st_p[k]), k
        assert int(mp.sum()) > 0


@pytest.mark.parametrize("scene", ["ramp", "pulses"])
@pytest.mark.parametrize("chunk,warm", [(8, 0), (32, 32), (256, 128)])
def test_peak_fsm_kernel_repairs(dev, scene, chunk, warm):
    """The chunks walked again: every chunk but a row's first on a
    monotone ramp (each guess has the wrong start of the rise), none on
    pulses far apart above a threshold the noise stays under, once the
    warm-up covers the lockout; as many as the numpy model of the scheme
    (tests/test_torch_fsm_speculation.py) repairs, and the outputs bit for
    bit the plain version's over two chained calls."""
    from grbaz_tpu_torch.ops.cuda import peak_fsm as pf
    from grbaz_tpu_torch.ops.detect import PeakDetector
    from test_torch_fsm_speculation import _pulses, speculative_fsm
    gen = np.random.default_rng(chunk + warm)
    rows, n = 2, 4096
    if scene == "ramp":
        x = np.tile(np.linspace(0.01, 5.0, 2 * n, dtype=np.float32),
                    (rows, 1))
        thr = 0.0
    else:
        x = _pulses(gen, rows, 2 * n, 150, width=(2, 4))
        thr = 0.1
    cfg = PeakDetector(min_diff=0.3, lockout=24, device="cpu").fsm_config()
    st_p = {k: v.reshape(1).expand(rows).clone()
            for k, v in PeakDetector(device="cpu").init_state().items()}
    st_k = {k: v.to(dev) for k, v in st_p.items()}
    t = torch.full((rows,), thr)
    k = -(-n // chunk)
    for b in range(2):
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * n:(b + 1) * n]))
        *_, rep_m = speculative_fsm(
            xb.numpy(), {q: v.numpy() for q, v in st_p.items()}, t.numpy(),
            cfg, chunk, warm)
        mp, ip, st_p = pf.peak_fsm(xb, st_p, t, **cfg)
        mk, ik, st_k = pf.peak_fsm(xb.to(dev), st_k, t.to(dev), **cfg,
                                   chunk=chunk, warm=warm)
        rep_k = pf.peak_fsm.last_repairs.cpu().numpy()
        assert torch.equal(mk.cpu(), mp) and torch.equal(ik.cpu(), ip)
        for q in st_p:
            assert torch.equal(st_k[q].cpu(), st_p[q]), q
        assert list(rep_k) == list(rep_m)
        if scene == "ramp":
            assert list(rep_k) == [k - 1] * rows
        elif warm >= cfg["lockout"]:
            assert list(rep_k) == [0] * rows
            assert int(mp.sum()) > 0


def test_peak_fsm_wrapper_counts_launches_and_rejects_bad_input(dev):
    from grbaz_tpu_torch.ops.cuda import peak_fsm as pf
    from grbaz_tpu_torch.ops.detect import PeakDetector
    pd = PeakDetector(lockout=3, device=dev)
    st = {k: v.reshape(1) for k, v in pd.init_state().items()}
    thr = pd.init_params()["threshold"].reshape(1)
    x = torch.zeros(1, 100, device=dev)
    before = pf.peak_fsm.launches
    pf.peak_fsm(x, st, thr, **pd.fsm_config())
    assert pf.peak_fsm.launches == before + 1
    with pytest.raises(TypeError):
        pf.peak_fsm(x.double(), st, thr, **pd.fsm_config())
    with pytest.raises(ValueError):
        pf.peak_fsm_kernel(x, st, thr.cpu(), **pd.fsm_config())
    with pytest.raises(ValueError):
        pf.peak_fsm_kernel(x[:, :0], st, thr, **pd.fsm_config())
    with pytest.raises(ValueError):
        pf.peak_fsm_kernel(x, st, thr, **pd.fsm_config(), chunk=1)
    with pytest.raises(ValueError):
        pf.peak_fsm_kernel(x, st, thr, **pd.fsm_config(), chunk=4096)
    assert pf.peak_fsm.launches == before + 1


@pytest.mark.parametrize("retrig", [True, False])
def test_burst_blocks_on_the_card_equal_the_cpu(dev, retrig):
    """Gate, RadarDetector, BurstBuffer and the lockout PeakDetector over
    three chained blocks on the card: outputs and states equal to the same
    blocks on the CPU (event rows as bit patterns, radar sums within
    1e-5 relative)."""
    from grbaz_tpu_torch.core.stream import StreamMeta
    from grbaz_tpu_torch.ops import burst, detect
    gen = np.random.default_rng(3)
    n = 4096
    x = (0.05 * _cn(gen, 3 * n, "cpu"))
    for p in range(300, 3 * n, 1500):
        x[p:p + 24] += 1.5
    power = (x.real * x.real + x.imag * x.imag).contiguous()
    marks = (power > 0.5).to(torch.uint8)

    def run(d):
        blocks = [
            (burst.Gate(0.5, 32, retriggerable=retrig, device=d), (x, power)),
            (detect.RadarDetector(0.1, 10.0, device=d), (power,)),
            (burst.BurstBuffer(64, device=d),
             (x, marks, torch.roll(marks, 40))),
            (detect.PeakDetector(min_diff=0.5, lockout=64, device=d),
             (power,))]
        res = []
        for blk, ins in blocks:
            st, pr = blk.init_state(), blk.init_params()
            meta = StreamMeta.start(FS, abs_index=2 ** 32 - n, device=d)
            outs = []
            for b in range(3):
                s = [Stream.full(a[b * n:(b + 1) * n].to(d), meta=meta)
                     for a in ins]
                st, o = blk.apply(st, pr, *s)
                outs.append([(y.data.cpu(), int(y.count)) for y in o])
                meta = meta.advanced(n)
            res.append((outs, {k: v.cpu() for k, v in st.items()}))
        return res

    for (go, gs), (co, cs) in zip(run(dev), run("cpu")):
        for g, c in zip(go, co):
            for (gd, gc), (cd, cc) in zip(g, c):
                assert gc == cc
                if gd.dtype == torch.float32 and gd.dim() == 2 \
                        and gd.shape[1] == 4 and gd.shape[0] == 256:
                    assert torch.equal(gd[:, :3].view(torch.int32),
                                       cd[:, :3].view(torch.int32))
                    assert torch.allclose(gd[:, 3], cd[:, 3], rtol=1e-5,
                                          atol=0)
                elif gd.dtype == torch.float32:
                    assert torch.equal(gd.view(torch.int32),
                                       cd.view(torch.int32))
                else:
                    assert torch.equal(gd, cd)
        for k in cs:
            if k == "bsum":
                assert torch.allclose(gs[k], cs[k], rtol=1e-5)
            else:
                assert torch.equal(gs[k], cs[k]), k


# ---------------------------------------------------------------------------
# the FasTrak FSM (csrc/fastrak_fsm.cu)
# ---------------------------------------------------------------------------

# pass-1 tiles: the default, the smallest (shorter than a frame at
# oversampling 2 and 8), two between
FT_TILES = [8192, 128, 384, 1024]


def _ft_state(rows, dev):
    from grbaz_tpu_torch.ops.misc import FastrakDecoder
    return {k: v.reshape(1).expand(rows).contiguous().to(dev)
            for k, v in FastrakDecoder(device="cpu").init_state().items()}


@pytest.mark.parametrize("tile", FT_TILES)
@pytest.mark.parametrize("rows,n,os_,gap", [(1, 20000, 8, (1, 200)),
                                            (3, 4096, 2, (0, 3)),
                                            (64, 1 << 14, 8, (1, 200)),
                                            (2, 12345, 1, (0, 4))])
def test_fastrak_kernel_matches_plain(dev, rows, n, os_, gap, tile):
    """Events, counts and every state field bit for bit over two chained
    calls: rows of independent streams, frames across the calls and the
    tiles, more than 32 frames a call at oversampling 1, rows of a length
    no multiple of 4, whatever the tile."""
    import chip_smoke
    from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff
    gen = np.random.default_rng(rows * n + os_)
    metric, sync = chip_smoke.fastrak_rows(gen, rows, 2 * n, os_, gap)
    st_p, st_k = _ft_state(rows, "cpu"), _ft_state(rows, dev)
    thr = torch.tensor([1.0])
    total = 0
    for c in range(2):
        m = torch.from_numpy(np.ascontiguousarray(metric[:, c * n:(c + 1) * n]))
        y = torch.from_numpy(np.ascontiguousarray(sync[:, c * n:(c + 1) * n]))
        ep, cp, st_p = ff.fastrak_fsm(m, y, st_p, thr, os_)
        ek, ck, st_k = ff.fastrak_fsm(m.to(dev), y.to(dev), st_k,
                                      thr.to(dev), os_, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(ek.cpu().view(torch.int32), ep.view(torch.int32))
        assert torch.equal(ck.cpu(), cp)
        for k in st_p:
            assert torch.equal(st_k[k].cpu(), st_p[k]), k
        total += int(cp.sum())
    assert total > 0


@pytest.mark.parametrize("scene", ["held", "sparse"])
@pytest.mark.parametrize("tile", [128, 1024, 8192])
def test_fastrak_kernel_chain(dev, scene, tile):
    """With the sync held above the threshold (every sample a candidate,
    the longest chain) and on sparse frames: outputs bit for bit the plain
    version's over two chained calls, and the candidates and chain frames
    of each call those of the numpy model of the kernel's passes
    (tests/test_torch_fsm_speculation.py)."""
    import chip_smoke
    from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff
    from test_torch_fsm_speculation import chain_fastrak, ft_initial_state
    gen = np.random.default_rng(tile)
    rows, n = 2, 4096
    metric, sync = chip_smoke.fastrak_rows(gen, rows, 2 * n, 4)
    if scene == "held":
        sync = np.full_like(sync, 5.0)
    thr = np.ones(rows, np.float32)
    st_m, st_k, st_p = (ft_initial_state(rows), _ft_state(rows, dev),
                        _ft_state(rows, "cpu"))
    for c in range(2):
        m = np.ascontiguousarray(metric[:, c * n:(c + 1) * n])
        y = np.ascontiguousarray(sync[:, c * n:(c + 1) * n])
        *_, st_m, cand, frames = chain_fastrak(m, y, st_m, thr, 4, tile)
        ek, ck, st_k = ff.fastrak_fsm(torch.from_numpy(m).to(dev),
                                      torch.from_numpy(y).to(dev), st_k,
                                      torch.from_numpy(thr).to(dev), 4,
                                      tile=tile)
        got = (ff.fastrak_fsm.last_candidates.cpu().tolist(),
               ff.fastrak_fsm.last_frames.cpu().tolist())
        ep, cp, st_p = ff.fastrak_fsm(torch.from_numpy(m), torch.from_numpy(y),
                                      st_p, torch.from_numpy(thr), 4)
        assert torch.equal(ek.cpu().view(torch.int32), ep.view(torch.int32))
        assert torch.equal(ck.cpu(), cp)
        for k in st_p:
            assert torch.equal(st_k[k].cpu(), st_p[k]), k
        assert got == (cand.tolist(), frames.tolist())
        if scene == "held":
            assert got[0] == [n] * rows


def test_fastrak_wrapper_counts_launches_and_rejects_bad_input(dev):
    from grbaz_tpu_torch.ops.cuda import fastrak_fsm as ff
    st = _ft_state(1, dev)
    thr = torch.ones(1, device=dev)
    x = torch.zeros(1, 100, device=dev)
    before = ff.fastrak_fsm.launches
    ff.fastrak_fsm(x, x, st, thr, 8)
    assert ff.fastrak_fsm.launches == before + 1
    with pytest.raises(TypeError):
        ff.fastrak_fsm(x.double(), x, st, thr, 8)
    with pytest.raises(ValueError):
        ff.fastrak_fsm_kernel(x, x[:, :50].contiguous(), st, thr, 8)
    with pytest.raises(ValueError):
        ff.fastrak_fsm_kernel(x, x, st, thr.cpu(), 8)
    with pytest.raises(ValueError):
        ff.fastrak_fsm_kernel(x, x, st, thr, 0)
    with pytest.raises(ValueError):
        ff.fastrak_fsm_kernel(x, x, st, thr, 8, tile=1000)
    assert ff.fastrak_fsm.launches == before + 1


# ---------------------------------------------------------------------------
# the ratio-stream resampler's walk (csrc/vrr_walk.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("n,ratio,per_input", [(1 << 16, 64 / 48, 2.0),
                                               (5000, 0.7, 2.0),
                                               (3000, 0.4, 1.5),
                                               (40000, 3.1, 2.0),
                                               (40000, 5000.0, 2.0)])
def test_vrr_walk_kernel_matches_plain(dev, dtype, n, ratio, per_input):
    """Counts, positions, overrun flags and tails equal and outputs within
    1e-5 of the max over three chained blocks, the last partial; ratios
    above and below 1 (an output buffer filling inside a tile), steps
    longer than the kernel's tile, and too small a budget (overrun)."""
    from grbaz_tpu_torch.ops.cuda import vrr_walk as vw
    from grbaz_tpu_torch.ops.resampler import VariableRatioResampler
    gen = np.random.default_rng(n)
    x = gen.standard_normal((3 * n, 2)).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(
        x[:, 0] if dtype == torch.float32 else x[:, 0] + 1j * x[:, 1])
    ).to(dtype)
    rr = torch.from_numpy((ratio * (1 + 0.05 * np.sin(
        np.arange(3 * n) * 0.003))).astype(np.float32))
    blk = VariableRatioResampler(n, per_input, dtype=dtype, device="cpu")
    st_p = blk.init_state()
    st_k = {k: v.to(dev) for k, v in st_p.items()}
    taps = blk.taps_table
    for b in range(3):
        xs, rs = x[b * n:(b + 1) * n], rr[b * n:(b + 1) * n]
        c = torch.tensor(n if b < 2 else n - 333, dtype=torch.int32)
        ref = vw.vrr_walk(xs, st_p["tail"], rs, st_p["rr_tail"],
                          st_p["q_int"], st_p["mu_frac"], c, blk.capacity,
                          taps)
        got = vw.vrr_walk(xs.to(dev), st_k["tail"], rs.to(dev),
                          st_k["rr_tail"], st_k["q_int"], st_k["mu_frac"],
                          c.to(dev), blk.capacity, taps.to(dev))
        torch.cuda.synchronize()
        for i in (1, 2, 3, 4, 5, 6):
            assert torch.equal(got[i].cpu(), ref[i]), i
        assert float((got[0].cpu() - ref[0]).abs().max()) <= \
            1e-5 * float(ref[0].abs().max())
        st_p = dict(tail=ref[5], rr_tail=ref[6], q_int=ref[2],
                    mu_frac=ref[3])
        st_k = dict(tail=got[5], rr_tail=got[6], q_int=got[2],
                    mu_frac=got[3])


def test_vrr_walk_wrapper_counts_launches_and_rejects_bad_input(dev):
    from grbaz_tpu_torch.ops.cuda import vrr_walk as vw
    from grbaz_tpu_torch.ops.resampler import VariableRatioResampler
    blk = VariableRatioResampler(1024, dtype=torch.float32, device=dev)
    st = blk.init_state()
    x = torch.zeros(1024, device=dev)
    c = torch.tensor(1024, dtype=torch.int32, device=dev)
    args = (st["tail"], x, st["rr_tail"], st["q_int"], st["mu_frac"], c,
            blk.capacity, blk.taps_table)
    before = vw.vrr_walk.launches
    vw.vrr_walk(x, *args)
    assert vw.vrr_walk.launches == before + 1
    with pytest.raises(TypeError):
        vw.vrr_walk(x.double(), *args)
    with pytest.raises(ValueError):
        vw.vrr_walk_kernel(x, st["tail"], x, st["rr_tail"], st["q_int"],
                           st["mu_frac"], c.cpu(), blk.capacity,
                           blk.taps_table)
    with pytest.raises(ValueError):
        vw.vrr_walk_kernel(x[:4], *args)
    assert vw.vrr_walk.launches == before + 1
    assert 0.1 < vw.chain_step_ns(1 << 16) < 1000.0


# ---------------------------------------------------------------------------
# the WBFM audio tail (csrc/audio_tail.cu): the fractional resampler's step
# and the FM deemphasis, one launch each
# ---------------------------------------------------------------------------

def _tail_block(gen, n, dtype):
    x = gen.standard_normal((n, 2)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        x[:, 0] if dtype == torch.float32 else x[:, 0] + 1j * x[:, 1]))


def _rs_params(ratio, dev):
    p = FractionalResampler.ratio_params(ratio)
    return dict(inc_int=torch.tensor(int(p["inc_int"]), dtype=torch.int32,
                                      device=dev),
                inc_frac=torch.tensor(int(p["inc_frac"]), device=dev))


def _resample_against_plain(dev, dtype, n, ratio, counts, retunes=(),
                            start=None):
    """Chained blocks through the kernel and the plain step: counts,
    positions and tails equal, samples within 1e-6 of the largest."""
    gen = np.random.default_rng(n + len(counts))
    blk = FractionalResampler(n, ratio, dtype=dtype, device="cpu")
    st_p = blk.init_state()
    if start is not None:
        st_p["mu_int"] = torch.tensor(start[0], dtype=torch.int32)
        st_p["mu_frac"] = torch.tensor(start[1], dtype=torch.int64)
    st_k = {k: v.to(dev) for k, v in st_p.items()}
    taps = blk.taps_table
    pr = _rs_params(ratio, "cpu")
    for b, c in enumerate(counts):
        if b in dict(retunes):
            pr = _rs_params(dict(retunes)[b], "cpu")
        x = _tail_block(gen, n, dtype)
        cnt = torch.tensor(c, dtype=torch.int32)
        ref = at.fractional_resample(
            x, st_p["tail"], cnt, st_p["mu_int"], st_p["mu_frac"],
            pr["inc_int"], pr["inc_frac"], blk.capacity, taps)
        got = at.fractional_resample(
            x.to(dev), st_k["tail"], cnt.to(dev), st_k["mu_int"],
            st_k["mu_frac"], pr["inc_int"].to(dev), pr["inc_frac"].to(dev),
            blk.capacity, taps.to(dev))
        for i, what in ((1, "count"), (2, "mu_int"), (3, "mu_frac"),
                        (4, "tail")):
            assert got[i].dtype == ref[i].dtype, what
            assert torch.equal(got[i].cpu(), ref[i]), (b, what)
        scale = float(ref[0].abs().max())
        assert float((got[0].cpu() - ref[0]).abs().max()) <= 1e-6 * scale, b
        assert not bool(got[0][int(ref[1]):].cpu().abs().any()), b
        st_p = dict(tail=ref[4], mu_int=ref[2], mu_frac=ref[3])
        st_k = dict(tail=got[4], mu_int=got[2], mu_frac=got[3])


@pytest.mark.parametrize("n", [16384, 131072])
@pytest.mark.parametrize("ratio", [25 / 24, 8.333333333333334, 1.7, 0.8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_fractional_resample_kernel_matches_plain(dev, dtype, ratio, n):
    """8 chained blocks: full, partial and zero-count blocks, a ppb-scale
    retune and one down to the block's min_ratio (its capacity filled
    after the zero-count block's backlog)."""
    min_ratio = FractionalResampler(n, ratio, device="cpu").min_ratio
    _resample_against_plain(dev, dtype, n, ratio,
                            [n, n, n - 333, 0, n, n, n, n],
                            retunes=((4, ratio * (1 + 3e-7)),
                                     (6, min_ratio)))


@pytest.mark.parametrize("start", [(-2, 0), (0, 2 ** 32 - 1),
                                   (7, 2 ** 32 - 1), (16383, 123456),
                                   (16384, 0), (16389, 2 ** 31)])
def test_fractional_resample_kernel_from_the_edges_of_mu(dev, start):
    """Start positions before the frame, at the last window that fits,
    and past the block (no output), with mu_frac at its edges."""
    _resample_against_plain(dev, torch.float32, 16384, 25 / 24,
                            [16384, 16383, 16384], start=start)


@pytest.mark.parametrize("n", [16384, 17478, 131072, 5])
def test_fm_deemphasis_kernel_matches_plain(dev, n):
    """8 chained blocks with partial, zero-count and over-full counts:
    samples and y_prev within 1e-6 of the stream's largest sample, x_prev
    equal; a zero-count block holds both states exactly."""
    gen = np.random.default_rng(n)
    blk = FMDeemphasis(48e3, device="cpu")
    st_p = blk.init_state()
    st_k = {k: v.to(dev) for k, v in st_p.items()}
    scale = 0.0   # the largest sample of the stream so far
    for b, c in enumerate([n, n - 3, 0, n, 1, 0, n + 7, n]):
        x = _tail_block(gen, n, torch.float32)
        cnt = torch.tensor(c, dtype=torch.int32)
        ref = at.fm_deemphasis(x, cnt, st_p["y_prev"], st_p["x_prev"],
                               *blk.b, blk.a)
        got = at.fm_deemphasis(x.to(dev), cnt.to(dev), st_k["y_prev"],
                               st_k["x_prev"], *blk.b, blk.a)
        scale = max(scale, float(ref[0].abs().max()))
        assert float((got[0].cpu() - ref[0]).abs().max()) <= 1e-6 * scale, b
        assert abs(float(got[1]) - float(ref[1])) <= 1e-6 * scale, b
        assert torch.equal(got[2].cpu(), ref[2]), b
        if c == 0:
            assert torch.equal(got[1], st_k["y_prev"])
            assert torch.equal(got[2], st_k["x_prev"])
            assert bool((got[0] == st_k["y_prev"]).all())
        st_p = dict(y_prev=ref[1], x_prev=ref[2])
        st_k = dict(y_prev=got[1], x_prev=got[2])


def test_audio_tail_wrappers_count_launches_and_reject_bad_input(dev):
    n = 1024
    rs = FractionalResampler(n, 25 / 24, dtype=torch.float32, device=dev)
    st, pr = rs.init_state(), rs.init_params()
    x = torch.zeros(n, device=dev)
    c = torch.tensor(n, dtype=torch.int32, device=dev)
    args = (st["tail"], c, st["mu_int"], st["mu_frac"], pr["inc_int"],
            pr["inc_frac"], rs.capacity, rs.taps_table)
    before = at.fractional_resample.launches
    at.fractional_resample(x, *args)
    assert at.fractional_resample.launches == before + 1
    with pytest.raises(TypeError):
        at.fractional_resample(x.double(), *args)
    with pytest.raises(ValueError):   # the count on the CPU
        at.fractional_resample(x, st["tail"], c.cpu(), *args[2:])
    with pytest.raises(ValueError):   # inc_frac as int32
        at.fractional_resample(x, *args[:5], pr["inc_frac"].int(), *args[6:])
    with pytest.raises(ValueError):   # a tail of another type
        at.fractional_resample(x, st["tail"].double(), *args[1:])
    with pytest.raises(ValueError):
        at.fractional_resample(x, *args[:6], 0, rs.taps_table)
    assert at.fractional_resample.launches == before + 1
    de = FMDeemphasis(48e3, device=dev)
    ds = de.init_state()
    before = at.fm_deemphasis.launches
    at.fm_deemphasis(x, c, ds["y_prev"], ds["x_prev"], *de.b, de.a)
    assert at.fm_deemphasis.launches == before + 1
    with pytest.raises(TypeError):
        at.fm_deemphasis(x.to(torch.complex64), c, ds["y_prev"],
                         ds["x_prev"], *de.b, de.a)
    with pytest.raises(ValueError):
        at.fm_deemphasis(x, c, ds["y_prev"].reshape(1), ds["x_prev"],
                         *de.b, de.a)
    with pytest.raises(ValueError):
        at.fm_deemphasis(x[:0], c, ds["y_prev"], ds["x_prev"], *de.b, de.a)
    assert at.fm_deemphasis.launches == before + 1


@pytest.mark.parametrize("chain", ["cascade", "fractional"])
def test_wbfm_audio_tail_kernel_arm_equals_plain_arm(dev, chain):
    """The WBFM chain with its audio tail on the kernels ('auto') and on
    the plain arm, over 6 blocks with a partial and a zero-count block:
    counts and the resampler's state equal, audio within 1e-5 of the
    largest; each kernel launches once a step."""
    n = 1 << 20   # the audio tail at 16384 (cascade) or 131072 inputs
    gen = np.random.default_rng(21)
    blocks = [_cn(gen, n, dev) for _ in range(6)]
    counts = [n, n, n - 40000, 0, n, n]
    runs = {}
    for backend in ("auto", "plain"):
        cfg = wbfm.WBFMConfig(block_size=n, audio_chain=chain,
                              center_freq=250e3)
        fg, _ = wbfm.build_wbfm(cfg, device=dev)
        # both arms run the channel and anti-alias kernels: only the
        # audio tail's backend differs
        for blk in fg.blocks:
            if blk.name in ("resampler", "deemph"):
                blk.backend = backend
        step = fg.compile().step
        states, params = fg.init_states(), fg.init_params()
        launches = (at.fractional_resample.launches,
                    at.fm_deemphasis.launches)
        outs = []
        for x, c in zip(blocks, counts):
            s = Stream.full(x)
            s.count = torch.tensor(c, dtype=torch.int32, device=dev)
            states, out = step(states, params, {"iq": s})
            outs.append(out["audio"])
        done = (at.fractional_resample.launches - launches[0],
                at.fm_deemphasis.launches - launches[1])
        assert done == ((6, 6) if backend == "auto" else (0, 0)), backend
        runs[backend] = (outs, states)
    (ka, ks), (pa, ps) = runs["auto"], runs["plain"]
    for got, ref in zip(ka, pa):
        c = int(ref.count)
        assert int(got.count) == c
        if c:
            assert _err(got.data[:c], ref.data[:c]) < 1e-5
    for k in ("tail", "mu_int", "mu_frac"):
        assert torch.equal(ks["resampler"][k], ps["resampler"][k]), k
    scale = max(float(o.data.abs().max()) for o in pa)
    for k in ("y_prev", "x_prev"):
        assert abs(float(ks["deemph"][k]) - float(ps["deemph"][k])) \
            < 1e-5 * scale, k


# ---------------------------------------------------------------------------
# the decoders' kernels (csrc/viterbi.cu, acars_fsm.cu, manchester_fsm.cu,
# dpll_walk.cu)
# ---------------------------------------------------------------------------

# polynomials with bit K - 1 set; K = 2 to 9 on the warp form, 10 and up
# on the block form
VITERBI_CODES = {2: (0o3, 0o2), 3: (0o7, 0o5), 4: (0o17, 0o13),
                 5: (0o23, 0o35), 6: (0o53, 0o75), 7: (0o171, 0o133),
                 8: (0o247, 0o371), 9: (0o561, 0o753), 10: (0o1167, 0o1545),
                 11: (0o2335, 0o3661), 12: (0o4335, 0o5723)}


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("k", sorted(VITERBI_CODES))
@pytest.mark.parametrize("t_len,noise", [(1, 0.0), (1000, 0.0),
                                         (5000, 0.8), (3000, "ties"),
                                         (1024, 0.8)])
def test_viterbi_kernel_matches_plain(dev, k, t_len, noise):
    _viterbi_against_plain(dev, k, VITERBI_CODES[k], t_len, noise)


@pytest.mark.parametrize("t_len,noise", [(1, 0.0), (300, "ties"),
                                         (700, 0.8)])
def test_viterbi_kernel_matches_plain_at_k15(dev, t_len, noise):
    # 2^14 states: the block form's metrics fill 128 KB of shared memory
    _viterbi_against_plain(dev, 15, (0o46321, 0o51271), t_len, noise)


def _viterbi_against_plain(dev, k, polys, t_len, noise):
    from grbaz_tpu_torch.ops import fec
    from grbaz_tpu_torch.ops.cuda import viterbi as vt
    gen = np.random.default_rng(k * 100 + t_len)
    bits = gen.integers(0, 2, t_len).astype(np.uint8)
    soft = fec.conv_encode(bits, k, polys).astype(np.float32) * 2 - 1
    if noise == "ties":     # erasures and +-1: equal candidates
        soft = soft * gen.integers(0, 2, soft.shape)
    else:
        soft = soft + noise * gen.standard_normal(soft.shape)
    soft = torch.from_numpy(soft.astype(np.float32))
    exp = torch.from_numpy(fec.expected_outputs(k, polys))
    bk, pk = vt.viterbi(soft.to(dev), exp.to(dev))
    bp, pp = fec.viterbi_plain(soft, exp)
    torch.cuda.synchronize()
    assert _same(bk, bp) and _same(pk, pp)


def test_viterbi_decoder_block_entry_equals_the_cpu(dev):
    from grbaz_tpu_torch.ops.fec import ViterbiDecoder
    import chip_smoke
    gen = np.random.default_rng(3)
    _, soft = chip_smoke.soft_pairs(gen, 3 * 2000)
    outs = []
    for d in (dev, "cpu"):
        blk = ViterbiDecoder(overlap=96, device=d)
        st, out = blk.init_state(), []
        for b in range(3):
            st, (o,) = blk.apply(st, None, Stream.full(torch.from_numpy(
                soft[b * 2000:(b + 1) * 2000]).to(d)))
            out.append((o.data, st["tail"], st["warm"]))
        outs.append(out)
    for g, c in zip(*outs):
        assert all(_same(a, b) for a, b in zip(g, c))


@pytest.mark.parametrize("k", [2, 10])
def test_fec_entry_points_run_on_the_card_at_k2_and_k10(dev, k):
    from grbaz_tpu_torch.models.auto_fec import AutoFEC
    from grbaz_tpu_torch.ops import fec
    import chip_smoke
    polys = VITERBI_CODES[k]
    soft = chip_smoke.coded_pairs(np.random.default_rng(k), 3 * 1500, k,
                                  polys, noise=0.5)
    assert _same(fec.viterbi_decode(torch.from_numpy(soft).to(dev), k, polys),
                 fec.viterbi_decode(torch.from_numpy(soft), k, polys))
    outs = []
    for d in (dev, "cpu"):
        blk = fec.ViterbiDecoder(k, polys, overlap=40, device=d)
        st, out = blk.init_state(), []
        for b in range(3):
            st, (o,) = blk.apply(st, None, Stream.full(torch.from_numpy(
                soft[b * 1500:(b + 1) * 1500]).to(d)))
            out.append((o.data, st["tail"]))
        outs.append(out)
    for g, c in zip(*outs):
        assert all(_same(a, b) for a, b in zip(g, c))
    sym = torch.complex(torch.from_numpy(soft[:, 0]),
                        torch.from_numpy(soft[:, 1]))
    fed = []
    for d in (dev, "cpu"):
        afec = AutoFEC(k=k, polys=polys, device=d)
        fed.append([afec.feed(sym[b * 1500:(b + 1) * 1500])
                    for b in range(3)])
    for g, c in zip(*fed):
        assert _same(g[0], c[0]) and g[1:] == c[1:]


def test_auto_fec_kernels_equal_their_plain_twins(dev):
    """The served auto-FEC Block's three kernels against their plain twins
    at the cell's shape: the pairs under every state's transform, the BER
    of random bits and pairs, and the search over BERs at and beside its
    levels; one launch a call each."""
    from grbaz_tpu_torch.models.auto_fec import AutoFECBlock, reencode
    from grbaz_tpu_torch.ops import fec
    from grbaz_tpu_torch.ops.cuda import auto_fec as af
    gen = torch.Generator().manual_seed(7)
    n, ov = 1 << 16, 96
    blk = AutoFECBlock(device="cpu")
    carry = torch.view_as_complex(torch.randn(ov + 1, 2, generator=gen))
    block = torch.view_as_complex(torch.randn(n, 2, generator=gen))
    before = af.fec_pairs.launches
    for s in range(blk.search.n_states):
        state = torch.tensor([s], dtype=torch.int32)
        got = af.fec_pairs(carry.to(dev), block.to(dev), state.to(dev),
                           blk._pick.to(dev), blk._sign.to(dev))
        assert _same(got, fec.fec_pairs_plain(carry, block, state, blk._pick,
                                              blk._sign)), s
    assert af.fec_pairs.launches == before + blk.search.n_states
    bits = torch.randint(0, 2, (ov + n,), generator=gen, dtype=torch.uint8)
    code = reencode(bits, 7, (0o171, 0o133)).to(torch.float32) * 2 - 1
    for noise in (0.4, 10.0):  # BERs near 0.006 and near 0.5
        ext = code + noise * torch.randn(ov + n, 2, generator=gen)
        assert _same(af.fec_ber(bits.to(dev), ext.to(dev), ov, 7,
                                (0o171, 0o133)),
                     fec.fec_ber_plain(bits, ext, ov, 7, (0o171, 0o133)))
    f32 = np.float32
    levels = [0.0, 0.01, 0.049, float(f32(0.05)), 0.3, float(np.nextafter(
        f32(0.4), f32(0))), float(f32(0.4)), 0.9, float("nan")]
    for s in range(blk.search.n_states):
        for b in levels:
            state = torch.tensor([s], dtype=torch.int32)
            ber = torch.tensor([b], dtype=torch.float32)
            got = af.fec_search(blk.search.table.to(dev), state.to(dev),
                                ber.to(dev), 0.05, 0.4)
            assert _same(got, fec.fec_search_plain(
                blk.search.table, state, ber, 0.05, 0.4)), (s, b)


def test_autofec_block_on_the_card_equals_the_cpu(dev):
    """The served auto-FEC Block, its search state on the card, block by
    block equal to its plain path on the CPU through the search and the
    lock: path metrics, bits, BER and state."""
    from grbaz_tpu_torch.models.auto_fec import AutoFECBlock
    from radiobench import manifest
    from radiobench.configs import lrpt
    cfg = manifest.config("lrpt")
    n = 1 << 12
    _, sym, _ = lrpt.passes(cfg, 1, 4 * n, 2 ** 31 + 41, dev, states=[9])
    outs = []
    for d in (dev, "cpu"):
        blk = AutoFECBlock(device=d)
        st, out = blk.init_state(), []
        for b in range(14):
            st, o = blk.apply(st, None, Stream.full(
                sym[0, (b % 4) * n:(b % 4 + 1) * n].to(d)))
            out.append([t.data for t in o] + [st["carry"]])
        outs.append(out)
    for g, c in zip(*outs):
        assert all(_same(a, b) for a, b in zip(g, c))
    assert outs[1][-1][3].item() >> 5 & 1  # locked by the last block


def _serial_cases():
    """(name, wrapper module, plain, make rows(gen, rows, n), call(fn, x,
    st, counts), initial state(rows, dev))."""
    import chip_smoke
    from grbaz_tpu_torch.ops import decode
    from grbaz_tpu_torch.ops.cuda import acars_fsm, dpll_walk, manchester_fsm

    def acars_rows(gen, rows, n):
        return chip_smoke.acars_rows(gen, rows, n, gap=(5, 40))[0]

    def chips(gen, rows, n):
        return chip_smoke.manchester_rows(gen, rows, n)[0]

    def pulses(gen, rows, n):
        return chip_smoke.pulse_rows(gen, rows, n, period=(3.0, 120.0))

    def state(block):
        return lambda rows, d: chip_smoke.rows_state(block(d), rows, d)
    return [
        ("acars", acars_fsm.acars_fsm, decode.acars_plain, acars_rows,
         lambda fn, x, st, c: fn(x, st, 2),
         state(lambda d: decode.ACARSDecoder(device=d))),
        ("manchester", manchester_fsm.manchester_fsm,
         decode.manchester_plain, chips,
         lambda fn, x, st, c: fn(x, c, st, False, 16, 8),
         state(lambda d: decode.ManchesterDecode(device=d))),
        ("manchester original", manchester_fsm.manchester_fsm,
         decode.manchester_plain, chips,
         lambda fn, x, st, c: fn(x, c, st, True, 9, 3),
         state(lambda d: decode.ManchesterDecode(device=d))),
        ("dpll", dpll_walk.dpll_walk, decode.dpll_plain, pulses,
         lambda fn, x, st, c: fn(x, st, 0.05, 0.05, 0.5),
         state(lambda d: decode.DPLLBitSync(16.0, device=d))),
        ("dpll gain 0.3", dpll_walk.dpll_walk, decode.dpll_plain, pulses,
         lambda fn, x, st, c: fn(x, st, 0.3, 0.4, 0.3),
         state(lambda d: decode.DPLLBitSync(40.0, device=d))),
        ("acars noise", acars_fsm.acars_fsm, decode.acars_plain,
         chip_smoke.acars_noise_rows, lambda fn, x, st, c: fn(x, st, 8),
         state(lambda d: decode.ACARSDecoder(device=d))),
        ("manchester random chips", manchester_fsm.manchester_fsm,
         decode.manchester_plain, chip_smoke.manchester_noise,
         lambda fn, x, st, c: fn(x, c, st, False, 1, 0),
         state(lambda d: decode.ManchesterDecode(device=d))),
    ]


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("rows,n", [(1, 5000), (33, 3001), (64, 1 << 14)])
def test_serial_decoder_kernels_match_plain(dev, case, rows, n):
    name, wrapper, plain, make, call, state = _serial_cases()[case]
    gen = np.random.default_rng(rows * 7 + case)
    x = make(gen, rows, 2 * n)
    counts = torch.full((rows,), n, dtype=torch.int32)
    counts[::3] = n - 1001 if n > 1001 else 1
    sk, sp = state(rows, dev), state(rows, "cpu")
    for c in range(2):   # chained, the second call's counts partial
        part = torch.from_numpy(np.ascontiguousarray(x[:, c * n:(c + 1) * n]))
        cnt = counts if c else torch.full_like(counts, n)
        gk = call(wrapper, part.to(dev), sk, cnt.to(dev))
        gp = call(plain, part, sp, cnt)
        torch.cuda.synchronize()
        assert all(_same(a, b) for a, b in zip(gk[:-1], gp[:-1])), (name, c)
        sk, sp = gk[-1], gp[-1]
        assert all(_same(sk[key], sp[key]) for key in sp), (name, c)


def test_decoder_wrappers_count_launches_and_reject_bad_input(dev):
    from grbaz_tpu_torch.ops import decode, fec
    from grbaz_tpu_torch.ops.cuda import (acars_fsm, dpll_walk,
                                          manchester_fsm, viterbi)
    import chip_smoke
    exp = torch.from_numpy(fec.expected_outputs(7, (0o171, 0o133))).to(dev)
    m = torch.ones(40, 2, device=dev)
    before = viterbi.viterbi.launches
    viterbi.viterbi(m, exp)
    assert viterbi.viterbi.launches == before + 1
    with pytest.raises(TypeError):
        viterbi.viterbi_kernel(m.double(), exp)
    # K = 10 decodes (the block form) and equals the plain version; a
    # trellis whose state count is not a power of two is refused
    exp10 = torch.from_numpy(fec.expected_outputs(10, VITERBI_CODES[10]))
    bk, pk = viterbi.viterbi_kernel(m, exp10.to(dev))
    bp, pp = fec.viterbi_plain(m.cpu(), exp10)
    assert _same(bk, bp) and _same(pk, pp)
    with pytest.raises(ValueError, match="2\\^\\(K-1\\) states"):
        viterbi.viterbi_kernel(m, torch.ones(384, 2, 2, device=dev))
    with pytest.raises(ValueError):
        viterbi.viterbi_kernel(m, exp.cpu())
    assert viterbi.viterbi.launches == before + 2
    x = torch.ones(2, 100, device=dev)
    st = chip_smoke.rows_state(decode.ACARSDecoder(device=dev), 2, dev)
    before = acars_fsm.acars_fsm.launches
    acars_fsm.acars_fsm(x, st, 2)
    assert acars_fsm.acars_fsm.launches == before + 1
    with pytest.raises(TypeError):
        acars_fsm.acars_fsm_kernel(x.double(), st, 2)
    with pytest.raises(ValueError):
        acars_fsm.acars_fsm_kernel(x, dict(st, pkt=st["pkt"][:1]), 2)
    b = torch.ones(2, 100, dtype=torch.uint8, device=dev)
    cnt = torch.full((2,), 100, dtype=torch.int32, device=dev)
    st = chip_smoke.rows_state(decode.ManchesterDecode(device=dev), 2, dev)
    before = manchester_fsm.manchester_fsm.launches
    manchester_fsm.manchester_fsm(b, cnt, st, False, 16, 8)
    assert manchester_fsm.manchester_fsm.launches == before + 1
    with pytest.raises(ValueError):
        manchester_fsm.manchester_fsm_kernel(b, cnt, st, False, 40, 8)
    with pytest.raises(TypeError):
        manchester_fsm.manchester_fsm_kernel(x, cnt, st, False, 16, 8)
    st = chip_smoke.rows_state(decode.DPLLBitSync(16.0, device=dev), 2, dev)
    before = dpll_walk.dpll_walk.launches
    dpll_walk.dpll_walk(b, st, 0.05, 0.05, 0.5)
    assert dpll_walk.dpll_walk.launches == before + 1
    with pytest.raises(ValueError):
        dpll_walk.dpll_walk_kernel(b, {k: v.cpu() for k, v in st.items()},
                                   0.05, 0.05, 0.5)
    assert dpll_walk.dpll_walk.launches == before + 1


@pytest.mark.parametrize("gain,rel,ign", [(0.05, 0.05, 0.5), (0.3, 0.4, 0.3),
                                          (0.1, 0.05, 0.5)])
@pytest.mark.parametrize("n", [3000, 1 << 14])
def test_dpll_kernel_on_edge_rows(dev, gain, rel, ign, n):
    # no pulse, a pulse at each call's sample 0, past 512 events a call,
    # pulses at the walk's tile edges; with and without the fused product
    from grbaz_tpu_torch.ops import decode
    from grbaz_tpu_torch.ops.cuda import dpll_walk
    import chip_smoke
    x = chip_smoke.dpll_edge_rows(np.random.default_rng(n), n)
    rows = len(x)
    sk = chip_smoke.rows_state(decode.DPLLBitSync(16.0, device=dev), rows, dev)
    sk["period"] = torch.tensor([16.0, 47.0, 3.0, 100.0, 16.0, 40.0],
                                device=dev)
    sp = {k: v.cpu() for k, v in sk.items()}
    for c in range(2):
        part = torch.from_numpy(np.ascontiguousarray(x[:, c * n:(c + 1) * n]))
        gk = dpll_walk.dpll_walk(part.to(dev), sk, gain, rel, ign)
        gp = decode.dpll_plain(part, sp, gain, rel, ign)
        torch.cuda.synchronize()
        assert all(_same(a, b) for a, b in zip(gk[:-1], gp[:-1])), c
        sk, sp = gk[-1], gp[-1]
        assert all(_same(sk[key], sp[key]) for key in sp), c
