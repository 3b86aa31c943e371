"""The port's CUDA kernels == their plain PyTorch twins, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor ``grbaz_tpu`` (the machine with the
card has no JAX), so run it there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops import fir
from grbaz_tpu_torch.ops.cuda import fir_decimate as fd
from grbaz_tpu_torch.ops.cuda import xlating_fir as xf

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
    blocks (outputs; the arms carry different tails)."""
    taps = fir.low_pass_taps(1.0, FS, 112.5e3, 75e3)
    gen = np.random.default_rng(7)
    blocks = [_cn(gen, n, dev) for _ in range(3)]
    outs = {}
    for backend in ("kernel", "plain"):
        blk = fir.FreqXlatingFIRDecimator(taps, 8, 250e3, FS,
                                          backend=backend, device=dev)
        st, pr, ys = blk.init_state(), blk.init_params(), []
        for x in blocks:
            st, (y,) = blk.apply(st, pr, Stream.full(x))
            ys.append(y.data)
        outs[backend] = torch.cat(ys)
    assert _err(outs["kernel"], outs["plain"]) < 1e-5
