"""The audio tail's backends on the CPU: ``FractionalResampler`` and
``FMDeemphasis`` take their plain arm under 'auto', refuse 'kernel' without
a card, and the kernel wrappers (``ops/cuda/audio_tail.py``) refuse bad
input before any launch and run their plain twins on CPU tensors. The
kernels themselves are held to the plain twins on the card
(``tests/test_torch_cuda_kernels.py``) and through the CPU shim
(``tools/cpu_shim/audio_tail_check.py``)."""

import numpy as np
import pytest
import torch

from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.models import wbfm
from grbaz_tpu_torch.ops import demod, resampler
from grbaz_tpu_torch.ops.cuda import audio_tail as at

CPU = "cpu"


def _blocks(n, dtype, counts, seed=0):
    gen = np.random.default_rng(seed)
    for c in counts:
        x = gen.standard_normal((n, 2)).astype(np.float32)
        x = x[:, 0] if dtype == torch.float32 else x[:, 0] + 1j * x[:, 1]
        s = Stream.full(torch.from_numpy(np.ascontiguousarray(x)))
        s.count = torch.tensor(c, dtype=torch.int32)
        yield s


def _resampler(dtype, backend):
    return resampler.FractionalResampler(2048, 25 / 24, dtype=dtype,
                                         backend=backend, device=CPU)


def _deemph(dtype, backend):
    return demod.FMDeemphasis(48e3, backend=backend, device=CPU)


BLOCKS = {"resampler": (_resampler, (torch.float32, torch.complex64)),
          "deemph": (_deemph, (torch.float32,))}
CASES = [(name, dtype) for name, (_, dtypes) in BLOCKS.items()
         for dtype in dtypes]


@pytest.mark.parametrize("name,dtype", CASES)
def test_auto_takes_the_plain_arm_on_the_cpu(name, dtype):
    """'auto' and 'plain' give the same outputs, counts and states bit for
    bit over chained blocks with a partial and a zero-count block, and no
    kernel launch is counted."""
    make = BLOCKS[name][0]
    before = (at.fractional_resample.launches, at.fm_deemphasis.launches)
    runs = {}
    for backend in ("auto", "plain"):
        blk = make(dtype, backend)
        st, pr, outs = blk.init_state(), blk.init_params(), []
        for x in _blocks(2048, dtype, [2048, 1500, 0, 2048]):
            st, (y,) = blk.apply(st, pr, x)
            outs.append((y.data, y.count))
        runs[backend] = (outs, st)
    (oa, sa), (op, sp) = runs["auto"], runs["plain"]
    for (ya, ca), (yp, cp) in zip(oa, op):
        assert torch.equal(ya, yp) and torch.equal(ca, cp)
    assert sa.keys() == sp.keys()
    for k in sa:
        assert torch.equal(sa[k], sp[k]), k
    assert (at.fractional_resample.launches,
            at.fm_deemphasis.launches) == before


@pytest.mark.parametrize("name,dtype", CASES)
def test_kernel_backend_raises_without_a_card(name, dtype):
    blk = BLOCKS[name][0](dtype, "kernel")
    x = next(_blocks(2048, dtype, [2048]))
    with pytest.raises(ValueError, match="CUDA"):
        blk.apply(blk.init_state(), blk.init_params(), x)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_unknown_backend_is_refused(name):
    with pytest.raises(ValueError, match="backend"):
        BLOCKS[name][0](torch.float32, "triton")


@pytest.mark.parametrize("chain", ["cascade", "fractional", "fused"])
@pytest.mark.parametrize("backend", ["auto", "plain", "kernel"])
def test_wbfm_chain_backend_sets_the_audio_tail(chain, backend):
    """The chain's backend (``chan_backend``, or ``fused_backend`` in the
    fused chain) sets the resampler's and the deemphasis'; 'kernel' gives
    them 'auto', so that the chain still runs on the CPU."""
    key = "fused_backend" if chain == "fused" else "chan_backend"
    cfg = wbfm.WBFMConfig(block_size=1 << 14, audio_chain=chain,
                          fused=chain == "fused", **{key: backend})
    fg, handles = wbfm.build_wbfm(cfg, device=CPU)
    deemph = [b for b in fg.blocks if b.name == "deemph"]
    want = "plain" if backend == "plain" else "auto"
    assert handles["resampler"].backend == want
    assert len(deemph) == 1 and deemph[0].backend == want


def _resample_args(dtype=torch.float32, n=1024):
    blk = resampler.FractionalResampler(n, 25 / 24, dtype=dtype, device=CPU)
    st, pr = blk.init_state(), blk.init_params()
    x = next(_blocks(n, dtype, [n - 100])).data
    return blk, (x, st["tail"], torch.tensor(n - 100, dtype=torch.int32),
                 st["mu_int"], st["mu_frac"], pr["inc_int"], pr["inc_frac"],
                 blk.capacity, blk.taps_table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_wrappers_run_their_plain_twins_on_the_cpu(dtype):
    blk, args = _resample_args(dtype)
    got = at.fractional_resample(*args)
    ref = resampler.resample_step_plain(*args)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    _, (y,) = blk.apply(blk.init_state(), blk.init_params(),
                        Stream(args[0], args[2],
                               Stream.full(args[0]).meta))
    assert torch.equal(y.data, ref[0]) and torch.equal(y.count, ref[1])
    d = demod.FMDeemphasis(48e3, device=CPU)
    st = d.init_state()
    x = args[0].real.contiguous() if dtype == torch.complex64 else args[0]
    got = at.fm_deemphasis(x, args[2], st["y_prev"], st["x_prev"], *d.b,
                           d.a)
    ref = demod.deemphasis_plain(x, args[2], st["y_prev"], st["x_prev"],
                                 *d.b, d.a)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_kernel_wrappers_refuse_bad_input_before_a_launch():
    """Checked before the library is loaded: a block on the CPU, and a
    block of a type the kernel does not take."""
    before = (at.fractional_resample.launches, at.fm_deemphasis.launches)
    _, args = _resample_args()
    with pytest.raises(ValueError, match="CUDA"):
        at.fractional_resample_kernel(*args)
    with pytest.raises(TypeError):
        at.fractional_resample_kernel(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        at.fm_deemphasis_kernel(args[0].to(torch.complex64), args[2],
                                torch.tensor(0.0), torch.tensor(0.0), 1.0,
                                1.0, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        at.fm_deemphasis_kernel(args[0], args[2], torch.tensor(0.0),
                                torch.tensor(0.0), 1.0, 1.0, 0.5)
    assert (at.fractional_resample.launches,
            at.fm_deemphasis.launches) == before
