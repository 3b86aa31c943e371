"""Port FIR blocks and the plain twins of its CUDA kernels == grbaz_tpu.

The JAX references run on the CPU: the XLA arms directly, the Pallas
kernels in interpret mode. Bars are the JAX package's own
(``tests/test_wbfm_frontend.py``: max-abs error < 1e-5 * max|ref|).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu.ops import fir as jfir
from grbaz_tpu_torch.convert import params_from_numpy, states_from_numpy
from grbaz_tpu_torch.core.stream import Stream as TStream
from grbaz_tpu_torch.ops import fir as tfir
from grbaz_tpu_torch.ops.cuda import fir_decimate as tfd
from grbaz_tpu_torch.ops.cuda import xlating_fir as txf
from tests.conftest import snr_db

FS = 3.2e6
DECIM = 8
N = 1024 * DECIM
CPU = "cpu"


def _taps():
    return jfir.low_pass_taps(1.0, FS, 112.5e3, 75e3)


def _cnoise(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < rel * scale


def run_jax(blk, blocks, counts, params_seq):
    st = jax.tree_util.tree_map(jnp.asarray, blk.init_state())
    outs, cnts = [], []
    for x, c, pr in zip(blocks, counts, params_seq):
        s = JStream(jnp.asarray(x), jnp.int32(c),
                    JStream.full(jnp.asarray(x)).meta)
        st, (y,) = blk.apply(st, pr, s)
        outs.append(np.asarray(y.data))
        cnts.append(int(y.count))
    return np.concatenate(outs), cnts


def run_port(blk, blocks, counts, params_seq):
    st = blk.init_state()
    outs, cnts = [], []
    for x, c, pr in zip(blocks, counts, params_seq):
        s = TStream.full(torch.from_numpy(x))
        s.count = torch.tensor(c, dtype=torch.int32)
        st, (y,) = blk.apply(st, params_from_numpy(pr, CPU), s)
        outs.append(y.data.numpy())
        cnts.append(int(y.count))
    return np.concatenate(outs), cnts


def _stream_case(rng, retune=True):
    """3 chained blocks, a mid-stream lo_inc retune, a partial last block."""
    blocks = [_cnoise(rng, N) for _ in range(3)]
    counts = [N, N, N - 3 * DECIM - 5]
    p0 = jfir.FreqXlatingFIRDecimator.freq_params(250e3, FS)
    p1 = jfir.FreqXlatingFIRDecimator.freq_params(-431.7e3, FS) \
        if retune else p0
    return blocks, counts, [p0, p1, p1]


@pytest.mark.parametrize("retune", [False, True])
def test_kernel_arm_plain_twin_matches_jax_xal_interpret(rng, retune):
    """Port x-aligned arm (CPU -> plain twin of the CUDA kernel) == JAX
    xlating_fir_block_pallas_xal in interpret mode. The port's kernel arm
    carries the rotated tail of the JAX XLA arm, so across a retune its
    outputs follow that arm (the JAX Pallas arm carries an unrotated tail
    and differs from it for ~13 outputs after the retune)."""
    blocks, counts, params = _stream_case(rng, retune)
    if retune:
        jblk = jfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                            backend="xla",
                                            precision="highest")
    else:
        jblk = jfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                            backend="pallas_xal",
                                            interpret=True,
                                            precision="highest")
    tblk = tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="kernel", device=CPU)
    ref, rc = run_jax(jblk, blocks, counts, params)
    got, gc = run_port(tblk, blocks, counts, params)
    assert gc == rc == [c // DECIM for c in counts]
    _close(got, ref)


@pytest.mark.parametrize("fir_kernel", [False, True])
def test_plain_arm_matches_jax_xla_with_retune(rng, fir_kernel):
    """Rotate-then-filter arm (rotated tail) == the JAX XLA arm across a
    retune and a partial block; fir_kernel routes the filter through the
    decimating-FIR kernel's wrapper (its plain twin on the CPU)."""
    blocks, counts, params = _stream_case(rng)
    jblk = jfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="xla", precision="highest")
    tblk = tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="plain", fir_kernel=fir_kernel,
                                        device=CPU)
    ref, rc = run_jax(jblk, blocks, counts, params)
    got, gc = run_port(tblk, blocks, counts, params)
    assert gc == rc
    _close(got, ref)


def test_kernel_arm_matches_jax_xla_without_retune(rng):
    blocks, counts, params = _stream_case(rng, retune=False)
    jblk = jfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="xla", precision="highest")
    tblk = tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="kernel", device=CPU)
    _close(run_port(tblk, blocks, counts, params)[0],
           run_jax(jblk, blocks, counts, params)[0])


def test_rotate_taps_arm_matches_jax(rng):
    blocks, counts, params = _stream_case(rng)
    jblk = jfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        rotate_taps=True)
    tblk = tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        rotate_taps=True, device=CPU)
    _close(run_port(tblk, blocks, counts, params)[0],
           run_jax(jblk, blocks, counts, params)[0])


def test_xlating_block_plain_twin_matches_jax_kernel_directly(rng):
    from grbaz_tpu.ops.pallas.wbfm_frontend import \
        xlating_fir_block_pallas_xal
    h = jfir.prepare_taps(_taps(), DECIM)
    x, tail = _cnoise(rng, N), _cnoise(rng, h.shape[0])
    ph, inc = 0xFFFFF000, 0x9E3779B9
    ref = xlating_fir_block_pallas_xal(
        jnp.asarray(x), jnp.asarray(tail), h, DECIM, jnp.uint32(ph),
        jnp.uint32(inc), precision="highest", interpret=True)
    got = txf.xlating_fir_block(torch.from_numpy(x), torch.from_numpy(tail),
                                torch.from_numpy(h), DECIM,
                                torch.tensor(ph), torch.tensor(inc))
    _close(got.numpy(), ref)


def test_frame_rtf_plain_twin_matches_jax_rtf_interpret(rng):
    from grbaz_tpu.ops.pallas.wbfm_frontend import \
        xlating_fir_frame_pallas_rtf
    h = jfir.prepare_taps(_taps(), DECIM)
    frame = _cnoise(rng, h.shape[0] - 1 + N)
    ph, inc = 987654321, 123456789
    ref = xlating_fir_frame_pallas_rtf(
        jnp.asarray(frame), h, DECIM, jnp.uint32(ph), jnp.uint32(inc),
        precision="highest", interpret=True)
    got = txf.xlating_fir_frame_rtf(torch.from_numpy(frame),
                                    torch.from_numpy(h), DECIM,
                                    torch.tensor(ph), torch.tensor(inc))
    _close(got.numpy(), ref)


def test_frame_rtf_equals_block_form(rng):
    """The two entry points of the one kernel agree on the same data."""
    h = torch.from_numpy(jfir.prepare_taps(_taps(), DECIM))
    x = torch.from_numpy(_cnoise(rng, N))
    tail = torch.from_numpy(_cnoise(rng, h.shape[0]))
    ph, inc = torch.tensor(5), torch.tensor(0xC0000001)
    a = txf.xlating_fir_block(x, tail, h, DECIM, ph, inc)
    b = txf.xlating_fir_frame_rtf(torch.cat([tail[1:], x]), h, DECIM, ph, inc)
    _close(b.numpy(), a.numpy(), rel=1e-6)


@pytest.mark.parametrize("complex_frame", [False, True])
@pytest.mark.parametrize("tap_spec,decim", [((112.5e3, 75e3), 8),
                                            ((45e3, 30e3), 4)])
def test_fir_decimate_plain_twin_matches_jax_pallas(rng, complex_frame,
                                                    tap_spec, decim):
    from grbaz_tpu.ops.pallas import fir_decimate_frame_pallas
    h = jfir.prepare_taps(jfir.low_pass_taps(1.0, FS, *tap_spec), decim)
    n = 512 * decim
    frame = _cnoise(rng, h.shape[0] - 1 + n)
    if not complex_frame:
        frame = frame.real.copy()
    ref = fir_decimate_frame_pallas(jnp.asarray(frame), h, decim,
                                    interpret=True)
    got = tfd.fir_decimate_frame(torch.from_numpy(frame),
                                 torch.from_numpy(h), decim)
    assert got.dtype == torch.from_numpy(frame).dtype
    _close(got.numpy(), ref)


def test_fir_decimate_plain_matches_direct_sum(rng):
    """The polyphase plain version == the defining sum in float64."""
    h = jfir.prepare_taps(rng.standard_normal(37).astype(np.float32), 3)
    frame = _cnoise(rng, h.shape[0] - 1 + 300)
    got = tfir.fir_decimate_frame(torch.from_numpy(frame),
                                  torch.from_numpy(h), 3).numpy()
    want = np.array([np.dot(h.astype(np.float64),
                            frame[k * 3:k * 3 + h.shape[0]])
                     for k in range(100)])
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["auto", "plain", "kernel"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_fir_decimator_streams_like_jax(rng, backend, dtype):
    taps = jfir.low_pass_taps(1.0, 400e3, 21.6e3, 9.6e3,
                              window="blackmanharris")
    n = 2048
    blocks = [_cnoise(rng, n) for _ in range(3)]
    if dtype is np.float32:
        blocks = [b.real.copy() for b in blocks]
    counts = [n, n, n - 17]
    jblk = jfir.FIRDecimator(taps, 8, dtype=dtype)
    tblk = tfir.FIRDecimator(taps, 8, dtype=torch.from_numpy(blocks[0]).dtype,
                             backend=backend, device=CPU)
    ref, rc = run_jax(jblk, blocks, counts, [None] * 3)
    got, gc = run_port(tblk, blocks, counts, [None] * 3)
    assert gc == rc
    _close(got, ref)


def test_fir_decimator_short_block_tail(rng):
    """Blocks shorter than the tail carry history across blocks."""
    taps = _taps()
    blocks = [_cnoise(rng, 64) for _ in range(4)]
    jblk = jfir.FIRDecimator(taps, 8)
    tblk = tfir.FIRDecimator(taps, 8, device=CPU)
    _close(run_port(tblk, blocks, [64] * 4, [None] * 4)[0],
           run_jax(jblk, blocks, [64] * 4, [None] * 4)[0])


def test_fir_decimator_matches_golden():
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "golden.npz"))
    blk = tfir.FIRDecimator(fix["fir_taps"], int(fix["fir_decim"]),
                            device=CPU)
    _, (y,) = blk.apply(blk.init_state(), None,
                        TStream.full(torch.from_numpy(fix["fir_in"])))
    assert snr_db(fix["fir_out"], y.data.numpy()) > 110.0


def test_state_from_jax_continues_stream(rng):
    """A JAX block state carried into the port continues the stream."""
    taps = _taps()
    x0, x1 = _cnoise(rng, N), _cnoise(rng, N)
    jblk = jfir.FreqXlatingFIRDecimator(taps, DECIM, 250e3, FS,
                                        backend="xla", precision="highest")
    st = jax.tree_util.tree_map(jnp.asarray, jblk.init_state())
    st, _ = jblk.apply(st, jblk.init_params(), JStream.full(jnp.asarray(x0)))
    _, (ref,) = jblk.apply(st, jblk.init_params(),
                           JStream.full(jnp.asarray(x1)))
    tblk = tfir.FreqXlatingFIRDecimator(taps, DECIM, 250e3, FS,
                                        backend="plain", device=CPU)
    tst = states_from_numpy(jax.tree_util.tree_map(np.asarray, st), CPU)
    _, (got,) = tblk.apply(tst, tblk.init_params(),
                           TStream.full(torch.from_numpy(x1)))
    _close(got.data.numpy(), np.asarray(ref.data))


@pytest.mark.parametrize("first,then", [("kernel", "plain"),
                                        ("plain", "kernel")])
def test_channel_state_moves_between_arms_across_a_retune(rng, first, then,
                                                          tmp_path):
    """Two blocks on one arm, a checkpoint, then a retune and two blocks on
    the other arm (the kernel arm through its plain twin here): the
    outputs equal one uninterrupted run, and both arms carry the rotated
    tail."""
    from grbaz_tpu_torch.core import checkpoint as tckpt
    blocks = [_cnoise(rng, 4096) for _ in range(4)]
    p0 = params_from_numpy(
        jfir.FreqXlatingFIRDecimator.freq_params(250e3, FS), CPU)
    p1 = params_from_numpy(
        jfir.FreqXlatingFIRDecimator.freq_params(-431.7e3, FS), CPU)
    prs = [p0, p0, p1, p1]

    def run(blk, st, xs, ps):
        ys = []
        for x, pr in zip(xs, ps):
            st, (y,) = blk.apply(st, pr, TStream.full(torch.from_numpy(x)))
            ys.append(y.data)
        return st, ys

    def block(backend):
        return tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                            backend=backend, device=CPU)

    a, b = block(first), block(then)
    st, _ = run(a, a.init_state(), blocks[:2], prs[:2])
    _, ref = run(a, st, blocks[2:], prs[2:])
    st_b, _ = run(b, b.init_state(), blocks[:2], prs[:2])
    _close(st_b["tail"].numpy(), st["tail"].numpy(), rel=1e-6)
    assert torch.equal(st_b["phase"], st["phase"])
    p = str(tmp_path / "chan.npz")
    tckpt.save_state(p, {"c": st})
    back, _, _ = tckpt.load_state(p, {"c": b.init_state()})
    _, got = run(b, back["c"], blocks[2:], prs[2:])
    _close(torch.cat(got).numpy(), torch.cat(ref).numpy())


@pytest.mark.parametrize("n", [64, 1000, N + 3])
def test_kernel_arm_short_and_ragged_blocks_match_jax(rng, n):
    """Blocks shorter than the tail or not a multiple of decim go through
    the channelizer kernel's block entry point (its plain twin here)."""
    blocks = [_cnoise(rng, n) for _ in range(4)]
    counts = [n] * 4
    params = [jfir.FreqXlatingFIRDecimator.freq_params(250e3, FS)] * 4
    jblk = jfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="xla", precision="highest")
    tblk = tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 250e3, FS,
                                        backend="kernel", device=CPU)
    ref, rc = run_jax(jblk, blocks, counts, params)
    got, gc = run_port(tblk, blocks, counts, params)
    assert gc == rc
    _close(got, ref)


def test_backend_and_device_validation():
    with pytest.raises(ValueError):
        tfir.FIRDecimator(_taps(), 8, backend="xla", device=CPU)
    with pytest.raises(ValueError):
        tfir.FreqXlatingFIRDecimator(_taps(), DECIM, 0.0, FS,
                                     backend="pallas_xal", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tfir.FIRDecimator(_taps(), 8)  # device="cuda" without a card


@pytest.mark.parametrize("decim", [4, 8, 25])
@pytest.mark.parametrize("complex_frame", [False, True])
def test_fir_decimate_frame_windows_matches_jax(decim, complex_frame):
    # tests/test_fir.py:test_poly_vs_windows_formulations' frames
    rng = np.random.default_rng(7 + decim)
    h = tfir.prepare_taps(tfir.low_pass_taps(1.0, 1e6, 1e5, 5e4), decim)
    n = decim * 1024 + len(h) - 1
    fr = rng.standard_normal(n).astype(np.float32)
    if complex_frame:
        fr = (fr + 1j * rng.standard_normal(n)).astype(np.complex64)
    want = np.asarray(jfir.fir_decimate_frame_windows(
        jnp.asarray(fr), jnp.asarray(h), decim))
    got = tfir.fir_decimate_frame_windows(torch.from_numpy(fr),
                                          torch.from_numpy(h), decim)
    assert got.dtype == (torch.complex64 if complex_frame else torch.float32)
    assert got.shape == want.shape == (1024,)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    with pytest.raises(ValueError, match="multiple of decim"):
        tfir.fir_decimate_frame_windows(torch.from_numpy(fr[1:]),
                                        torch.from_numpy(h), decim)
