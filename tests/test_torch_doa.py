"""Port MUSIC direction finding == grbaz_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.ops import doa as jdoa
from grbaz_tpu_torch.ops import doa as tdoa
from tests.test_doa import simulate_ula
from tests.torch_parity import jax_run, port_run

CPU = "cpu"

# (antennas, angles in degrees, snapshots, angle bins, SNR dB, signals):
# the JAX package's own test cases (tests/test_doa.py)
SCENES = {
    "two_sources": (8, [60.0, 120.0], 256, 360, 20, 2),
    "subspace_vs_eigh": (8, [45.0, 135.0], 512, 360, 15, 2),
    "one_source": (4, [90.0], 128, 360, 20, 1),
    "close_3deg": (12, [88.5, 91.5], 2048, 720, 25, 2),
    # beside the 3-degree pair (which converges within the iteration
    # floor): a wide pair, and a pair 18 dB under the noise, whose
    # signal eigenvalues sit close to the noise's, so its subspace
    # iteration runs past the floor
    "wide_12": (12, [40.0, 130.0], 2048, 720, 25, 2),
    "low_snr_12": (12, [40.0, 130.0], 2048, 720, -18, 2),
}


@pytest.mark.parametrize("m,n_angles,spacing", [(8, 360, 0.5), (12, 720, 0.5),
                                                (4, 100, 0.3)])
def test_steering_vectors_equal(m, n_angles, spacing):
    np.testing.assert_array_equal(
        jdoa.ula_steering_vectors(m, n_angles, spacing),
        tdoa.ula_steering_vectors(m, n_angles, spacing))


def _spectra(scene, method):
    m, angles, navg, n_ang, snr, nsig = SCENES[scene]
    x, _ = simulate_ula(m, angles, navg, snr_db=snr, seed=3)
    st = jdoa.ula_steering_vectors(m, n_ang)
    js, _ = jdoa.music_spectrum(jnp.asarray(x), jnp.asarray(st), nsig,
                                method=method)
    ts, _ = tdoa.music_spectrum(torch.from_numpy(x), torch.from_numpy(st),
                                nsig, method=method)
    return np.asarray(js), ts.numpy(), nsig


def _peaks(spec, n):
    ji, _ = jdoa.top_n_peaks(jnp.asarray(spec), n)
    ti, _ = tdoa.top_n_peaks(torch.from_numpy(spec), n)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    return ti.numpy()


@pytest.mark.parametrize("method", ["subspace", "eigh"])
@pytest.mark.parametrize("scene", ["two_sources", "subspace_vs_eigh",
                                   "one_source"])
def test_music_spectrum_within_0p2_db(scene, method):
    """Both methods within 0.2 dB of the JAX spectrum (the bar of
    tests/test_doa.py), with the same peaks."""
    js, ts, nsig = _spectra(scene, method)
    assert ts.dtype == np.float32
    assert np.max(np.abs(10 * np.log10(ts / js))) < 0.2
    np.testing.assert_array_equal(_peaks(js, nsig), _peaks(ts, nsig))


@pytest.mark.parametrize("method", ["subspace", "eigh"])
def test_music_close_pair_peaks_equal(method):
    """Two sources 3 degrees apart: the same peak pair; within 0.2 dB off
    the two peaks. At the peaks ||a||^2 - ||U^H a||^2 cancels to ~1e-4
    of ||a||^2 in float32, where the JAX spectrum itself is ~0.5 dB from
    a float64 solve, so the peak bins are held to their peaks only."""
    js, ts, nsig = _spectra("close_3deg", method)
    pk = _peaks(js, nsig)
    np.testing.assert_array_equal(pk, _peaks(ts, nsig))
    off = np.ones(js.shape, bool)
    for p in pk:
        off[max(p - 2, 0):p + 3] = False
    assert np.max(np.abs(10 * np.log10(ts[off] / js[off]))) < 0.2


def test_top_n_peaks_breaks_ties_toward_the_lower_index():
    """A spectrum with fewer peaks than n (-inf ties) and equal peaks."""
    s = -np.arange(50, dtype=np.float32) * 1e-3  # one peak at 0
    s[[5, 20, 33]] = [2.0, 2.0, 1.0]
    s[40:43] = 3.0  # a plateau: every sample of it is a local max
    for n in (1, 3, 6, 20):
        _peaks(s, n)
    ti, tv = tdoa.top_n_peaks(torch.from_numpy(s), 20)
    assert ti[:3].tolist() == [40, 41, 42] and bool(torch.isinf(tv[-1]))


def _frames(scenes, n_frames):
    """Frames of the scenes in turn (one array size and navg)."""
    out = []
    for f in range(n_frames):
        m, angles, navg, _, snr, _ = SCENES[scenes[f % len(scenes)]]
        x, _ = simulate_ula(m, angles, navg, snr_db=snr, seed=10 + f)
        out.append(x.reshape(-1))
    return np.stack(out)


@pytest.mark.parametrize("method", ["subspace", "eigh"])
def test_music_block_mixed_batch_equals_jax_frame_by_frame(method):
    """A batch that mixes easy frames (a wide pair) with the 3-degree pair
    and a low-SNR pair whose subspace iteration runs past the floor: each
    frame of the port's batch equals the JAX block run on that frame
    alone (peaks equal; spectra within 0.2 dB off the peaks), over two
    chained blocks, the second partial."""
    frames = _frames(("wide_12", "close_3deg", "low_snr_12"), 6)
    jb = jdoa.MusicDOA(12, 2, 2048, n_angles=720, method=method)
    tb = tdoa.MusicDOA(12, 2, 2048, n_angles=720, method=method, device=CPU)
    blocks, counts = [frames[:4], frames[4:]], [4, 1]
    before = tdoa.signal_subspace.host_syncs
    to, _ = port_run(tb, blocks, counts)
    if method == "subspace":  # the low-SNR frames iterate past the floor
        assert tdoa.signal_subspace.host_syncs - before > 2
    for b, blk in enumerate(blocks):
        (t_spec, tc), (t_doa, dc) = to[b]
        assert tc == dc == counts[b] and t_doa.dtype == np.int32
        for f in range(blk.shape[0]):
            (jo,), _ = jax_run(jb, [blk[f:f + 1]])
            (j_spec, _), (j_doa, _) = jo
            np.testing.assert_array_equal(np.sort(j_doa[0]), np.sort(t_doa[f]))
            off = np.ones(720, bool)
            for p in j_doa[0]:
                off[max(p - 2, 0):p + 3] = False
            err = np.abs(10 * np.log10(t_spec[f][off] / j_spec[0][off]))
            assert err.max() < 0.2


def test_signal_subspace_iteration_counts_per_frame():
    """Each frame stops on its own test: a frame that converges at the
    floor is not changed by the longer iteration of another frame in the
    batch, and the host checks once every SYNC_EVERY iterations."""
    xs = [simulate_ula(12, [40.0, 130.0], 2048, snr_db=snr, seed=4)[0]
          for snr in (25, -18)]
    r = torch.stack([torch.from_numpy(x.conj().T @ x / 2048) for x in xs])
    at_floor = tdoa.signal_subspace(r, 2, max_iters=24)
    before = tdoa.signal_subspace.host_syncs
    both = tdoa.signal_subspace(r, 2)
    syncs = tdoa.signal_subspace.host_syncs - before
    assert torch.equal(both[0], at_floor[0])
    assert not torch.equal(both[1], at_floor[1])
    assert 2 <= syncs <= 1 + (96 - 24) // tdoa.SYNC_EVERY
