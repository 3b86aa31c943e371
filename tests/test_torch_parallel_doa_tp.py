"""The port's mesh collectives, sharded MUSIC and the tap-sharded FIR in
worlds of 2 and 4 gloo ranks on the CPU, against the JAX package's
``parallel/doa.py`` and ``parallel/tp.py`` on the conftest's CPU mesh
at the same device count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grbaz_tpu.ops.doa import music_spectrum, ula_steering_vectors
from grbaz_tpu.ops.fir import low_pass_taps
from grbaz_tpu.parallel import doa as jdoa
from grbaz_tpu.parallel import tp as jtp
from grbaz_tpu_torch.core.stream import Stream
from grbaz_tpu_torch.ops.fir import FIRDecimator
from grbaz_tpu_torch.parallel import doa as tdoa
from grbaz_tpu_torch.parallel import tp as ttp
from tests.conftest import snr_db
from tests.torch_dist_worker import spawn

WORLDS = (2, 4)
MUSIC_ANGLES = [60.0, 110.0]
BLOCK = 4096


def music_inputs():
    """``tests/test_doa.py``'s sharded-MUSIC widths."""
    x = jdoa.simulate_snapshots(8, MUSIC_ANGLES, 256, snr_db=20.0, seed=3)
    return x, ula_steering_vectors(8, n_angles=360)


def tp_filters():
    """``tests/test_tp.py``'s two filters over 4 chained blocks: complex
    (121 taps, decim 8) and real (1025 taps, decim 4)."""
    rng = np.random.default_rng(5)
    n = 4 * BLOCK
    xc = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    xr = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    return dict(
        complex=(xc, low_pass_taps(1.0, 1.0, 0.05, 0.02), 8),
        real=(xr, np.sinc(np.linspace(-8, 8, 1025)).astype(np.float32), 4))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case of this file, in one world of each size."""
    x, steering = music_inputs()
    out = {}
    for w in WORLDS:
        cases = {"collectives": dict(case="collectives"),
                 "music": dict(case="music", mesh=[w], x=x,
                               steering=steering, n_sig=2)}
        for name, (xs, taps, decim) in tp_filters().items():
            cases[f"tp_{name}"] = dict(case="tp", mesh=[w], x=xs, taps=taps,
                                       decim=decim, block=BLOCK)
        out[w] = spawn(w, cases, tmp_path_factory.mktemp(f"world{w}"))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _f(r):
    return np.arange(6, dtype=np.float32) + 10.0 * r


def _i(r):
    return np.arange(3, dtype=np.int64) * 2 ** 33 + r


@pytest.mark.parametrize("w", WORLDS)
def test_psum_replicate_gather(worlds, w):
    res = worlds[w]["collectives"]
    fsum = sum(_f(r) for r in range(w))
    for r, o in enumerate(res):
        np.testing.assert_array_equal(o["psum_f"], fsum)
        np.testing.assert_array_equal(o["psum_c"], fsum - 1j * fsum)
        np.testing.assert_array_equal(o["psum_i"], sum(_i(q) for q in range(w)))
        np.testing.assert_array_equal(o["rep_f"], _f(w - 1))
        np.testing.assert_array_equal(o["rep_c"], _f(w - 1) - 1j * _f(w - 1))
        assert o["rep_b"].dtype == np.bool_
        np.testing.assert_array_equal(o["rep_b"], [False, True])  # rank 1's
        np.testing.assert_array_equal(
            o["gather"], np.stack([_f(q) - 1j * _f(q) for q in range(w)]))


@pytest.mark.parametrize("w", WORLDS)
def test_ppermute_direction(worlds, w):
    """(src, dst) pairs: rank r gets rank r-1's tensor for (i, i+1), rank
    r+1's for (i, i-1); a rank no pair sends to gets zeros. Only at 4
    ranks does the cyclic shift tell the two directions apart."""
    for r, o in enumerate(worlds[w]["collectives"]):
        left = (r - 1) % w
        np.testing.assert_array_equal(o["cyc"], _f(left) - 1j * _f(left))
        np.testing.assert_array_equal(o["lin"], _f(r - 1) if r else 0 * _f(0))
        np.testing.assert_array_equal(o["rev"], _i(r + 1) if r < w - 1
                                      else 0 * _i(0))


def test_mesh_dim_collectives(worlds):
    """Over the 'time' dim of a (chan, time) = (2, 2) mesh: the sum and
    the swap stay inside each chan row; ``shard`` cuts the rank's half."""
    res = worlds[4]["collectives"]
    for r, o in enumerate(res):
        c, t = o["coord"]
        assert (c, t) == (r // 2, r % 2)
        peer = 2 * c + (1 - t)
        np.testing.assert_array_equal(o["time_psum"], _f(r) + _f(peer))
        np.testing.assert_array_equal(o["time_cyc"], _f(peer))
        np.testing.assert_array_equal(o["shard"], np.arange(4.0) + 4 * t)


@pytest.mark.parametrize("w", WORLDS)
def test_one_rank_groups_are_identity(worlds, w):
    for r, o in enumerate(worlds[w]["collectives"]):
        np.testing.assert_array_equal(o["one_psum"], _f(r) - 1j * _f(r))
        np.testing.assert_array_equal(o["one_rep"], _f(r))
        np.testing.assert_array_equal(o["one_cyc"], _i(r))
        np.testing.assert_array_equal(o["one_lin"], 0 * _f(0))
        np.testing.assert_array_equal(o["one_gather"], _f(r)[None])


# ---------------------------------------------------------------------------
# sharded MUSIC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_sharded_music_matches_jax(worlds, w):
    """Within 0.2 dB of JAX's sharded MUSIC at the same device count (the
    JAX test's bar against its serial solve), peaks within 3 degrees of
    the true angles."""
    x, steering = music_inputs()
    mesh = Mesh(np.array(jax.devices()[:w]), ("dev",))
    ref = np.asarray(jdoa.sharded_music_spectrum(
        jnp.asarray(x), jnp.asarray(steering), 2, mesh))
    got = np.concatenate([o["spec"] for o in worlds[w]["music"]])
    assert got.shape == ref.shape == (360,)
    db_err = np.max(np.abs(10 * np.log10(got / ref)))
    assert db_err < 0.2, db_err
    top = np.sort(np.argsort(got)[-8:] * 0.5)
    found = [np.min(np.abs(top - a)) for a in MUSIC_ANGLES]
    assert max(found) < 3.0, (top, MUSIC_ANGLES)
    # and JAX's serial solve
    serial, _ = music_spectrum(jnp.asarray(x), jnp.asarray(steering), 2)
    assert np.max(np.abs(10 * np.log10(got / np.asarray(serial)))) < 0.2


def test_simulate_snapshots_is_the_jax_helper():
    np.testing.assert_array_equal(
        tdoa.simulate_snapshots(8, MUSIC_ANGLES, 256, snr_db=20.0, seed=3),
        jdoa.simulate_snapshots(8, MUSIC_ANGLES, 256, snr_db=20.0, seed=3))


# ---------------------------------------------------------------------------
# tap-sharded FIR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("taps,decim,shards", [
    (np.arange(37, dtype=np.float32), 4, 4),
    (low_pass_taps(1.0, 1.0, 0.05, 0.02), 8, 2),
    (np.sinc(np.linspace(-8, 8, 1025)).astype(np.float32), 4, 4),
    (np.sinc(np.linspace(-8, 8, 1025)).astype(np.float32), 4, 1)])
def test_shard_taps_equals_jax(taps, decim, shards):
    got = ttp.shard_taps(taps, decim, shards)
    np.testing.assert_array_equal(got, jtp.shard_taps(taps, decim, shards))
    assert got.dtype == np.float32


def jax_tp(xs, taps, decim, w):
    mesh = Mesh(np.array(jax.devices()[:w]), ("tp",))
    blk = jtp.TPFIRDecimator(taps, decim, mesh, dtype=jnp.asarray(xs).dtype)
    step = blk.make_step()
    state = jax.tree_util.tree_map(jnp.asarray, blk.init_state())
    params = {"h": jax.device_put(blk.init_params()["h"],
                                  NamedSharding(mesh, P("tp", None)))}
    outs = []
    for k in range(0, len(xs), BLOCK):
        state, y = step(state, params, jnp.asarray(xs[k:k + BLOCK]))
        outs.append(np.asarray(y))
    return np.concatenate(outs), np.asarray(params["h"])


def port_serial(xs, taps, decim):
    blk = FIRDecimator(taps, decim, dtype=torch.from_numpy(xs).dtype,
                       device="cpu")
    state = blk.init_state()
    outs = []
    for k in range(0, len(xs), BLOCK):
        state, (y,) = blk.apply(state, None, Stream.full(
            torch.from_numpy(xs[k:k + BLOCK])))
        outs.append(y.data.numpy())
    return np.concatenate(outs)


@pytest.mark.parametrize("name", ["complex", "real"])
@pytest.mark.parametrize("w", WORLDS)
def test_tp_fir_matches_jax_and_serial(worlds, w, name):
    """Above 120 dB against JAX's TPFIRDecimator at the same tp and
    against the port's serial FIRDecimator (the JAX tests' bar); every
    rank gets the same output from ``make_step`` and ``apply``, and
    holds its row of the tap bank."""
    xs, taps, decim = tp_filters()[name]
    ref, h_bank = jax_tp(xs, taps, decim, w)
    serial = port_serial(xs, taps, decim)
    res = worlds[w][f"tp_{name}"]
    got = res[0]["y"]
    assert got.shape == ref.shape == serial.shape
    assert got.dtype == xs.dtype
    assert snr_db(ref, got) > 120
    assert snr_db(serial, got) > 120
    for r, o in enumerate(res):
        np.testing.assert_array_equal(o["y"], got)
        np.testing.assert_array_equal(o["y_apply"], got)
        np.testing.assert_array_equal(o["h"], h_bank[r:r + 1])
        np.testing.assert_array_equal(o["tail"], xs[-(h_bank.size - 1):])
