"""The port's sharded WBFM bank in worlds of 1, 2 and 4 gloo ranks on
the CPU against the JAX package's ``ShardedWBFMBank`` at the same
(chan, time) mesh shape on the conftest's CPU mesh."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from grbaz_tpu.parallel.wbfm_bank import BankConfig, ShardedWBFMBank
from tests.torch_dist_worker import spawn

SHAPES = ((1, 1), (2, 2), (1, 4))
BLOCKS = 3
FREQS = np.array([-300e3, -100e3, 100e3, 300e3])
# tests/test_bank.py: make_bank's config, and the bit-exact test's
CFG = dict(channels=4, block_size=8192 * 2, sample_rate=1.024e6, decim=8,
           audio_rate=48e3, channel_width=100e3, transition=50e3)
EXACT_CFG = dict(channels=2, block_size=8192, sample_rate=1.024e6, decim=8,
                 audio_rate=16e3, channel_width=100e3, transition=100e3)
EXACT_FREQS = np.array([-100e3, 100e3])


def synth(cfg, freqs, nblocks, seed=0):
    """``tests/test_bank.py``'s FM stations: a 700 Hz tone at 50 kHz
    deviation on each channel, noise 0.02."""
    rng = np.random.default_rng(seed)
    n = cfg["block_size"] * nblocks
    t = np.arange(n) / cfg["sample_rate"]
    chans = []
    for f in freqs:
        msg = np.sin(2 * np.pi * 700.0 * t)
        phase = 2 * np.pi * np.cumsum(50e3 * msg) / cfg["sample_rate"]
        x = np.exp(1j * (phase + 2 * np.pi * f * t))
        x += 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        chans.append(x.astype(np.complex64))
    return np.stack(chans)


def exact_input():
    rng = np.random.default_rng(7)
    shape = (2, EXACT_CFG["block_size"])
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def case(shape, cfg, freqs, x):
    return dict(case="bank", mesh=list(shape), freqs=freqs, x=x, **cfg)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Three worlds: (1, 1) and the bit-exact run at time 1; the bit-exact
    run at time 2; (2, 2), (1, 4) and the bit-exact run at time 4."""
    x = synth(CFG, FREQS, BLOCKS)
    xe = exact_input()
    plan = {1: {"bank_1x1": case((1, 1), CFG, FREQS, x),
                "exact_1": case((1, 1), EXACT_CFG, EXACT_FREQS, xe)},
            2: {"exact_2": case((1, 2), EXACT_CFG, EXACT_FREQS, xe)},
            4: {"bank_2x2": case((2, 2), CFG, FREQS, x),
                "bank_1x4": case((1, 4), CFG, FREQS, x),
                "exact_4": case((1, 4), EXACT_CFG, EXACT_FREQS, xe)}}
    out = {}
    for w, cases in plan.items():
        out.update(spawn(w, cases, tmp_path_factory.mktemp(f"world{w}")))
    return out


def jax_bank(shape, cfg, freqs, x):
    """Per block: the JAX bank's compacted audio, its counts [C, pt] and
    its state."""
    pc, pt = shape
    devs = np.array(jax.devices()[:pc * pt]).reshape(pc, pt)
    bank = ShardedWBFMBank(BankConfig(**cfg), Mesh(devs, ("chan", "time")))
    state = jax.device_put(bank.init_state(), bank.state_shardings())
    params = bank.init_params(freqs)
    n = cfg["block_size"]
    blocks = []
    for b in range(x.shape[1] // n):
        xg = jax.device_put(np.ascontiguousarray(x[:, b * n:(b + 1) * n]),
                            bank.input_sharding())
        state, (audio, counts) = bank.step(state, params, xg)
        blocks.append((bank.compact_audio(audio, counts), np.asarray(counts),
                       jax.tree_util.tree_map(np.asarray, state)))
    return blocks


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bank_matches_jax(worlds, shape):
    """3 chained blocks: the audio within 1e-5 of its max; counts,
    ``lo_phase``, ``rs_mu_int`` and ``rs_mu_frac`` equal after every
    block; the carried tails within 1e-5 and the same on every time rank.
    At (1, 4) every time rank's input differs and each takes its halo
    from its left neighbour: a halo sent the wrong way fails here, where
    at 2 time ranks the two directions are the same exchange."""
    x = synth(CFG, FREQS, BLOCKS)
    ref = jax_bank(shape, CFG, FREQS, x)
    ranks = worlds[f"bank_{shape[0]}x{shape[1]}"]
    pc, pt = shape
    cl = CFG["channels"] // pc
    for ch in range(CFG["channels"]):
        want = np.concatenate([blk[0][ch] for blk in ref])
        for o in ranks:          # compact_audio gives every rank all of it
            got = o[f"audio_{ch}"]
            assert got.shape == want.shape and len(want) > 1000
            err = np.max(np.abs(got - want))
            assert err <= 1e-5 * np.max(np.abs(want)), (ch, err)
    for b, (_, counts, st) in enumerate(ref):
        got_counts = np.zeros_like(counts)
        for o in ranks:
            c, t = o["coord"]
            rows = slice(c * cl, (c + 1) * cl)
            got_counts[rows, t] = o[f"counts_{b}"][:, 0]
            for k in ("lo_phase", "rs_mu_int", "rs_mu_frac"):
                np.testing.assert_array_equal(
                    o[f"{k}_{b}"], st[k][rows].astype(o[f"{k}_{b}"].dtype),
                    err_msg=f"block {b} {k}")
            for k in ("fir_tail", "demod_prev", "rs_tail"):
                want = st[k][rows]
                scale = max(np.max(np.abs(st[k])), 1.0)
                assert np.max(np.abs(o[f"{k}_{b}"] - want)) <= 1e-5 * scale
                peer = next(p for p in ranks if p["coord"][0] == c)
                np.testing.assert_array_equal(o[f"{k}_{b}"], peer[f"{k}_{b}"])
        np.testing.assert_array_equal(got_counts, counts)


def test_bank_bit_exact_across_time_shardings(worlds):
    """The north-star invariant (``tests/test_bank.py``): the port's audio
    from time = 1, 2 and 4 ranks is bit-equal, time-shard boundaries
    leaving no trace."""
    a1, a2, a4 = (worlds[f"exact_{t}"][0] for t in (1, 2, 4))
    for c in range(2):
        assert len(a1[f"audio_{c}"]) > 100
        np.testing.assert_array_equal(a1[f"audio_{c}"], a2[f"audio_{c}"])
        np.testing.assert_array_equal(a1[f"audio_{c}"], a4[f"audio_{c}"])


def test_bank_state_shards_and_config_checks():
    """``shard_state``/``shard_input``/``init_params`` cut this rank's
    block in a one-rank world, and the config checks raise as JAX's."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from grbaz_tpu_torch.parallel.wbfm_bank import BankConfig as TCfg
    from grbaz_tpu_torch.parallel.wbfm_bank import ShardedWBFMBank as TBank

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("chan", "time"))
            bank = TBank(TCfg(**CFG), mesh)
            st = bank.shard_state(bank.init_state())
            assert st["fir_tail"].shape == (4, bank.hist)
            assert st["rs_mu_int"].dtype == torch.int32
            x = torch.zeros(4, CFG["block_size"], dtype=torch.complex64)
            assert bank.shard_input(x).shape == x.shape
            p = bank.init_params(FREQS)
            jb = ShardedWBFMBank(BankConfig(**CFG), Mesh(
                np.array(jax.devices()[:1]).reshape(1, 1), ("chan", "time")))
            jp = jb.init_params(FREQS)
            np.testing.assert_array_equal(p["lo_inc"].numpy(), jp["lo_inc"])
            assert int(p["rs_inc_frac"]) == int(jp["rs_inc_frac"])
            assert bank.audio_capacity == jb.audio_capacity
            assert bank.rs_cap_global == jb.rs_cap_global
            with pytest.raises(ValueError, match="time shards"):
                TBank(TCfg(**dict(CFG, block_size=48)), mesh)
        finally:
            dist.destroy_process_group()
