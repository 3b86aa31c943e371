"""The port's FEC blocks (ops/fec.py) == the JAX package's, on the CPU.

The scrambler, puncturing, the Viterbi decoder's plain version (bits and
final path metrics) and the GLFSR source are held bit for bit to the JAX
package over seeded inputs; the block-parallel PNBERv is held within 1e-6
absolute of the JAX scan's running BER, its register and warm count
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grbaz_tpu.ops import fec as jf
from grbaz_tpu_torch.convert import states_from_numpy, to_numpy
from grbaz_tpu_torch.ops import fec as tf

from test_torch_decode import same, step_both
from torch_parity import split


def jax_path_metrics(metrics, k, polys):
    """The final path metrics of the JAX package's add-compare-select scan
    (``viterbi_decode`` returns only the bits): its ``acs`` step as
    written there."""
    ns = 1 << (k - 1)
    prev, _, prev_out = jf._build_trellis(k, polys)
    prev = jnp.asarray(prev)
    exp = jnp.asarray(prev_out.astype(np.float32) * 2.0 - 1.0)

    def acs(pm, r):
        bm = jnp.einsum("tjc,c->tj", exp, r)
        new_pm = jnp.max(pm[prev] + bm, axis=1)
        return new_pm - jnp.max(new_pm), None
    pm0 = jnp.where(jnp.arange(ns) == 0, 0.0, -1e9)
    return np.asarray(jax.lax.scan(acs, pm0, jnp.asarray(metrics))[0])


CODES = {2: (0o3, 0o2), 5: (0o23, 0o35), 7: (0o171, 0o133),
         10: (0o1167, 0o1545)}


@pytest.mark.parametrize("k", [2, 5, 7, 10])
@pytest.mark.parametrize("noise", [0.0, 0.7])
def test_viterbi_plain_matches_jax(k, noise):
    rng = np.random.default_rng(k * 10 + int(noise * 10))
    polys = CODES[k]
    bits = rng.integers(0, 2, 1500).astype(np.uint8)
    soft = (jf.conv_encode(bits, k, polys).astype(np.float32) * 2 - 1
            + noise * rng.standard_normal((1500, 2))).astype(np.float32)
    jb = np.asarray(jf.viterbi_decode(jnp.asarray(soft), k, polys))
    tb, pm = tf.viterbi_plain(torch.from_numpy(soft), torch.from_numpy(
        tf.expected_outputs(k, polys)))
    assert same(jb, tb.numpy())
    assert same(jax_path_metrics(soft, k, polys), pm.numpy())
    assert same(jb, tf.viterbi_decode(torch.from_numpy(soft), k, polys))
    if noise == 0.0:
        np.testing.assert_array_equal(tb.numpy()[:-10], bits[:-10])


def test_viterbi_ties_take_the_first_predecessor():
    # erasures (zero soft pairs) make every candidate pair equal
    soft = np.zeros((40, 2), np.float32)
    soft[::7] = (1.0, -1.0)
    jb = np.asarray(jf.viterbi_decode(jnp.asarray(soft)))
    tb, pm = tf.viterbi_plain(torch.from_numpy(soft), torch.from_numpy(
        tf.expected_outputs(7, CODES[7])))
    assert same(jb, tb.numpy())
    assert same(jax_path_metrics(soft, 7, CODES[7]), pm.numpy())


@pytest.mark.parametrize("overlap,bs", [(64, 1024), (96, 700)])
def test_viterbi_decoder_matches_jax_block_by_block(overlap, bs):
    rng = np.random.default_rng(overlap)
    bits = rng.integers(0, 2, 3000).astype(np.uint8)
    soft = (jf.conv_encode(bits).astype(np.float32) * 2 - 1
            + 0.5 * rng.standard_normal((3000, 2))).astype(np.float32)
    blocks, counts = split(soft, bs)
    outs = step_both(jf.ViterbiDecoder(overlap=overlap),
                     tf.ViterbiDecoder(overlap=overlap, device="cpu"),
                     blocks, counts)
    got = np.concatenate([o[0].data[: int(o[0].count)].numpy()
                          for o in outs])
    assert np.mean(got[200:-10] != bits[200:len(got) - 10]) < 0.01


def test_conv_encode_and_trellis_are_the_jax_packages():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    for k, polys in CODES.items():
        np.testing.assert_array_equal(jf.conv_encode(bits, k, polys),
                                      tf.conv_encode(bits, k, polys))
        for a, b in zip(jf._build_trellis(k, polys),
                        tf._build_trellis(k, polys)):
            np.testing.assert_array_equal(a, b)
    for d in range(1, 33):
        assert jf._default_poly(d) == tf._default_poly(d)


@pytest.mark.parametrize("kw", [dict(count=0, bits_per_byte=8),
                                dict(count=100, bits_per_byte=1),
                                dict(mask=0x12, seed=0x1F, reg_len=5,
                                     count=37, bits_per_byte=3)])
@pytest.mark.parametrize("bs", [700, 1024])
def test_scrambler_matches_jax(kw, bs):
    rng = np.random.default_rng(bs)
    data = rng.integers(0, 256, 3000).astype(np.uint8)
    blocks, counts = split(data, bs)
    step_both(jf.AdditiveScrambler(**kw),
              tf.AdditiveScrambler(**kw, device="cpu"), blocks, counts)


@pytest.mark.parametrize("matrix", [[1, 1, 0, 1], [1, 0, 1, 1, 0, 1]])
@pytest.mark.parametrize("bs", [700, 768])
def test_puncture_and_depuncture_match_jax(matrix, bs):
    rng = np.random.default_rng(len(matrix) + bs)
    x = rng.standard_normal(3000).astype(np.float32)
    blocks, counts = split(x, bs)
    step_both(jf.Puncture(matrix), tf.Puncture(matrix, device="cpu"),
              blocks, counts)
    step_both(jf.Depuncture(matrix, 0.25),
              tf.Depuncture(matrix, 0.25, device="cpu"), blocks, counts)


@pytest.mark.parametrize("degree", [7, 16, 32])
@pytest.mark.parametrize("convention", ["gr", "pn"])
@pytest.mark.parametrize("bipolar", [False, True])
def test_glfsr_source_matches_jax(degree, convention, bipolar):
    kw = dict(convention=convention, seed=0x5A5A5A5A >> (32 - degree),
              bipolar=bipolar)
    jb, tb = jf.GLFSRSource(degree, 1000, **kw), tf.GLFSRSource(
        degree, 1000, **kw, device="cpu")
    js = jax.tree_util.tree_map(jnp.asarray, jb.init_state())
    ts = tb.init_state()
    for _ in range(3):
        js, (jo,) = jb.apply(js, None)
        ts, (to,) = tb.apply(ts, None)
        assert same(np.asarray(jo.data), to.data.numpy())
        assert int(jo.count) == int(to.count)
        assert int(js["reg"]) == int(ts["reg"])


def pn_stream(rng, n, flip):
    reg, bits = 0x5A, np.zeros(n, np.uint8)
    for i in range(n):
        b = bin(reg & 0x60).count("1") % 2
        bits[i] = b
        reg = ((reg << 1) | b) & 0x7F
    return bits ^ (rng.random(n) < flip)


@pytest.mark.parametrize("bs,n,alpha", [(5000, 12000, 3e-4),
                                        (3, 40, 1e-2),    # warming up
                                        (4096, 12000, 1e-3)])
def test_pn_ber_matches_jax(bs, n, alpha):
    rng = np.random.default_rng(bs)
    rx = pn_stream(rng, n, 0.01).astype(np.uint8)
    blocks, counts = split(rx, bs)
    jb, tb = jf.PNBERv(7, 0x60, alpha), tf.PNBERv(7, 0x60, alpha,
                                                  device="cpu")
    js = jax.tree_util.tree_map(jnp.asarray, jb.init_state())
    ts = tb.init_state()
    from grbaz_tpu.core.stream import Stream as JStream
    from grbaz_tpu_torch.core.stream import Stream as TStream
    worst = 0.0
    for x, c in zip(blocks, counts):
        js, (jo,) = jb.apply(js, None, JStream.full(jnp.asarray(x)))
        ts, (to,) = tb.apply(ts, None, TStream.full(torch.from_numpy(x)))
        worst = max(worst, float(np.abs(np.asarray(jo.data)
                                        - to.data.numpy()).max()))
        assert int(js["reg"]) == int(ts["reg"])
        assert int(js["warm"]) == int(ts["warm"])
        assert abs(float(js["ber"]) - float(ts["ber"])) <= 1e-6
    assert worst <= 1e-6


def test_pn_ber_estimator():
    # tests/test_decode_fec.py:139-157 on the port
    rng = np.random.default_rng(7)
    rx = pn_stream(rng, 50000, 0.01).astype(np.uint8)
    tester = tf.PNBERv(degree=7, mask=0x60, alpha=3e-4, device="cpu")
    from grbaz_tpu_torch.core.stream import Stream as TStream
    st = tester.init_state()
    for i in range(0, 50000, 10000):
        st, (o,) = tester.apply(st, None, TStream.full(torch.from_numpy(
            rx[i:i + 10000])))
    assert 0.01 < float(o.data[-1]) < 0.06


@pytest.mark.parametrize("blk,args", [("PNBERv", ()), ("ViterbiDecoder", ()),
                                      ("GLFSRSource", (32, 16)),
                                      ("AdditiveScrambler", ()),
                                      ("Puncture", ([1, 0, 1],))])
def test_fec_states_carry_across_packages(blk, args):
    jb = getattr(jf, blk)(*args)
    tb = getattr(tf, blk)(*args, device="cpu")
    st = states_from_numpy(jb.init_state(), device="cpu")
    for k, v in tb.init_state().items():
        assert st[k].dtype == v.dtype and torch.equal(st[k], v), k
    back = to_numpy(tb.init_state())
    for k, v in jb.init_state().items():
        assert back[k].dtype == np.asarray(v).dtype and same(back[k], v), k


def test_viterbi_decoder_without_overlap_carries_the_whole_block():
    # the reference's bits[0:] and ext[-0:]: blocks of N, 2N and 3N bits
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, 3 * 64).astype(np.uint8)
    soft = (jf.conv_encode(bits).astype(np.float32) * 2 - 1
            + 0.3 * rng.standard_normal((3 * 64, 2))).astype(np.float32)
    blocks, counts = split(soft, 64)
    outs = step_both(jf.ViterbiDecoder(overlap=0),
                     tf.ViterbiDecoder(overlap=0, device="cpu"),
                     blocks, counts)
    assert [o[0].data.shape[0] for o in outs] == [64, 128, 192]
