"""Helpers of the port's parity tests: run a JAX block and its port over
the same numpy blocks (with validity counts) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from grbaz_tpu.core.stream import Stream as JStream
from grbaz_tpu_torch.core.stream import Stream as TStream


def split(x: np.ndarray, bs: int):
    """``x`` cut into blocks of ``bs`` samples, the last zero-padded to
    ``bs``: (blocks, counts)."""
    blocks, counts = [], []
    for i in range(0, len(x), bs):
        b = x[i:i + bs]
        counts.append(len(b))
        if len(b) < bs:
            b = np.concatenate([b, np.zeros((bs - len(b),) + b.shape[1:],
                                            b.dtype)])
        blocks.append(b)
    return blocks, counts


def jax_run(block, datas, counts=None, state=None, params=None, rate=1.0,
            fn=None):
    """Outputs ``[[(data, count) per port] per block]`` and the final state
    of a JAX block (``fn``: another apply, e.g. a serial mirror)."""
    if state is None:
        state = jax.tree_util.tree_map(jnp.asarray, block.init_state())
    params = block.init_params() if params is None else params
    fn = fn or block.apply
    outs = []
    for i, d in enumerate(datas):
        s = JStream.full(jnp.asarray(d), sample_rate=rate)
        if counts is not None:
            s = JStream(s.data, jnp.int32(counts[i]), s.meta)
        state, o = fn(state, params, s)
        outs.append([(np.asarray(y.data), int(y.count)) for y in o])
    return outs, state


def port_run(block, datas, counts=None, state=None, params=None, rate=1.0):
    """:func:`jax_run` for a port block on the CPU."""
    state = block.init_state() if state is None else state
    params = block.init_params() if params is None else params
    outs = []
    for i, d in enumerate(datas):
        s = TStream.full(torch.from_numpy(np.ascontiguousarray(d)),
                         sample_rate=rate)
        if counts is not None:
            s.count = torch.tensor(counts[i], dtype=torch.int32)
        state, o = block.apply(state, params, s)
        outs.append([(y.data.numpy(), int(y.count)) for y in o])
    return outs, state


def valid(outs, port=0):
    """The valid samples of one port, concatenated over blocks."""
    return np.concatenate([o[port][0][:o[port][1]] for o in outs])
