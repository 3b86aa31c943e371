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


def _inputs(d):
    """One block's inputs: an array, or a tuple of arrays for a block with
    several inputs."""
    return d if isinstance(d, tuple) else (d,)


def jax_run(block, datas, counts=None, state=None, params=None, rate=1.0,
            fn=None, abs_index=None):
    """Outputs ``[[(data, count) per port] per block]`` and the final state
    of a JAX block (``fn``: another apply, e.g. a serial mirror). Each
    entry of ``datas`` (and of ``counts``) is one input's block or a tuple
    of the inputs' blocks. With ``abs_index`` the stream meta starts
    there and advances by each block's capacity (else every block starts
    at 0)."""
    from grbaz_tpu.core.stream import StreamMeta as JMeta
    if state is None:
        state = jax.tree_util.tree_map(jnp.asarray, block.init_state())
    params = block.init_params() if params is None else params
    fn = fn or block.apply
    meta = JMeta.start(rate, abs_index=abs_index or 0)
    outs = []
    for i, d in enumerate(datas):
        ins = _inputs(d)
        cs = [len(a) for a in ins] if counts is None else _inputs(counts[i])
        cs = list(cs) * len(ins) if len(cs) == 1 else cs
        streams = [JStream(jnp.asarray(a), jnp.int32(c), meta)
                   for a, c in zip(ins, cs)]
        state, o = fn(state, params, *streams)
        outs.append([(np.asarray(y.data), int(y.count)) for y in o])
        if abs_index is not None:
            meta = meta.advanced(len(ins[0]))
    return outs, state


def port_run(block, datas, counts=None, state=None, params=None, rate=1.0,
             abs_index=None):
    """:func:`jax_run` for a port block on the CPU."""
    from grbaz_tpu_torch.core.stream import StreamMeta as TMeta
    state = block.init_state() if state is None else state
    params = block.init_params() if params is None else params
    meta = TMeta.start(rate, abs_index=abs_index or 0, device="cpu")
    outs = []
    for i, d in enumerate(datas):
        ins = _inputs(d)
        cs = [len(a) for a in ins] if counts is None else _inputs(counts[i])
        cs = list(cs) * len(ins) if len(cs) == 1 else cs
        streams = [TStream(torch.from_numpy(np.ascontiguousarray(a)),
                           torch.tensor(c, dtype=torch.int32), meta)
                   for a, c in zip(ins, cs)]
        state, o = block.apply(state, params, *streams)
        outs.append([(y.data.numpy(), int(y.count)) for y in o])
        if abs_index is not None:
            meta = meta.advanced(len(ins[0]))
    return outs, state


def valid(outs, port=0):
    """The valid samples of one port, concatenated over blocks."""
    return np.concatenate([o[port][0][:o[port][1]] for o in outs])
