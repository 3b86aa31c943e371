"""Block protocol (port of ``grbaz_tpu/core/block.py``).

A block is a function over tensors

    ``apply(state, params, *in_streams) -> (state', out_streams)``

with explicit carried state (filter tails, phase accumulators) and a
separate ``params`` dict of runtime-settable control values, so the host
can retune a running graph between blocks of samples. State and params
are dicts of tensors on the block's device. Blocks never loop over
samples in Python: each works on a whole sample block at once.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Tuple

from grbaz_tpu_torch.core.stream import Stream

_uid = itertools.count()


class Block:
    """Base class for flowgraph blocks.

    Subclasses set ``n_in`` / ``n_out`` and implement :meth:`apply`.
    ``init_state`` / ``init_params`` return dicts of tensors (``None``
    for stateless / parameterless blocks).
    """

    n_in: int = 1
    n_out: int = 1

    def __init__(self, name: str | None = None):
        # an explicit name is the handle the control plane retunes
        # through (``executor.params[name]``); auto-names get a uid
        self.name = name if name else f"{type(self).__name__}_{next(_uid)}"

    def init_state(self) -> Any:
        return None

    def init_params(self) -> Any:
        return None

    def apply(self, state: Any, params: Any,
              *ins: Stream) -> Tuple[Any, Tuple[Stream, ...]]:
        raise NotImplementedError

    def __call__(self, *ins: Stream) -> Tuple[Any, Tuple[Stream, ...]]:
        """One-shot application with fresh state."""
        return self.apply(self.init_state(), self.init_params(), *ins)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} {self.n_in}->{self.n_out}>"


class FnBlock(Block):
    """Stateless block wrapping a pure ``fn(*datas) -> data``."""

    def __init__(self, fn: Callable, n_in: int = 1, n_out: int = 1,
                 name: str | None = None, rate_scale: float = 1.0):
        if name is None:
            name = f"{getattr(fn, '__name__', 'fn')}_{next(_uid)}"
        super().__init__(name)
        self.fn = fn
        self.n_in = n_in
        self.n_out = n_out
        self.rate_scale = rate_scale

    def apply(self, state, params, *ins: Stream):
        outs = self.fn(*(s.data for s in ins))
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        ref = ins[0]
        return state, tuple(
            ref.like(o, count=ref.count, rate_scale=self.rate_scale)
            for o in outs)


def block_from_fn(fn: Callable = None, *, n_in: int = 1, n_out: int = 1,
                  name: str | None = None) -> Callable[..., FnBlock]:
    """Decorator: turn a pure tensor function into a Block factory.

    >>> @block_from_fn
    ... def conjugate(x):
    ...     return torch.conj(x)
    >>> blk = conjugate()          # a fresh FnBlock instance
    """

    def wrap(f):
        def make(*args, **kwargs):
            g = f
            if args or kwargs:
                def g(*datas):
                    return f(*datas, *args, **kwargs)
                g.__name__ = f.__name__
            return FnBlock(g, n_in=n_in, n_out=n_out, name=name or f.__name__)
        make.__name__ = f.__name__
        make.__doc__ = f.__doc__
        return make

    return wrap(fn) if fn is not None else wrap
