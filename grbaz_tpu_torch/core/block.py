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


class AnyBlock(Block):
    """A user-supplied function as a graph node, the "any block" escape
    hatch (``baz_any_source``/``sink``/``block`` and ``baz_any_code`` let
    users type raw code into GRC; here the user supplies the function).

    ``fn(state, params, *ins) -> (state', Stream | (Stream, ...))`` runs
    inside the graph step like any built-in block; ``init_state`` and
    ``init_params`` are values or zero-argument callables.
    """

    def __init__(self, fn: Callable, init_state=None, init_params=None,
                 n_in: int = 1, n_out: int = 1, name: str | None = None):
        super().__init__(name or getattr(fn, "__name__", "any"))
        self.fn = fn
        self._init_state = init_state
        self._init_params = init_params
        self.n_in = n_in
        self.n_out = n_out

    def init_state(self):
        s = self._init_state
        return s() if callable(s) else s

    def init_params(self):
        p = self._init_params
        return p() if callable(p) else p

    def apply(self, state, params, *ins: Stream):
        state, outs = self.fn(state, params, *ins)
        if isinstance(outs, Stream):
            outs = (outs,)
        return state, tuple(outs)


def any_code(source: str, n_in: int = 1, n_out: int = 1,
             name: str | None = None) -> Block:
    """A block from a source string (the ``baz_any_code`` capability), in
    the reference's two modes:

    * an *expression* over ``x`` (and ``x0``, ``x1``, ...) becomes a
      stateless element-wise block: ``any_code("torch.abs(x) ** 2")``;
    * a *code block* defining ``apply(state, params, *ins)`` and
      optionally ``init_state()`` / ``init_params()`` becomes an
      :class:`AnyBlock`.

    The namespace holds ``torch``, ``np`` and ``Stream`` (the JAX
    package's holds ``jax`` and ``jnp`` in torch's place).
    """
    import numpy as np
    import torch

    ns = {"torch": torch, "np": np, "Stream": Stream}
    try:
        code = compile(source, "<any_code>", "eval")
        is_expr = True
    except SyntaxError:
        code = compile(source, "<any_code>", "exec")
        is_expr = False

    if is_expr:
        def fn(*datas):
            local = dict(ns, x=datas[0])
            local.update((f"x{i}", d) for i, d in enumerate(datas))
            return eval(code, local)  # noqa: S307 - the escape hatch
        fn.__name__ = name or "any_code"
        return FnBlock(fn, n_in=n_in, n_out=n_out, name=name)

    exec(code, ns)  # noqa: S102 - the escape hatch
    if "apply" not in ns:
        raise ValueError("any_code source must define "
                         "apply(state, params, *ins)")
    return AnyBlock(ns["apply"], init_state=ns.get("init_state"),
                    init_params=ns.get("init_params"), n_in=n_in,
                    n_out=n_out, name=name or "any_code")
