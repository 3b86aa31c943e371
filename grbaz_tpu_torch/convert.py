"""Carry JAX-package params and states into the port, and back.

A ``grbaz_tpu`` block's ``init_params()`` / ``init_states()`` is a dict
tree of numpy scalars and arrays. :func:`params_from_numpy` and
:func:`states_from_numpy` turn such a tree into the port's tensors:

* uint32 becomes int64 holding the same value (the port's uint32
  convention, see ``core.device``);
* every other dtype (complex64, float32, int32, ...) is kept;
* tensors already in the tree are moved to ``device``; ``None`` stays.

:func:`to_numpy` is the reverse: int64 tensors go back to uint32, which
is lossless because the port uses int64 tensors only for uint32 values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from grbaz_tpu_torch.core.device import U32_MASK, resolve_device


def _leaf_to_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64) & U32_MASK
    return torch.from_numpy(np.array(arr)).to(device)


def _map(tree: Any, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """A JAX block's (or flowgraph's) params tree as tensors on ``device``."""
    dev = resolve_device(device)
    return _map(tree, lambda x: _leaf_to_tensor(x, dev))


def states_from_numpy(tree: Any, device="cuda") -> Any:
    """A JAX block's (or flowgraph's) state tree as tensors on ``device``
    (the same conversion as :func:`params_from_numpy`)."""
    return params_from_numpy(tree, device)


def _leaf_to_numpy(x):
    if not isinstance(x, torch.Tensor):
        return x
    arr = x.detach().cpu().numpy()
    if arr.dtype == np.int64:
        return arr.astype(np.uint32)
    return arr


def to_numpy(tree: Any) -> Any:
    """The port's tensor tree as numpy, int64 (uint32 carriers) -> uint32."""
    return _map(tree, _leaf_to_numpy)
