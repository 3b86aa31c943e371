"""Checkpoint / resume of flowgraph state (port of
``grbaz_tpu/core/checkpoint.py``).

States and params are dict/list trees of tensors, so a checkpoint is
exact: flatten with key paths, store as ``.npz``, restore with shape and
dtype validation against a template. The file layout is the JAX
package's, so a checkpoint written by either package loads in the other:

* keys ``state/<path>``, ``param/<path>`` and ``extra/<name>``, a path
  being the dict keys and list indices joined by ``/``, dict keys in
  sorted order (as ``jax.tree_util`` flattens them); ``None`` subtrees
  hold no leaves;
* uint32 values (int64 tensors in the port, see ``core.device``) are
  stored as uint32 through :func:`grbaz_tpu_torch.convert.to_numpy`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from grbaz_tpu_torch.convert import states_from_numpy, to_numpy


def _leaves(tree, path=()) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in the order ``jax.tree_util`` flattens."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield "/".join(str(p) for p in path), tree


def _rebuild(template, leaves: Iterator):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def save_state(path: str, states: Any, params: Any = None,
               extra: Dict[str, Any] = None):
    """Write states (+ optional params and scalar metadata) to .npz."""
    payload = {}
    for prefix, tree in (("state/", states), ("param/", params)):
        for k, leaf in _leaves(tree):
            payload[prefix + k] = np.asarray(to_numpy(leaf))
    for k, v in (extra or {}).items():
        payload["extra/" + k] = np.asarray(to_numpy(v))
    np.savez(path, **payload)


def load_state(path: str, states_template: Any, params_template: Any = None):
    """Restore ``(states, params, extra)`` shaped like the templates.

    Each leaf is checked against its template's shape and (numpy) dtype:
    a missing key raises ``KeyError``, a mismatch (changed topology or
    config) ``ValueError``. A tensor leaf comes back as a tensor on the
    template leaf's device, any other leaf as a numpy array.
    """
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def restore(template, prefix):
        out = []
        for key, leaf in _leaves(template):
            key = prefix + key
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            ref = np.asarray(to_numpy(leaf))
            if arr.shape != ref.shape or arr.dtype != ref.dtype:
                raise ValueError(
                    f"{key}: checkpoint {arr.dtype}{arr.shape} vs "
                    f"template {ref.dtype}{ref.shape}")
            out.append(states_from_numpy(arr, leaf.device)
                       if isinstance(leaf, torch.Tensor) else arr)
        return _rebuild(template, iter(out))

    states = restore(states_template, "state/")
    params = restore(params_template, "param/") \
        if params_template is not None else None
    extra = {k[len("extra/"):]: data[k] for k in data if k.startswith("extra/")}
    return states, params, extra
