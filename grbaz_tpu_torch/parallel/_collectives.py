"""The JAX package's mesh collectives over one dim of a ``DeviceMesh``.

Where the JAX package runs a ``shard_map`` body on every device of a
``Mesh``, the port runs the same body on every rank of a
``torch.distributed.device_mesh.DeviceMesh`` with the same dim names,
each rank holding its own shard. The collectives of those bodies, over
one dim's process group (``mesh.get_group(name)``):

* :func:`psum` -- ``lax.psum``: ``all_reduce(SUM)``;
* :func:`replicate` -- the JAX package's masked ``psum`` that hands the
  owner device's copy to every device of the dim: a ``broadcast`` from
  the owner rank (equal wherever the other ranks hold finite values);
* :func:`ppermute` -- ``lax.ppermute`` over ``(source, destination)``
  pairs of the dim's ranks: one send and one receive a rank; a rank that
  no pair sends to receives zeros.

Each waits for its work before it returns. In a group of one rank each
is the identity and posts no communication (the one-rank cyclic pair
``(0, 0)`` hands the rank its own tensor). Complex tensors travel as
their real view, bools as int32; uint32 values are int64 already
(``core.device``).

:func:`all_gather` stacks a dim's shards for host-side assembly, and
:func:`shard` cuts a rank's shard out of a global tensor, as JAX's
shardings place it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from grbaz_tpu_torch.core.device import resolve_device


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: its card for a
    ``"cuda"`` mesh (raising where there is none), else the CPU."""
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def dim(mesh: DeviceMesh, name: str) -> Tuple[dist.ProcessGroup, int, int]:
    """(process group, this rank's index, size) of the mesh dim ``name``."""
    group = mesh.get_group(name)
    return group, dist.get_rank(group), dist.get_world_size(group)


def shard(t: torch.Tensor, mesh: DeviceMesh, name: str,
          axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``axis`` when ``axis``
    is split evenly over the mesh dim ``name`` (JAX's ``P(name)``)."""
    _, idx, size = dim(mesh, name)
    n = t.shape[axis]
    if n % size:
        raise ValueError(f"dim {axis} of size {n} does not split over "
                         f"{size} ranks of '{name}'")
    return t.narrow(axis, idx * (n // size), n // size)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` in a dtype every backend carries."""
    if t.is_complex():
        return torch.view_as_real(t.contiguous()).clone()
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    return t.contiguous().clone()


def _unwire(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype.is_complex:
        return torch.view_as_complex(w)
    return w.to(dtype)


def psum(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, on every rank."""
    if dist.get_world_size(group) == 1:
        return t
    w = _wire(t)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return _unwire(w, t.dtype)


def replicate(t: torch.Tensor, owner: int,
              group: dist.ProcessGroup) -> torch.Tensor:
    """The group rank ``owner``'s ``t`` on every rank (each rank passes a
    tensor of the same shape and dtype)."""
    if dist.get_world_size(group) == 1:
        return t
    w = _wire(t)
    dist.broadcast(w, src=dist.get_global_rank(group, owner), group=group)
    return _unwire(w, t.dtype)


def ppermute(t: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group: dist.ProcessGroup) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` of group ranks, rank
    ``dst`` gets rank ``src``'s ``t``; a rank that is no pair's ``dst``
    gets zeros. Every rank passes the same ``perm``."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if src == [me]:             # the one-rank cycle: the rank's own tensor
        return t
    w = _wire(t)
    got = torch.zeros_like(w)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, w,
                              dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, src[0]), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _unwire(got, t.dtype)


def all_gather(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The group's ``t`` stacked in rank order: [size, *t.shape]."""
    size = dist.get_world_size(group)
    if size == 1:
        return t[None]
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(size)]
    dist.all_gather(parts, w, group=group)
    return _unwire(torch.stack(parts), t.dtype)
