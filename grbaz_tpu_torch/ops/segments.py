"""Block-parallel segment machinery for threshold FSMs (port of
``grbaz_tpu/ops/segments.py``).

The detector FSMs decompose into a threshold mask, segment structure
(the position of the most recent edge: a running max) and per-segment
reductions (max, first position of the max, sum over each segment's
prefix). Each is an O(n) pass of whole-tensor ops:

* running last / next true index: a running max / min over int32
  positions (:func:`running_max`);
* segmented max with its first position: a 64-bit key ``seg_id << 32 |
  u32(value)``, with ``seg_id`` the count of resets so far and ``u32`` an
  order-preserving map of the float32 or int32 value, so the running max
  of the key is the running max of the current segment. A sample takes the
  position when it is a reset or its key is strictly above the running
  max before it (ties keep the earlier position), and the first position
  is the running max of the taken indices;
* segmented sum: an inclusive float64 cumsum less its value before the
  segment's start.

The JAX package runs the same reductions as two-level [n/128, 128]
associative scans, a layout for the TPU's lanes. Positions and maxima
equal its results bit for bit (values are not NaN); the sum takes
another order and agrees to float32 rounding.

:func:`running_max` is ``torch.cummax`` on rows of 1024: on a CUDA card
``torch.cummax`` scans each row of its innermost dimension in one thread
block, so over one 2^20-sample row it took 2.85 ms on an H100 (PERF.md),
where rows scanned side by side and a running max of the row maxima do
the same.
"""

from __future__ import annotations

import torch

# sentinel "no position yet" for running-maximum position tracking;
# INT32_MIN/2 keeps +offset arithmetic overflow-free
NO_POS = -(2 ** 30)


_ROW = 1024


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def running_max(v: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D integer tensor (exact)."""
    n = v.shape[0]
    if n <= _ROW:
        return torch.cummax(v, 0).values
    rows = -(-n // _ROW)
    low = torch.iinfo(v.dtype).min
    if rows * _ROW > n:
        v = torch.cat([v, v.new_full((rows * _ROW - n,), low)])
    r = torch.cummax(v.reshape(rows, _ROW), 1).values
    carry = running_max(r[:, -1])
    carry = torch.cat([carry.new_full((1,), low), carry[:-1]])
    return torch.maximum(r, carry[:, None]).reshape(-1)[:n]


def running_last_true(mask: torch.Tensor, idx: torch.Tensor,
                      seed) -> torch.Tensor:
    """Position of the most recent True at or before each sample.

    ``idx`` supplies the position recorded where ``mask`` is set
    (typically a global sample index); ``seed`` is the carried position
    from earlier blocks (NO_POS for none). int32 [n]."""
    v = torch.where(mask, idx.to(torch.int32), NO_POS)
    if v.numel() == 0:
        return v
    return torch.maximum(running_max(v), torch.as_tensor(
        seed, dtype=torch.int32, device=v.device))


def _order_key(values: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) that orders as ``values`` (float32 or int32);
    -0.0 and +0.0 map to one key."""
    if values.is_floating_point():
        b = (values.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
        return torch.where(b >= 0, b + 2 ** 31, -1 - b)
    return values.to(torch.int64) + 2 ** 31


def _seg_argmax(reset: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of each segment prefix (segments start
    at ``reset`` samples; the samples before the first reset form one
    more segment that starts from the unit, -inf or NO_POS), or -1 where
    that prefix holds no value above the unit. int64 [n]."""
    n = values.shape[0]
    unit = float("-inf") if values.is_floating_point() else NO_POS
    seg = torch.cumsum(reset.to(torch.int64), 0)
    key = (seg << 32) | _order_key(values)
    run = running_max(key)
    unit_key = _order_key(torch.full((1,), unit, dtype=values.dtype,
                                     device=values.device))
    before = torch.cat([unit_key, run[:-1]])
    i = _arange(n, values)
    takes = reset | (key > before)
    return running_max(torch.where(takes, i, -1))


def _gather(x: torch.Tensor, at: torch.Tensor, fill) -> torch.Tensor:
    got = x.index_select(0, torch.clamp(at, min=0))
    return torch.where(at >= 0, got, torch.full_like(got, fill))


def seg_prefix_sum(reset: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix sum: out[i] = sum of ``values`` from the
    most recent ``reset`` at or before i, through i. float32 [n]."""
    n = values.shape[0]
    if n == 0:
        return values.to(torch.float32)
    cs = torch.cumsum(values.to(torch.float64), 0)
    before = torch.cat([cs.new_zeros(1), cs[:-1]])
    # the segment's first sample (0 before the first reset, where the
    # exclusive sum is 0)
    start = running_max(torch.where(reset, _arange(n, values), 0))
    return (cs - before.index_select(0, start)).to(torch.float32)


def seg_prefix_max(reset: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix max (no position tracking)."""
    if values.shape[0] == 0:
        return values
    unit = float("-inf") if values.is_floating_point() else NO_POS
    return _gather(values, _seg_argmax(reset, values), unit)


def seg_prefix_maxpos(reset: torch.Tensor, values: torch.Tensor,
                      positions: torch.Tensor) -> tuple:
    """Segmented inclusive prefix max with the position of its *first*
    occurrence (ties keep the earlier position, as the reference FSMs
    update their peak only on strictly greater samples). ``positions``
    is any int32 payload, gathered at that first position; NO_POS where
    no value is above the unit yet."""
    if values.shape[0] == 0:
        return values, positions.to(torch.int32)
    unit = float("-inf") if values.is_floating_point() else NO_POS
    at = _seg_argmax(reset, values)
    return (_gather(values, at, unit),
            _gather(positions.to(torch.int32), at, NO_POS))


def shift_in(first: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``concat([first], x[:-1])``: each sample's predecessor, the carried
    ``first`` before sample 0."""
    return torch.cat([first.reshape(1).to(x.dtype), x[:-1]])


def orbit(jump: torch.Tensor, start: torch.Tensor, steps: int) -> torch.Tensor:
    """``[start, J(start), J(J(start)), ...]``, ``steps`` positions (a
    power of two) of the jump table ``J = jump`` (int, values in
    ``[0, len(jump))``), int64 [steps].

    Pointer doubling: each pass appends ``J^k`` of the k positions found
    so far, then squares the table, so ``steps`` positions take
    log2(steps) gathers of the positions and one fewer of the table --
    the event-level scans of the JAX package (a ``lax.scan`` of
    ``steps`` jumps) without a loop of ``steps`` gathers."""
    pos = start.reshape(1).to(torch.int64)
    table = jump.to(torch.int64)
    while pos.shape[0] < steps:
        pos = torch.cat([pos, table.index_select(0, pos)])
        if pos.shape[0] < steps:
            table = table.index_select(0, table)
    return pos


def next_true_index(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Index of the first True at or after each sample (``fill`` when none
    remain): a reverse running minimum. int32 [n]."""
    n = mask.shape[0]
    v = torch.where(mask, torch.arange(n, dtype=torch.int32,
                                       device=mask.device), fill)
    if n == 0:
        return v
    # a reverse running min: -running_max(-v) over the reversed samples
    return -torch.flip(running_max(-torch.flip(v, (0,))), (0,))
