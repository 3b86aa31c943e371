"""Plain reference of the LRPT auto-FEC deployment (``configs/lrpt.json``).

From the raw ring alone it computes what the auto-FEC stream owes for
block j: the transform of [carry, block], the carry being the last
``overlap + 1`` symbols of the block before (zeros before block 0); the
Viterbi decode of the ``overlap + N`` soft pairs from state 0; the bits
of the block; the BER of the re-encoded bits against the hard slice; and
the search state after the block, which sets the next block's transform.

* The transform t (0-31): bits 0-1 the rotation r, bit 2 the
  conjugation, bit 3 the pair delay, bit 4 the swap. A symbol is
  conjugated, multiplied by 1j^r and split into the pair (real, imag),
  swapped with the swap. With the pair delay, pair i is the second code
  bit of symbol i - 1 and the first of symbol i.
* The Viterbi runs in float32, in the order of operations of the JAX
  package's scan: branch metrics ``e0*r0 + e1*r1``, candidates
  ``pm[prev] + bm``, the second predecessor only where strictly greater,
  every step less its max; traceback from the first best final state.
  This departs from a float64 judge on purpose: a Viterbi's outputs are
  comparisons, so a wider type would decide near-ties otherwise. The
  program runs the same float32 arithmetic and is held to it exactly.
* The BER: the decoded bits re-encoded from the zero state at the
  warm-up's start, against the hard slice of the block's pairs, all but
  the last 16; the count times the float32 reciprocal of the code bits.
* The search, from (transform 0, searching, count 0): searching, a BER
  below the threshold counts a block and locks at ``settle``, any other
  steps the transform; locked, a BER above ``4 threshold + 0.2``
  unlocks. The BER is compared as a Python float. The state is reported
  packed: transform | locked << 5 | count << 6.

A block's outputs depend on its transform, its ring position and whether
it is block 0 alone. So every (stream, transform, position) is decoded
once, in one forward pass batched over all of them, and the search runs
from block 0 over that table until the stream is periodic: locked, and a
whole ring of blocks since kept the lock. A later block is answered from
its image in that ring. :func:`replay` is the same stream decoded block
by block, for the tests. Mode ``"f64"`` is that float32 decode;
``"tf32"``, the control, rounds the soft pairs to TF32 first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radiobench.reference import dsp

N_TRANSFORMS = 32
ROTATIONS = (1, 1j, -1, -1j)
EVAL_TAIL = 16          # the last pairs the BER leaves out
CHUNK = 64              # steps of the forward pass a branch-metric chunk


def trellis(k: int, polys) -> torch.Tensor:
    """[2^(k-1), 2, 2] float32 +-1: the code pair the branch from state
    s's predecessor i (2s + i mod 2^(k-1)) into s expects; the register
    of that branch is 2s + i, the newest bit at its MSB."""
    ns = 1 << (k - 1)
    out = np.zeros((ns, 2, 2), np.float32)
    for s in range(ns):
        for i in range(2):
            for p, poly in enumerate(polys):
                out[s, i, p] = 2.0 * (bin((2 * s + i) & poly).count("1")
                                      % 2) - 1.0
    return torch.from_numpy(out)


def encode(bits: torch.Tensor, k: int, polys) -> torch.Tensor:
    """The rate-1/2 encoder over ``bits`` [..., T] from the zero state:
    [..., T, 2] bool code bits."""
    b = bits.to(torch.int64)
    reg = torch.zeros_like(b)
    for m in range(k):  # bit i - m sits at register bit k - 1 - m
        reg |= torch.nn.functional.pad(b, (m, 0))[..., :b.shape[-1]] \
            << (k - 1 - m)
    code = []
    for poly in polys:
        v, par = reg & poly, torch.zeros_like(reg)
        for i in range(k):
            par ^= (v >> i) & 1
        code.append(par == 1)
    return torch.stack(code, -1)


def transform(raw: torch.Tensor, t: int) -> torch.Tensor:
    """Soft pairs [..., M - 1, 2] float32 of the raw symbols [..., M]
    under transform t: the pairs of symbols 1 .. M - 1 (with the delay,
    each takes its first code bit from the symbol before)."""
    s = raw.conj() if t & 4 else raw
    s = s * ROTATIONS[t & 3]
    soft = torch.stack([s.real, s.imag], -1)
    if t & 16:
        soft = soft.flip(-1)
    if t & 8:
        flat = soft.reshape(*soft.shape[:-2], -1)
        return flat[..., 1:-1].reshape(*soft.shape[:-2], -1, 2)
    return soft[..., 1:, :]


def viterbi(soft: torch.Tensor, exp: torch.Tensor):
    """Decode a batch of soft pairs [B, T, 2] float32, each from state 0:
    (bits [B, T] uint8, final path metrics [B, ns] float32)."""
    nb, t_len = soft.shape[:2]
    ns = exp.shape[0]
    dev = soft.device
    st = torch.arange(ns, device=dev)
    prev = torch.stack([(2 * st) % ns, (2 * st + 1) % ns], 1).reshape(-1)
    e0 = exp[:, :, 0].reshape(-1).to(dev)
    e1 = exp[:, :, 1].reshape(-1).to(dev)
    pm = torch.full((nb, ns), -1e9, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    # the decisions, eight states a byte
    dec = torch.empty((t_len, nb, ns // 8), dtype=torch.uint8, device=dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    for c0 in range(0, t_len, CHUNK):
        r = soft[:, c0:c0 + CHUNK].transpose(0, 1)
        bm = e0 * r[..., :1] + e1 * r[..., 1:]          # [C, B, 2 ns]
        take = torch.empty((r.shape[0], nb, ns), dtype=torch.bool,
                           device=dev)
        for i in range(r.shape[0]):
            cand = (pm.index_select(1, prev) + bm[i]).view(nb, ns, 2)
            take[i] = cand[..., 1] > cand[..., 0]
            new = torch.where(take[i], cand[..., 1], cand[..., 0])
            pm = new - new.amax(1, keepdim=True)
        dec[c0:c0 + r.shape[0]] = (
            take.view(r.shape[0], nb, ns // 8, 8).to(torch.uint8)
            << shifts).sum(-1, dtype=torch.uint8)
    bits = torch.empty((nb, t_len), dtype=torch.uint8, device=dev)
    rows = torch.arange(nb, device=dev)
    s = pm.argmax(1)
    msb, half = ns.bit_length() - 2, ns // 2
    for t in range(t_len - 1, -1, -1):
        bits[:, t] = s >> msb
        s = 2 * (s % half) + ((dec[t, rows, s >> 3] >> (s & 7)) & 1)
    return bits, pm


def ber(bits: torch.Tensor, soft: torch.Tensor, overlap: int, k: int,
        polys) -> np.ndarray:
    """[B] float32: each decode's BER over its block's pairs (those after
    the warm-up's ``overlap``), all but the last 16."""
    n_eval = soft.shape[1] - overlap - EVAL_TAIL
    out = np.empty(soft.shape[0], np.float32)
    for b0 in range(0, soft.shape[0], 256):
        code = encode(bits[b0:b0 + 256], k, polys)[:, overlap:
                                                   overlap + n_eval]
        hard = soft[b0:b0 + 256, overlap:overlap + n_eval] > 0
        out[b0:b0 + 256] = (code != hard).sum((1, 2)).cpu().numpy()
    return out * (np.float32(1) / np.float32(2 * n_eval))


def search(state: tuple, ber_value: float, threshold: float, settle: int):
    """The search state (transform, locked, count) after a block."""
    t, locked, good = state
    if not locked:
        if ber_value < threshold:
            return t, good + 1 >= settle, good + 1
        return (t + 1) % N_TRANSFORMS, False, 0
    if ber_value > 4 * threshold + 0.2:
        return t, False, 0
    return state


def pack(state: tuple) -> int:
    t, locked, good = state
    return t | int(locked) << 5 | good << 6


def _soft(raw: torch.Tensor, t: int, mode: str) -> torch.Tensor:
    soft = transform(raw, t)
    return dsp.tf32(soft) if mode == "tf32" else soft.contiguous()


class Table:
    """Every (stream, transform, ring position) of a ring [streams,
    blocks, N] decoded once, and each stream's search run over them.
    Position ``blocks`` is block 0, its carry zeros."""

    def __init__(self, cfg: dict, whole: np.ndarray, mode: str, device):
        self.cfg = cfg
        k, polys, ov = cfg["k"], cfg["polys"], cfg["overlap"]
        x = torch.from_numpy(np.ascontiguousarray(whole)).to(device)
        n_s, n_b, n = x.shape
        self.blocks, self.n = n_b, n
        tails = torch.roll(x, 1, 1)[..., n - ov - 1:]
        raw = torch.cat([torch.cat([tails, torch.zeros_like(tails[:, :1])], 1),
                         torch.cat([x, x[:, :1]], 1)], 2)   # [S, P, ov+1+N]
        del x, tails
        soft = torch.stack([_soft(raw, t, mode)
                            for t in range(N_TRANSFORMS)], 1)
        del raw
        shape = soft.shape[:3]                               # (S, 32, P)
        soft = soft.reshape(-1, ov + n, 2)
        bits, pm = viterbi(soft, trellis(k, polys))
        self.ber = ber(bits, soft, ov, k, polys).reshape(shape)
        del soft
        self.bits = bits[:, ov:].reshape(*shape, n)
        self.pm = pm.reshape(*shape, -1).cpu().numpy()
        # per stream: the state after each block walked, the (transform,
        # position) it used, and where its period starts (None: not yet)
        self.after = [[] for _ in range(n_s)]
        self.used = [[] for _ in range(n_s)]
        self.kept = [0] * n_s
        self.period = [None] * n_s

    def _walk(self, k: int):
        """Run stream k's search over one more block."""
        after, used = self.after[k], self.used[k]
        j = len(after)
        state = after[-1] if after else (0, False, 0)
        p = self.blocks if j == 0 else j % self.blocks
        nxt = search(state, float(self.ber[k, state[0], p]),
                     self.cfg["threshold"], self.cfg["settle"])
        used.append((state[0], p))
        after.append(nxt)
        # periodic once a ring of blocks (past block 0) entered and left
        # in the same locked state
        self.kept[k] = self.kept[k] + 1 if (j and state[1]
                                             and nxt == state) else 0
        if self.kept[k] == self.blocks:
            self.period[k] = j - self.blocks + 1

    def image(self, k: int, j: int) -> int:
        """The block whose outputs stream k's block j repeats."""
        while self.period[k] is None and len(self.after[k]) <= j:
            self._walk(k)
        j0 = self.period[k]
        return j if j0 is None or j < j0 else j0 + (j - j0) % self.blocks

    def outputs(self, k: int, j: int) -> dict:
        j = self.image(k, j)
        t, p = self.used[k][j]
        return dict(pm=self.pm[k, t, p],
                    bits=self.bits[k, t, p].cpu().numpy(),
                    ber=self.ber[k, t, p:p + 1],
                    state=np.array([pack(self.after[k][j])], np.int32))


# The table of the ring the harness holds, a mode each, beside the ring
# (held, so that its id stays its own): the harness asks for one
# stream's blocks at a time, and the decode is batched over all streams.
_TABLES = {}


def _whole(ring: np.ndarray):
    """(the [streams, blocks, N] array that ``ring`` is a row of, the
    row). The harness hands the reference a row of its ring; anything
    else (a copy, say) is refused, since a table of one stream's ring
    would decode every stream again, one at a time."""
    base = ring.base
    if (isinstance(base, np.ndarray) and base.ndim == 3
            and base.shape[1:] == ring.shape and base.dtype == ring.dtype
            and base.strides[1:] == ring.strides):
        off = (ring.__array_interface__["data"][0]
               - base.__array_interface__["data"][0])
        k, rem = divmod(off, base.strides[0])
        if rem == 0 and 0 <= k < base.shape[0]:
            return base, k
    raise ValueError("the lrpt reference takes a row of a [streams, blocks, "
                     f"N] ring, not an array of shape {ring.shape} that is "
                     "no such row")


def table(cfg: dict, ring: np.ndarray, mode: str, device):
    """(the Table of ``ring``'s whole ring in ``mode``, the stream)."""
    whole, k = _whole(ring)
    key = (id(whole), mode, str(device))
    held, tab = _TABLES.get(key, (None, None))
    if held is not whole or tab.cfg != cfg:
        for other in [q for q, v in _TABLES.items() if v[0] is not whole]:
            del _TABLES[other]
        tab = Table(cfg, whole, mode, device)
        _TABLES[key] = (whole, tab)
    return tab, k


def outputs(cfg: dict, ring: np.ndarray, j: int, mode: str,
            device) -> dict:
    """Block j of a stream whose block i is ``ring[i % len(ring)]``:
    {port: outputs}."""
    tab, k = table(cfg, ring, mode, device)
    return tab.outputs(k, j)


def replay(cfg: dict, ring: np.ndarray, blocks: int, mode: str,
           device) -> list:
    """Blocks 0 .. ``blocks`` - 1 of one stream, each decoded alone in
    turn from the raw symbols, the search carried from block to block."""
    k, polys, ov = cfg["k"], cfg["polys"], cfg["overlap"]
    exp = trellis(k, polys)
    carry = np.zeros(ov + 1, np.complex64)
    state, out = (0, False, 0), []
    for j in range(blocks):
        x = ring[j % len(ring)]
        raw = torch.from_numpy(np.concatenate([carry, x])).to(device)
        soft = _soft(raw, state[0], mode)[None]
        bits, pm = viterbi(soft, exp)
        b = ber(bits, soft, ov, k, polys)
        state = search(state, float(b[0]), cfg["threshold"], cfg["settle"])
        out.append(dict(pm=pm[0].cpu().numpy(),
                        bits=bits[0, ov:].cpu().numpy(), ber=b,
                        state=np.array([pack(state)], np.int32)))
        carry = x[len(x) - ov - 1:]
    return out


def _gap(got: np.ndarray, ref: np.ndarray, scale: float = None) -> float:
    """The widest difference over ``scale`` (the reference's largest
    magnitude where not given); inf where the lengths differ or a value
    is not finite."""
    if got.shape != ref.shape:
        return math.inf
    if scale is None:
        scale = float(np.abs(ref).max()) or 1.0
    gap = float(np.abs(got.astype(np.float64) - ref).max()) / scale
    return gap if math.isfinite(gap) else math.inf


def numbers(got: dict, ref: dict) -> dict:
    """The numbers compared for one block: ``got`` is {port: (data,
    count)} as the sinks received it."""
    counts_ok = all(got[p][1] == len(ref[p]) for p in ref)
    bits = got["bits"][0][:got["bits"][1]]
    return dict(
        pm_gap=_gap(got["pm"][0][:got["pm"][1]], ref["pm"]),
        bit_miss=int(np.count_nonzero(bits != ref["bits"]))
        if bits.shape == ref["bits"].shape else len(ref["bits"]),
        ber_gap=_gap(got["ber"][0][:got["ber"][1]], ref["ber"], 1.0),
        state_miss=int(not np.array_equal(got["state"][0][:got["state"][1]],
                                          ref["state"])),
        count_miss=0 if counts_ok else 1)


# Each number compared and its limit (PERF.md gives the readings): the
# program runs the reference's float32 arithmetic, so the bits, the BER,
# the search state and the counts must be equal. The path metrics are
# held to 1e-6 of their largest magnitude: equal on the card so far, and
# the TF32 control reads about 1e-3 there, since rounding the soft pairs
# moves every branch metric.
LIMITS = dict(pm_gap=1e-6, bit_miss=0, ber_gap=0, state_miss=0,
              count_miss=0, undelivered=0)
