"""MUSIC direction finding: covariance, signal subspace, pseudospectrum
(port of ``grbaz_tpu/ops/doa.py``).

Per group of ``navg`` snapshots of an M-antenna array:

    R = sum_i x_i x_i^H / navg            (covariance)
    G = noise subspace of R
    P(theta) = 1 / || G^H a(theta) ||^2   (pseudospectrum over steering
                                           vectors a)

and the top-n peak angles. Every function takes a batch of frames in its
leading dimensions; the JAX package's ``vmap`` over frames becomes that
batch.

The default method finds the signal subspace by orthogonal iteration on
``R^2`` until a residual test passes (a ``lax.while_loop`` whose trip
count depends on the data). Under ``vmap`` each frame stops being
updated once its own test fails; here every frame of the batch iterates
together and a frame is updated only while its own test holds, so each
gets the JAX package's iteration count. The host reads "does any frame
still iterate" once every :data:`SYNC_EVERY` iterations past the floor
(the extra masked iterations change nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from grbaz_tpu_torch.core.block import Block
from grbaz_tpu_torch.core.device import resolve_device
from grbaz_tpu_torch.core.stream import Stream

# past the iteration floor, the host checks for a frame still iterating
# once every this many iterations
SYNC_EVERY = 8


def ula_steering_vectors(n_antennas: int, n_angles: int = 360,
                         spacing_wavelengths: float = 0.5) -> np.ndarray:
    """[n_angles, M] ULA array response over [0, pi) broadside angles."""
    theta = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    m = np.arange(n_antennas)
    phase = 2.0 * np.pi * spacing_wavelengths * np.cos(theta)[:, None] \
        * m[None, :]
    return np.exp(1j * phase).astype(np.complex64)


def _sumsq(v: torch.Tensor, dim) -> torch.Tensor:
    return torch.sum(v.real ** 2 + v.imag ** 2, dim=dim)


def _orthonormalize(v: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the (few) columns of v [..., M, n]."""
    cols = []
    for j in range(v.shape[-1]):
        c = v[..., j]
        for q in cols:
            c = c - q * torch.sum(q.conj() * c, dim=-1, keepdim=True)
        norm = torch.sqrt(torch.clamp(_sumsq(c, -1), min=1e-30))
        cols.append(c / norm[..., None])
    return torch.stack(cols, dim=-1)


def _residual(r2: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Squared relative residual ||R2 V - V (V^H R2 V)||^2 / ||R2 V||^2
    per frame."""
    bv = r2 @ v
    h = v.conj().transpose(-1, -2) @ bv
    res = bv - v @ h
    return _sumsq(res, (-2, -1)) / torch.clamp(_sumsq(bv, (-2, -1)),
                                               min=1e-30)


def signal_subspace(r: torch.Tensor, n_signals: int, iters: int = 24,
                    tol: float = 1e-5, max_iters: int = 96) -> torch.Tensor:
    """Dominant-eigenvector basis [..., M, n] of Hermitian r [..., M, M]
    by orthogonal iteration on ``R^2``: at least ``iters`` iterations,
    then more while the squared relative residual is above ``tol**2``,
    at most ``max_iters`` in all, each frame on its own count."""
    m = r.shape[-1]
    k = np.arange(m)
    f = np.exp(2j * np.pi * np.outer(k, np.arange(n_signals)) / m)
    v = torch.from_numpy(f.astype(np.complex64)).to(r.device)
    v = v.expand(r.shape[:-2] + v.shape).contiguous()
    r2 = r @ r
    for _ in range(iters):
        v = _orthonormalize(r2 @ v)
    tol2 = float(np.float32(tol) ** 2)
    for it in range(iters, max_iters):
        pred = _residual(r2, v) > tol2
        if (it - iters) % SYNC_EVERY == 0:
            signal_subspace.host_syncs += 1
            if not bool(pred.any()):
                break
        v = torch.where(pred[..., None, None], _orthonormalize(r2 @ v), v)
    return v


signal_subspace.host_syncs = 0


def music_spectrum(x: torch.Tensor, steering: torch.Tensor, n_signals: int,
                   method: str = "subspace"):
    """MUSIC solves for snapshots x [..., navg, M] and steering [A, M].

    Returns ``(spectrum [..., A] float32, aux)``: aux is the eigenvalues
    for ``method='eigh'``, the signal-subspace basis for 'subspace'
    (which uses ``||G^H a||^2 = ||a||^2 - ||U_s^H a||^2``)."""
    navg = x.shape[-2]
    r = (x.conj().transpose(-1, -2) @ x) / navg
    if method == "eigh":
        evals, evecs = torch.linalg.eigh(r)
        m = x.shape[-1]
        g = evecs[..., : m - n_signals]
        denom = _sumsq(steering.conj() @ g, -1)
        aux = evals
    else:
        us = signal_subspace(r, n_signals)
        a2 = _sumsq(steering, -1)
        denom = a2 - _sumsq(steering.conj() @ us, -1)
        aux = us
    spec = 1.0 / torch.clamp(denom, min=1e-20)
    return spec.to(torch.float32), aux


def top_n_peaks(spec: torch.Tensor, n: int):
    """Indices (int64) and values of the n largest local maxima along the
    last dim; ties go to the lower index, as ``lax.top_k``."""
    left = torch.roll(spec, 1, dims=-1)
    right = torch.roll(spec, -1, dims=-1)
    masked = torch.where((spec >= left) & (spec >= right), spec,
                         float("-inf"))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :n], vals[..., :n]


class MusicDOA(Block):
    """Streaming MUSIC block.

    Input: frames [n_frames, navg * M] (M-channel sample vectors
    interleaved). Outputs: (pseudospectrum [n_frames, A] float32, doas
    [n_frames, n_signals] int32 angle indices).
    """

    n_out = 2

    def __init__(self, n_antennas: int, n_signals: int, navg: int,
                 steering: np.ndarray | None = None, n_angles: int = 360,
                 method: str = "subspace", name=None, device="cuda"):
        super().__init__(name)
        if n_signals >= n_antennas:
            raise ValueError("need n_signals < n_antennas")
        self.device = resolve_device(device)
        self.method = method
        self.m = int(n_antennas)
        self.n = int(n_signals)
        self.navg = int(navg)
        steering = np.asarray(
            steering if steering is not None
            else ula_steering_vectors(n_antennas, n_angles), np.complex64)
        self.steering = torch.from_numpy(steering).to(self.device)

    def apply(self, state, params, x: Stream):
        frames = x.data.reshape(x.data.shape[0], self.navg, self.m)
        specs, _ = music_spectrum(frames, self.steering, self.n,
                                  method=self.method)
        idx, _ = top_n_peaks(specs, self.n)
        return state, (x.like(specs, count=x.count),
                       x.like(idx.to(torch.int32), count=x.count))
