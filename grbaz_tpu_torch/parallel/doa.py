"""MUSIC direction finding over the ranks of a mesh dim (port of
``grbaz_tpu/parallel/doa.py``).

The snapshot axis is sharded: each rank forms the partial covariance
``X_l^H X_l`` of its snapshots, and one ``psum`` over the dim gives the
full ``R`` on every rank. The small subspace solve is repeated on every
rank, and the angle grid is sharded: each rank scores its own slice of
the steering vectors. The psum regroups the snapshot sum, so the result
agrees with the serial ``ops.doa.music_spectrum`` to float32
accumulation order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from grbaz_tpu_torch.ops.doa import _scan, signal_subspace
from grbaz_tpu_torch.parallel._collectives import dim, mesh_device, psum


def sharded_music_spectrum(x: torch.Tensor, steering: torch.Tensor,
                           n_signals: int, mesh: DeviceMesh,
                           axis: str = "dev") -> torch.Tensor:
    """This rank's slice of the MUSIC pseudospectrum.

    ``x``: the rank's [navg / P, M] snapshots and ``steering`` its
    [A / P, M] steering vectors, P the size of the mesh dim ``axis``
    (``_collectives.shard(t, mesh, axis)`` cuts both from the global
    arrays, as JAX's ``P(axis, None)`` places them). Returns float32
    [A / P], the rank's angles of the spectrum.
    """
    group, _, size = dim(mesh, axis)
    dev = mesh_device(mesh)
    if x.device != dev or steering.device != dev:
        raise ValueError(f"snapshots and steering must lie on {dev}")
    navg = x.shape[0] * size
    r = psum(x.conj().transpose(0, 1) @ x, group) / navg
    return _scan(signal_subspace(r, n_signals), steering, "subspace")


def simulate_snapshots(n_antennas: int, angles_deg, navg: int,
                       snr_db: float = 20.0, seed: int = 0,
                       spacing_wavelengths: float = 0.5) -> np.ndarray:
    """Test helper: ULA snapshot matrix with sources at ``angles_deg``."""
    rng = np.random.default_rng(seed)
    m = np.arange(n_antennas)
    x = np.zeros((navg, n_antennas), np.complex128)
    for ang in np.atleast_1d(angles_deg):
        # snapshot rows: R = X^H X spans conj(a), so emit conj(a(theta))
        # to match the steering convention of ops.doa
        a = np.exp(-2j * np.pi * spacing_wavelengths
                   * np.cos(np.deg2rad(ang)) * m)
        s = (rng.standard_normal(navg) + 1j * rng.standard_normal(navg))
        x += np.outer(s, a)
    amp = 10.0 ** (-snr_db / 20.0)
    x += amp * (rng.standard_normal(x.shape)
                + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)
