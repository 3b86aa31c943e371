"""Plain reference of the MUSIC direction-finding station
(``configs/doa.json``), after gr-baz's ``music_doa`` (``lib/
baz_music_doa.cc:71-160``) and its steering helper.

From the raw ring alone it computes what the station owes for block j of
a stream:

* each antenna's channel as gr-baz's chain would give it: the exact LO at
  the stream's absolute sample (``dsp.lo``), then the lowpass and
  decimation (``dsp.fir_decimate``), antenna by antenna. The filter
  remembers less than a block, so starting from rest one block early
  gives block j exactly; block 0 starts from rest, as the stream does;
* per frame of ``navg`` snapshots, gr-baz's covariance ``R = x x^H /
  navg`` of the column snapshots x [M, navg];
* its eigenvectors, the noise subspace G of the M - n smallest, and the
  pseudospectrum ``1 / ||G^H a(theta)||^2`` over the circular array's
  steering vectors ``a_m(theta) = exp(j 2 pi r cos(theta - 2 pi m /
  M))``, written here anew;
* the n largest local maxima of the spectrum, as bearings.

Departures from gr-baz: ``torch.linalg.eigh`` in float64 in place of
Armadillo's ``eig_sym``; the maxima are circular (bin 0 neighbours the
last bin, as the azimuths of a circular array do) and ties go to the
lower index.

Mode ``"f64"`` is the judge: float64 / complex128 throughout. ``"tf32"``
is the control: float32, with both operands of every product (the
filter's, the covariance's and the steering scan's) rounded to TF32, and
the eigenvectors in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from radiobench.reference import dsp


def _tf32c(z: torch.Tensor) -> torch.Tensor:
    """complex64 with both parts rounded to TF32."""
    return torch.view_as_complex(dsp.tf32(torch.view_as_real(
        z.to(torch.complex64).resolve_conj()).contiguous()))


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        return _tf32c(a) @ _tf32c(b)
    return a.to(torch.complex128) @ b.to(torch.complex128)


def steering(cfg: dict, mode: str, device) -> torch.Tensor:
    """[angles, M]: a_m(theta_k) over the bins theta_k = 2 pi k /
    angles."""
    m, n_ang = cfg["antennas"], cfg["angles"]
    theta = torch.arange(n_ang, dtype=torch.float64, device=device) \
        * (2 * np.pi / n_ang)
    phi = 2 * np.pi * torch.arange(m, dtype=torch.float64, device=device) / m
    ph = 2 * np.pi * cfg["radius_wavelengths"] * torch.cos(theta[:, None]
                                                           - phi)
    return torch.polar(torch.ones_like(ph), ph).to(dsp.complex_dtype(mode))


def peaks(spec: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n]: the indices of the n largest circular local maxima along
    the last dim, ties to the lower index."""
    left = torch.roll(spec, 1, dims=-1)
    right = torch.roll(spec, -1, dims=-1)
    masked = torch.where((spec >= left) & (spec >= right), spec,
                         torch.full_like(spec, -np.inf))
    return torch.sort(masked, dim=-1, descending=True,
                      stable=True).indices[..., :n]


def channel(cfg: dict, ring: np.ndarray, j: int, mode: str,
            device) -> torch.Tensor:
    """[block / decim, M]: every antenna's channel over block j."""
    fs, decim = cfg["sample_rate"], cfg["decim"]
    h = dsp.low_pass_taps(fs, cfg["channel_width"] / 2 + cfg["transition"] / 2,
                          cfg["transition"])
    n_ring, block, m = ring.shape
    first = max(j - 1, 0)
    seg = np.concatenate([ring[i % n_ring] for i in range(first, j + 1)])
    x = torch.from_numpy(seg).to(device, dsp.complex_dtype(mode))
    with dsp.exact_matmul():
        x = x * dsp.lo(first * block, len(seg), dsp.freq_to_inc(
            -cfg["channel_hz"], fs), mode, device)[:, None]
        y = torch.stack([dsp.fir_decimate(x[:, r], h, decim, mode)
                         for r in range(m)], dim=1)
    return y[(j - first) * (block // decim):]


def outputs(cfg: dict, ring: np.ndarray, j: int, mode: str,
            device) -> dict:
    """Block j of a stream whose block i is ``ring[i % len(ring)]``:
    {"spectrum": [frames, angles], "doas": [frames, n]}."""
    m, navg, n_sig = cfg["antennas"], cfg["navg"], cfg["signals"]
    y = channel(cfg, ring, j, mode, device)
    cols = y.reshape(-1, navg, m).transpose(1, 2)      # [frames, M, navg]
    with dsp.exact_matmul():
        r = _mm(cols, cols.conj().transpose(1, 2), mode) / navg
        g = torch.linalg.eigh(r).eigenvectors[..., :m - n_sig]
        proj = _mm(g.conj().transpose(1, 2),
                   steering(cfg, mode, device).T, mode)
        spec = 1.0 / (proj.real ** 2 + proj.imag ** 2).sum(dim=1)
    return dict(spectrum=spec.to(torch.float64).cpu().numpy(),
                doas=peaks(spec, n_sig).cpu().numpy())


def _circ(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    d = np.abs(a - b) % n
    return np.minimum(d, n - d)


def numbers(got: dict, ref: dict) -> dict:
    """The numbers compared for one block: ``got`` is {port: (data,
    count)} as the sinks received it. The frames' count is the spectrum
    port's (the block gives both ports one count); a count or shape that
    differs from the reference's reads inf."""
    n = got["spectrum"][1]
    spec = np.asarray(got["spectrum"][0][:n], np.float64)
    doas = np.asarray(got["doas"][0][:n])
    want, want_doas = ref["spectrum"], ref["doas"]
    if spec.shape != want.shape or doas.shape != want_doas.shape:
        return dict(doa_off=np.inf, peak_gap_db=np.inf,
                    spectrum_gap_db=np.inf)
    n_ang = want.shape[1]
    # bearings with no bearing of the other side within one bin
    d = _circ(doas[:, :, None], want_doas[:, None, :], n_ang)
    off = int((d.min(axis=2) > 1).sum() + (d.min(axis=1) > 1).sum())
    # bins within two of a reference peak
    bins = np.arange(n_ang)
    near = (_circ(bins[None, None, :], want_doas[:, :, None], n_ang)
            <= 2).any(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        db = np.abs(10 * np.log10(spec / want))
    db = np.where(np.isfinite(db), db, np.inf)
    return dict(doa_off=off, peak_gap_db=float(db[near].max()),
                spectrum_gap_db=float(db[~near].max()))


# Each number compared and its limit (PERF.md gives the readings they
# were set from). A bearing may move by one bin on rounding, as a largest
# logit may, so the spectrum's gaps decide: within two bins of the
# reference's peaks the program read 1.5e-3 to 3.1e-3 dB over 19 runs on
# an H100 and the TF32 control 0.41 to 0.59 over 5; elsewhere 1.3e-4 to
# 2.5e-4 and 0.024 to 0.035. Each limit sits eight to ten times above the
# program's largest reading and about ten times below the control's
# least.
LIMITS = dict(doa_off=0, peak_gap_db=0.03, spectrum_gap_db=2e-3,
              undelivered=0)
