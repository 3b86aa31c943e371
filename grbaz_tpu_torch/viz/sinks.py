"""Export sinks — the data-product equivalents of the wx GUI windows
(port of ``grbaz_tpu/viz/sinks.py``).

Each sink is a host-side accumulator fed from executor outputs (spectra,
traces, DoA estimates, stream time) with ``save_*`` exporters. They hold
the same display state the reference windows held (ranges, markers,
averaging) without owning a GUI toolkit.

A sink takes numpy arrays or torch tensors. A tensor on the card is
copied to the host once per call (:func:`host`), never element by
element.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grbaz_tpu_torch.ops.colour import thermal_gradient
from grbaz_tpu_torch.viz.export import write_csv, write_image


def host(x):
    """``x`` as a host value: a tensor (on any device) becomes a numpy
    array in one copy; anything else is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class WaterfallSink:
    """Scrolling spectrogram raster (waterfall_sink/waterfall_window +
    the sdl raster sink's role, python/waterfall_sink.py:24-106).

    ``push(spectrum_db)`` appends one row; the raster keeps the last
    ``rows`` rows. Rendering maps dB through the thermal gradient LUT
    (the colouriser path) with runtime-settable range.
    """

    def __init__(self, width: int, rows: int = 512,
                 vmin: float = -100.0, vmax: float = 0.0,
                 center_freq: float = 0.0, span: float = 0.0):
        self.width, self.rows = int(width), int(rows)
        self.vmin, self.vmax = float(vmin), float(vmax)
        self.center_freq, self.span = center_freq, span
        self._lut = thermal_gradient()
        self._buf = np.full((self.rows, self.width), vmin, np.float32)
        self._n = 0

    def push(self, spectrum_db: np.ndarray):
        row = np.asarray(host(spectrum_db), np.float32).reshape(-1)[
            : self.width]
        self._buf = np.roll(self._buf, -1, axis=0)
        self._buf[-1, : len(row)] = row
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def raster(self) -> np.ndarray:
        """[rows, width] float dB (most recent at the bottom)."""
        return self._buf.copy()

    def to_rgb(self) -> np.ndarray:
        t = (self._buf - self.vmin) / max(self.vmax - self.vmin, 1e-9)
        idx = np.clip((t * (len(self._lut) - 1)).astype(np.int32),
                      0, len(self._lut) - 1)
        return self._lut[idx]

    def freq_axis(self) -> np.ndarray:
        if self.span <= 0:
            return np.arange(self.width, dtype=np.float64)
        return (self.center_freq
                + np.linspace(-0.5, 0.5, self.width) * self.span)

    def save_png(self, path: str):
        write_image(path, self.to_rgb())


class PlotSink:
    """Generic vector plot sink (plot_sink.py + plot_window.py roles):
    keeps the last ``keep`` vectors, axis metadata, and markers."""

    def __init__(self, keep: int = 16, x_label: str = "", y_label: str = ""):
        self.keep = int(keep)
        self.x_label, self.y_label = x_label, y_label
        self._vecs: List[np.ndarray] = []
        self.markers: List[float] = []

    def push(self, vec: np.ndarray):
        self._vecs.append(np.array(host(vec)))
        if len(self._vecs) > self.keep:
            self._vecs.pop(0)

    def latest(self) -> Optional[np.ndarray]:
        return self._vecs[-1] if self._vecs else None

    def history(self) -> List[np.ndarray]:
        return list(self._vecs)

    def set_marker(self, x: float):
        self.markers.append(float(x))

    def save_csv(self, path: str):
        v = self.latest()
        if v is None:
            v = np.zeros(0)
        write_csv(path, ([i, float(s)] for i, s in enumerate(np.real(v))),
                  header=[self.x_label or "x", self.y_label or "y"])


class EyeSink:
    """Eye-diagram / datascope sink (python/eye.py eye_sink_f :73):
    folds a sample stream into 2-symbol traces aligned on the symbol
    clock; keeps the last ``traces`` traces."""

    def __init__(self, samples_per_symbol: int, traces: int = 64):
        self.sps = int(samples_per_symbol)
        self.span = 2 * self.sps  # two symbol periods per trace
        self.max_traces = int(traces)
        self._traces: List[np.ndarray] = []
        self._residue = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray):
        x = np.concatenate([self._residue,
                            np.asarray(host(samples),
                                       np.float32).reshape(-1)])
        n_tr = len(x) // self.span
        for i in range(n_tr):
            self._traces.append(x[i * self.span:(i + 1) * self.span].copy())
        self._residue = x[n_tr * self.span:]
        if len(self._traces) > self.max_traces:
            self._traces = self._traces[-self.max_traces:]

    def traces(self) -> np.ndarray:
        """[n_traces, 2*sps] float array — the eye pattern."""
        if not self._traces:
            return np.zeros((0, self.span), np.float32)
        return np.stack(self._traces)

    def eye_opening(self) -> float:
        """Vertical eye opening at the center sampling instant."""
        t = self.traces()
        if not len(t):
            return 0.0
        mid = t[:, self.sps]
        thr = 0.5 * (mid.min() + mid.max())
        hi, lo = mid[mid > thr], mid[mid <= thr]
        if not len(hi) or not len(lo):
            return 0.0
        return float(hi.min() - lo.max())

    def save_csv(self, path: str):
        write_csv(path, self.traces())


class DoACompass:
    """Direction-finding display state (doa_compass_plotter.py /
    doa_compass_control.py roles): latest bearings + confidences, an
    ASCII compass rose, CSV export."""

    def __init__(self, n_points: int = 1):
        self.n_points = n_points
        self.bearings: List[float] = []
        self.confidences: List[float] = []
        self._history: List[Tuple[float, List[float]]] = []

    def update(self, bearings_deg: Sequence[float],
               confidences: Optional[Sequence[float]] = None):
        self.bearings = [float(b) % 360.0
                         for b in np.ravel(host(bearings_deg))]
        self.confidences = [float(c) for c in np.ravel(host(confidences))] \
            if confidences is not None else [1.0] * len(self.bearings)
        self._history.append((time.time(), list(self.bearings)))

    def ascii_rose(self, width: int = 33) -> str:
        """Text compass: one row, '^' at each bearing (0..360 mapped)."""
        row = ["-"] * width
        for b in self.bearings:
            row[int(b / 360.0 * (width - 1))] = "^"
        ticks = {0: "N", 90: "E", 180: "S", 270: "W"}
        lab = [" "] * width
        for deg, ch in ticks.items():
            lab[int(deg / 360.0 * (width - 1))] = ch
        return "".join(lab) + "\n" + "".join(row)

    def save_csv(self, path: str):
        write_csv(path, ([t] + bs for t, bs in self._history),
                  header=["time"] + [f"bearing{i}" for i in
                                     range(len(self.bearings) or 1)])


class StaticText:
    """Variable text display (static_text.py role): holds a formatted
    value, notifies an optional callback on change."""

    def __init__(self, label: str = "", formatter: Callable = str,
                 on_change: Optional[Callable[[str], None]] = None):
        self.label = label
        self.formatter = formatter
        self.on_change = on_change
        self._text = ""

    def set_value(self, value):
        new = self.formatter(value)
        if new != self._text:
            self._text = new
            if self.on_change:
                self.on_change(new)

    @property
    def text(self) -> str:
        return (self.label + ": " if self.label else "") + self._text


class TimePanel:
    """Wall-clock vs stream-time panel (time_panel.py role): stream time
    derives from the epoch + sample counter (rx_time semantics)."""

    def __init__(self, sample_rate: float):
        self.sample_rate = float(sample_rate)
        self.epoch_sec = 0
        self.epoch_frac = 0.0
        self.samples = 0

    def set_epoch(self, sec: int, frac: float = 0.0):
        self.epoch_sec, self.epoch_frac = int(sec), float(frac)
        self.samples = 0

    def advance(self, n_samples: int):
        self.samples += int(host(n_samples))

    def stream_time(self) -> float:
        return (self.epoch_sec + self.epoch_frac
                + self.samples / self.sample_rate)

    def snapshot(self) -> dict:
        now = time.time()
        st = self.stream_time()
        return dict(wall_time=now, stream_time=st, lag=now - st,
                    samples=self.samples)


class HistoSink:
    """Histogram sink (the reference tutorial's 'Histo sink test',
    samples/tutorial/part-01): accumulates value counts over fixed bins
    and renders ascii bars / exports counts."""

    def __init__(self, n_bins: int = 32, lo: float = -1.5, hi: float = 1.5):
        self.n_bins = int(n_bins)
        self.lo, self.hi = float(lo), float(hi)
        self.counts = np.zeros(self.n_bins, np.int64)
        self.total = 0

    def push(self, x: np.ndarray):
        x = np.asarray(host(x), np.float64).ravel()
        idx = np.clip(((x - self.lo) / (self.hi - self.lo)
                       * self.n_bins).astype(np.int64), 0, self.n_bins - 1)
        np.add.at(self.counts, idx, 1)
        self.total += len(x)

    def edges(self) -> np.ndarray:
        return np.linspace(self.lo, self.hi, self.n_bins + 1)

    def render(self, width: int = 50) -> str:
        peak = max(int(self.counts.max()), 1)
        e = self.edges()
        rows = []
        for b in range(self.n_bins):
            bar = "#" * int(round(self.counts[b] / peak * width))
            rows.append(f"{e[b]:+8.3f} | {bar} {int(self.counts[b])}")
        return "\n".join(rows)
