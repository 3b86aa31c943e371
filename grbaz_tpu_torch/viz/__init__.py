"""Visualization by data export (port of ``grbaz_tpu/viz/__init__.py``).

The reference's GUI windows are replaced by export sinks producing the
same data products (raster PNGs, trace arrays, CSV):

* :class:`~grbaz_tpu_torch.viz.sinks.WaterfallSink`  — waterfall_sink/window + sdl raster
* :class:`~grbaz_tpu_torch.viz.sinks.PlotSink`       — plot_sink/plot_window
* :class:`~grbaz_tpu_torch.viz.sinks.EyeSink`        — eye.py datascope
* :class:`~grbaz_tpu_torch.viz.sinks.DoACompass`     — doa_compass_plotter/control
* :class:`~grbaz_tpu_torch.viz.sinks.StaticText`     — static_text.py
* :class:`~grbaz_tpu_torch.viz.sinks.TimePanel`      — time_panel.py
* :mod:`~grbaz_tpu_torch.viz.export`                 — PNG/CSV writers (no deps)
"""

from grbaz_tpu_torch.viz.export import write_csv, write_image
from grbaz_tpu_torch.viz.sinks import (DoACompass, EyeSink, PlotSink,
                                       StaticText, TimePanel, WaterfallSink)
from grbaz_tpu_torch.viz.traffic import TrafficPane, duid_name

__all__ = ["write_csv", "write_image", "WaterfallSink", "PlotSink",
           "EyeSink", "DoACompass", "StaticText", "TimePanel",
           "TrafficPane", "duid_name"]
