"""Capture-file sources (port of ``grbaz_tpu/io``)."""
