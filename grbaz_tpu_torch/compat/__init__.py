"""Compatibility bridges to external tools and legacy APIs.

Equivalents of the reference's long-tail integration modules:
``python/baudline.py`` (external analyzer bridge), ``python/
horizons_block.py`` (ephemeris-driven doppler tuning) and the legacy
``usrp.*`` API shim (``python/usrp.py`` + ``python/usrp/``).

The port's copy of ``grbaz_tpu/compat/__init__.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""
