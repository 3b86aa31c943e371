"""Typed configuration layer (port of ``grbaz_tpu/core/config.py``; host
only, a copy).

SURVEY §5 config mapping: the reference spreads configuration across
``~/.gnuradio/config.conf`` prefs (python/borip.py:46-67 reads the
``[borip]`` section), per-app optparse flags, and GRC parameter XML.
Here one mechanism serves all three roles:

* dataclass defaults (the schema),
* an INI file — ``~/.grbaz/config.conf`` by default, or
  ``$GRBAZ_CONFIG`` (and ``~/.gnuradio/config.conf`` is read too so a
  reference user's ``[borip]`` settings keep working),
* environment overrides ``GRBAZ_<SECTION>_<KEY>``,
* explicit keyword overrides (e.g. parsed CLI flags) — highest
  precedence.

``load_config(MyConfig, "section", **overrides)`` returns a populated
dataclass; values are coerced to the field types (bool accepts
true/false/1/0/yes/no).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Type, TypeVar

T = TypeVar("T")

_DEFAULT_PATHS = (
    os.path.expanduser("~/.grbaz/config.conf"),
    os.path.expanduser("~/.gnuradio/config.conf"),  # reference compat
)


def _coerce(value: str, typ):
    if typ is bool or typ == "bool":
        return value.strip().lower() in ("1", "true", "yes", "on")
    if typ is int or typ == "int":
        return int(float(value))
    if typ is float or typ == "float":
        return float(value)
    return value


def config_paths():
    env = os.environ.get("GRBAZ_CONFIG")
    return ((env,) if env else ()) + _DEFAULT_PATHS


def load_config(schema: Type[T], section: str, **overrides) -> T:
    """Populate ``schema`` (a dataclass) from files + env + overrides."""
    if not dataclasses.is_dataclass(schema):
        raise TypeError("schema must be a dataclass type")
    fields = {f.name: f for f in dataclasses.fields(schema)}
    values = {}

    cp = configparser.ConfigParser()
    cp.read([p for p in config_paths() if p and os.path.exists(p)])
    if cp.has_section(section):
        for key, raw in cp.items(section):
            if key in fields:
                values[key] = _coerce(raw, fields[key].type)

    prefix = f"GRBAZ_{section.upper()}_"
    for env_key, raw in os.environ.items():
        if env_key.startswith(prefix):
            key = env_key[len(prefix):].lower()
            if key in fields:
                values[key] = _coerce(raw, fields[key].type)

    for key, val in overrides.items():
        if val is not None and key in fields:
            values[key] = val

    return schema(**values)


@dataclasses.dataclass
class BorIPConfig:
    """The reference's ``[borip]`` prefs keys (python/borip.py:46-67)."""
    server: str = ""
    default_port: int = 28888
    reconnect_attempts: int = 0     # 0 = forever
    reconnect_interval: float = 5.0
    keepalive_interval: float = 5.0
    verbose: bool = False
