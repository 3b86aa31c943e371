"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own:

* ``configs/<config>.json``: the deployment's sizes; ``configs/
  <config>.py``: ``executor(cfg, block, device)``, ``ring(cfg, streams,
  ring_blocks, block, seed, device)`` and ``PORTS``;
* ``reference/<config>.py``: ``outputs(cfg, ring, j, mode, device)``,
  ``numbers(got, ref)`` and ``LIMITS``;
* ``traffic/<mix>.json``: the generator's parameters;
* ``metrics/<metric>.py``: ``read(ctx)``, the value or None;
* ``work/<kernel>.py``: the kernel's bytes and operations from shapes.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@functools.lru_cache(maxsize=None)
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    for w in bench()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def program(name: str):
    return importlib.import_module(f"radiobench.configs.{name}")


def reference(name: str):
    return importlib.import_module(f"radiobench.reference.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; metric names hold dots, so the
    file is loaded by path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"radiobench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(cell_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench()["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(cell_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and
    those that list no cells but move a metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(cell_name)}
    return [m for m in bench()["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
