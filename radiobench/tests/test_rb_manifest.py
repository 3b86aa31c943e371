"""``BENCHMARK.json`` against the benchmark's contract: keys, names and
units, the files each name points to, and which metrics each cell
reports."""

import json
import re

from radiobench import manifest

B = manifest.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    raw = (manifest.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16 and all(
        PATH.match(p) and ".." not in p for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32 and all(line(w) for w in
                                                 B["command"])
    assert not any(w.startswith("/") or ".." in w for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    n = len(B["workloads"])
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24 and 1 <= len(B["configs"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128


def test_names_units_and_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for key in ("configs", "workloads"):
        names = [x["name"] for x in B[key]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)


def test_every_named_file_exists_and_lies_under_paths():
    root = manifest.ROOT
    under = [root / p for p in B["paths"]]
    files = [root / c["file"] for c in B["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.is_file() and any(d in f.parents for d in under)
        json.loads(f.read_text())
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    for c in used:
        manifest.program(c)
        assert manifest.reference(c).LIMITS
    for w in B["workloads"]:
        t = manifest.traffic(w["traffic"])
        assert t["loop"] in ("open", "closed")
    for m in B["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_setup_bound_and_per_cell_reports():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"] + B["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for w in cells:
        reported = {m["name"] for m in manifest.end_to_end(w)}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.per_layer(w)
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(w)}


def test_layers_are_named_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    perf = (manifest.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf
