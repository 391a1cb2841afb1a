"""Every file the benchmark is driven by parses and keeps to the names the
benchmark's contract allows."""

import json
import os
import re

import pytest

from portbench import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_sizes():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
    for word in b["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_entries():
    b = _bench()
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = b["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.config["reduced"] == [
        e for e in _bench()["configs"] if e["name"] == c.entry["config"]
    ][0]["reduced"]
    for key in ("width", "height", "pixel_samples", "light_samples",
                "max_depth", "max_rays_per_pass"):
        assert isinstance(c.traffic[key], int) and c.traffic[key] > 0
    assert [m["name"] for m in c.end_to_end]
    assert [m["name"] for m in c.per_layer]
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_every_file_under_the_folder_is_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
