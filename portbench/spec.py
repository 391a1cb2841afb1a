"""What a cell is made of, found by name: the cell's entry in
``BENCHMARK.json``, its configuration ``configs/<config>.json``, its
traffic mix ``traffic/<traffic>.json`` and each per-layer metric's reader
``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries that this cell reports
    per_layer: list


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, here: str = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, with its files from
    the benchmark's folder ``here``."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"portbench: no workload {name!r} in "
                         "BENCHMARK.json")
    entry = entries[0]
    config = _load(os.path.join(here, "configs", entry["config"] + ".json"))
    traffic = _load(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def metric_reader(name: str, here: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
