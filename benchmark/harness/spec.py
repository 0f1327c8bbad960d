"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and traffic mix; the configuration's file is the one its
entry names, the traffic mix is ``benchmark/traffic/<traffic>.json``,
and each metric's reader is ``benchmark/metrics/<name>.py``, with the
host spans it needs.  A cell, a mix or a metric is added by adding
files and entries: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict             # the configuration's file, as loaded
    traffic: dict            # the traffic mix's file, as loaded
    end_to_end: list         # the metric entries that apply to this cell
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json (or of ``spec``)."""
    spec = spec if spec is not None else load_json(SPEC_PATH)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(os.path.join(ROOT, config["file"])),
        traffic=traffic_mix(entry["traffic"]),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


def traffic_mix(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def metric_module(name: str):
    """``metrics/<name>.py``, loaded: its ``read``, and the host spans it
    names (harness/spans.py)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
