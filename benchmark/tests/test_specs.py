"""Every configuration, traffic mix and metric of BENCHMARK.json loads
by name, and the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from conftest import CELLS, SPEC
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name, SPEC)
    assert cell.traffic["kind"] in ("library",)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.metric_module(metric).read)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_spans_a_metric_names_resolve(metric):
    from harness.spans import _resolve

    module = spec.metric_module(metric)
    for entries in getattr(module, "SPANS", {}).values():
        for entry in entries:
            owner, leaf = _resolve(entry)
            assert callable(getattr(owner, leaf)), entry
    assert set(getattr(module, "RANGES", ())) <= set(
        getattr(module, "SPANS", {}))


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_names_itself(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    assert entry["file"].startswith("benchmark/configs/")
    assert spec.load_json(os.path.join(spec.ROOT, entry["file"]))[
        "name"] == config
    assert any(w["config"] == config for w in SPEC["workloads"])


def test_names_units_and_limits():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec.load_json(spec.SPEC_PATH)["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
