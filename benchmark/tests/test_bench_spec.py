"""Every name in BENCHMARK.json resolves to its files, and the file meets
the contract's shape."""

import json
import os
import re

import pytest

from harness import spec

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = spec.load_json(os.path.join(spec.ROOT, cfg["file"]))
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert data["precision"] == "float32" and data["tf32"] is False
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    cell = spec.find_cell(w["name"])
    assert os.path.exists(spec.driver_path(cell.driver))
    assert spec.load_module(spec.driver_path(cell.driver), cell.driver).run
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], "moves a metric the cell reports")


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0 < m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert callable(spec.load_module(spec.metric_path(m["name"]), m["name"]).read)
    assert {w["name"] for w in BENCH["workloads"]} >= set(m["workloads"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_empty_records_read_nothing():
    """A reader that finds nothing returns None, never 0."""
    for m in BENCH["per_layer"]:
        assert spec.load_module(spec.metric_path(m["name"]), m["name"]).read({}) is None
