"""Every held cell (``benchmark/held/<cell>.json``, ``harness/held.py``)
resolves as ``test_bench_spec.py`` resolves a registered one, on one card
or four, so that registering it is appending its entries."""

import os

import pytest

from harness import held, spec

from test_bench_spec import BENCH, NAME

CELLS = held.held_cells()


def test_the_data_parallel_cell_is_held():
    assert "train.3enc.dp4" in CELLS


@pytest.mark.parametrize("name", CELLS)
def test_held_cell_resolves(name):
    entries = spec.load_json(held.held_path(name))
    assert set(entries) == {"workload", "end_to_end", "per_layer_lists", "per_layer"}
    w = entries["workload"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["name"] == name
    assert NAME.match(name) and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert name not in {c["name"] for c in BENCH["workloads"]}
    assert (w["config"], w["traffic"]) not in {(c["config"], c["traffic"])
                                               for c in BENCH["workloads"]}
    cell = held.find_cell(name)
    assert cell.chips == w["chips"]
    assert os.path.exists(spec.driver_path(cell.driver))
    assert spec.load_module(spec.driver_path(cell.driver), cell.driver).run
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], "moves a metric the cell reports")


@pytest.mark.parametrize("name", CELLS)
def test_held_entries_fit_the_benchmark(name):
    """The lists it joins exist and hold it not yet; its own per-layer
    metrics are new, name their readers and read nothing from nothing."""
    entries = spec.load_json(held.held_path(name))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for names, metrics in ((entries["end_to_end"], e2e),
                           (entries["per_layer_lists"], per_layer)):
        for n in names:
            assert name not in metrics[n]["workloads"]
    for m in entries["per_layer"]:
        assert m["name"] not in per_layer and NAME.match(m["name"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["workloads"] == [name] and m["moves"] in e2e
        assert spec.load_module(spec.metric_path(m["name"]), m["name"]).read({}) is None
    merged = held.registered(name, BENCH)
    assert len(merged["workloads"]) == len(BENCH["workloads"]) + 1
    assert BENCH == spec.benchmark_json()  # merging copies, never edits
