"""A cell and everything it names, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic; the files are

    benchmark/configs/<config>.json     sizes, precision, training settings
    benchmark/traffic/<traffic>.json    {"driver": ..., parameters}
    benchmark/checks/<cell>.json        {number compared: limit}
    benchmark/drivers/<driver>.py       ``run(ctx) -> Outcome``
    benchmark/metrics/<metric>.py       ``read(records) -> float or None``

so adding a cell, a configuration, a traffic mix or a per-layer metric is
adding files and entries, never editing one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """The Python file at ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_json(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "configs", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def checks_path(cell: str) -> str:
    return os.path.join(BENCH_DIR, "checks", f"{cell}.json")


def driver_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "drivers", f"{name}.py")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark_json(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(config_path(w["config"])),
        traffic=load_json(traffic_path(w["traffic"])),
        limits=load_json(checks_path(name)),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's seed, the window's length and
    whether the run is traced; ``build_dir`` is where the run may write."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    build_dir: str
    device: str = "cuda"


@dataclasses.dataclass
class Check:
    """One number compared with its limit (the number must not exceed it)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the end-to-end values (besides ``setup_s``,
    which the driver also sets), the records the per-layer readers read,
    the comparisons, the counts of units attempted and failed, the device
    memory peak, and, for a traced run, the traced window."""

    end_to_end: Dict[str, float]
    records: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict[str, list]] = None
