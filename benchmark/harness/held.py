"""Cells held out of ``BENCHMARK.json``: their driver, traffic, limits and
readers are in place and tested, but the cell does not yet meet the
contract on the card (PERF.md says why).

``benchmark/held/<cell>.json`` holds the entries that registering the cell
adds, and nothing else:

    workload          the entry of ``workloads``
    end_to_end        end-to-end metrics whose ``workloads`` list gains the cell
    per_layer_lists   per-layer metrics whose ``workloads`` list gains the cell
    per_layer         new per-layer metrics (their own entries)

Registering the cell is appending these to ``BENCHMARK.json`` and deleting
the file.  ``find_cell`` resolves a registered cell as ``spec.find_cell``
does, and a held one as if it were registered.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import tempfile
from typing import Any, Dict, List

from harness import spec

HELD_DIR = os.path.join(spec.BENCH_DIR, "held")


def held_path(cell: str) -> str:
    return os.path.join(HELD_DIR, f"{cell}.json")


def held_cells() -> List[str]:
    return sorted(os.path.basename(p)[:-len(".json")]
                  for p in glob.glob(os.path.join(HELD_DIR, "*.json")))


def registered(cell: str, bench: Dict[str, Any]) -> Dict[str, Any]:
    """``bench`` with the held cell's entries added."""
    held = spec.load_json(held_path(cell))
    out = copy.deepcopy(bench)
    out["workloads"].append(held["workload"])
    for key, names in (("end_to_end", held["end_to_end"]),
                       ("per_layer", held["per_layer_lists"])):
        metrics = {m["name"]: m for m in out[key]}
        for name in names:
            metrics[name]["workloads"].append(cell)
    out["per_layer"] += held["per_layer"]
    return out


def find_cell(name: str) -> spec.Cell:
    bench = spec.benchmark_json()
    if any(w["name"] == name for w in bench["workloads"]):
        return spec.find_cell(name)
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
            json.dump(registered(name, bench), f)
        return spec.find_cell(name, root=root)
