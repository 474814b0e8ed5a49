"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic, driver,
limits and per-layer readers are found by name (``harness/spec.py``).  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a profiled part of the window.
Every run compares what the timed path produced with the plain reference
and prints each number compared beside its limit, last on standard error
and last in the result.  The last line of standard output is the result:
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}``.  The run exits 1 without a result where no card (or fewer
than the cell asks for) is present, or where the JAX package or JAX itself
was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# The port's only compiled code, its nvcc output, goes to build/kernels/
# inside the checkout by itself (fm3dgan_torch/ops/_build.py).
for _path in (BENCH_DIR, ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fm3dgan")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``fm3dgan_torch`` is not ``fm3dgan``)."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def per_layer(cell, records) -> dict:
    from harness import spec

    out = {}
    for m in cell.per_layer:
        value = spec.load_module(spec.metric_path(m["name"]), m["name"]).read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from harness import spec

    cell = spec.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} devices, {torch.cuda.device_count()} present")
    # The configurations state float32: no TF32 in convolutions or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()

    driver = spec.load_module(spec.driver_path(cell.driver), f"driver_{cell.driver}")
    ctx = spec.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                       build_dir=os.path.join(ROOT, "build", "benchmark"))
    outcome = driver.run(ctx)

    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {found}")
    if args.trace:
        metrics = per_layer(cell, outcome.records)
    else:
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if args.trace:
        device.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    correct = all(c.ok for c in outcome.checks)
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device}
    if args.trace and outcome.breakdown:
        result["breakdown"] = outcome.breakdown
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                                 "limit": c.limit} for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
