"""Readings that a data-parallel cell's limits (``checks/<cell>.json``) are
set from, on the cards: ``calibrate.py``'s training readings for
``drivers/train_dp.py``.

    python3 benchmark/calibrate_dp.py --workload train.3enc.dp4 [--seeds S1 S2 ...] \\
        [--control_seeds S3 S4] [--out calibrate_dp.jsonl]

For every seed a run of the driver with a window of ``window_multiple``
iterations, every number it compares recorded (``moment_gap`` and
``change_gap`` too); for each control seed the same run with each of
``FAULTS`` in the program's place, on every rank: the reference computed
with TF32, ``calibrate.py``'s faults (half of each rank's rows left out, R1
skipped, the path-length step skipped), and the gradient average skipped
(each rank applies its own rows' gradients).  One JSON line per seed.  The
benchmark's own runs never run this; a held cell (``harness/held.py``) is
calibrated as a registered one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import sys
import time
from unittest import mock

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
for _path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from harness import held, models, ref_parallel, spec  # noqa: E402

NUMBERS = ("start_loss_gap", "start_grad_gap", "start_change_gap", "loss_gap", "grad_gap",
           "moment_gap", "change_gap")
calibrate = spec.load_module(os.path.join(BENCH_DIR, "calibrate.py"), "bench_calibrate")


def _program(cfg, seed, weights, device):
    return models.program_trainer(cfg, seed, weights, device=device)


@contextlib.contextmanager
def _tf32_reference():
    with ref_parallel.installed(), calibrate.tf32():
        yield


def _no_average():
    import fm3dgan_torch.parallel as package

    return mock.patch.object(package, "average_gradients", lambda grads: grads)


# name -> (make(cfg, seed, weights, device) -> train system, context it runs in)
FAULTS = {
    "control_tf32": (lambda cfg, seed, weights, device:
                     models.reference_trainer(cfg, seed, weights, device), _tf32_reference),
    **{name: (lambda *a, wrap=wrap: wrap(_program(*a)), around)
       for name, (wrap, around) in calibrate.FAULTS.items()},
    "skip_grad_average": (_program, _no_average),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_dp: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cell = copy.deepcopy(held.find_cell(args.workload))
    cell.limits = {k: math.inf for k in NUMBERS}
    driver = spec.load_module(spec.driver_path(cell.driver), f"driver_{cell.driver}")
    build_dir = os.path.join(os.path.dirname(BENCH_DIR), "build", "benchmark")
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        kinds = (["program"] if seed in args.seeds else []) + (
            list(FAULTS) if seed in args.control_seeds else [])
        numbers = {}
        for kind in kinds:
            ctx = spec.Context(cell=cell, seed=seed, seconds=0.0, trace=False, build_dir=build_dir)
            out = driver.run(ctx, fault="" if kind == "program" else kind)
            numbers[kind] = {c.name: c.value for c in out.checks}
        line = json.dumps({"cell": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                           "numbers": numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
