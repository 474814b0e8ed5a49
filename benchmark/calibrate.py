"""Readings that the limits of ``checks/<cell>.json`` are set from, on the
card, at the cell's own sizes.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... \\
        [--control_seeds S1 S2 S3] [--out chiprun_out/calibrate.jsonl]

For every seed the program's numbers against the reference: for a training
cell its start, a window of ``window_multiple`` iterations (the readings
need no measured window) and one iteration of each branch from the state
that window left, as a run compares them; for an edit cell the edits of a
short window at the cell's load.  For each control seed also the
control's: the reference computed with TF32 (the precision below the
configurations' float32) put in the program's place, and for a training
cell the faults planted in the program (``FAULTS``: half of each batch left
out, R1 skipped, the path-length step skipped).  A state left unchanged
needs no run: its ``change_gap`` reads 1.  Each training record also gives
every branch's own numbers.  One JSON line per seed.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
for _path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch  # noqa: E402

from harness import compare, models, spec  # noqa: E402
from harness.device import free  # noqa: E402
from harness.feed import TrainFeed  # noqa: E402


@contextlib.contextmanager
def tf32():
    """TF32 in convolutions and matmuls inside the block."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class HalfBatch:
    """A train system that leaves out the second half of every batch."""

    def __init__(self, system):
        self._system = system

    def __getattr__(self, name):
        return getattr(self._system, name)

    def train_iteration(self, i, *batch):
        return self._system.train_iteration(i, *(b[: b.shape[0] // 2] for b in batch))


def frozen_steps(system):
    """``system`` with every optimizer's step a no-op (its state stays)."""
    for opt, _ in system.optimizers().values():
        opt.step = lambda *a, **k: None
    return system


@contextlib.contextmanager
def skipped(step: str, metrics):
    """The port's ``step`` (in both trainers' step modules) replaced by one
    that changes nothing and returns ``metrics(state)``."""
    from fm3dgan_torch.train import steps, steps_2encoder

    saved = [(m, getattr(m, step)) for m in (steps, steps_2encoder)]
    for m, _ in saved:
        setattr(m, step, lambda state, *a, **k: metrics(state))
    try:
        yield
    finally:
        for m, fn in saved:
            setattr(m, step, fn)


def _zero(state):
    return torch.zeros((), device=state.mean_path_length.device)


FAULTS = {
    "half_batch": (HalfBatch, contextlib.nullcontext),
    "skip_r1": (lambda s: s, lambda: skipped("d_reg_step", lambda st: {"r1": _zero(st)})),
    "skip_ppl": (lambda s: s, lambda: skipped(
        "g_reg_step", lambda st: {"g_reg": _zero(st), "path_length": st.mean_path_length})),
}


def train_numbers(cell, seed: int, build, around=contextlib.nullcontext, device: str = "cuda"):
    """(numbers, each branch's numbers) of the train system that
    ``build(weights)`` makes, run inside ``around()`` as a run's program
    runs, against the reference."""
    driver = spec.load_module(spec.driver_path("train"), "driver_train")
    cfg, tr = cell.config, cell.traffic
    schedule = models.train_config(cfg)
    feed = TrainFeed(seed, tr["pool"], tr["batch"], cfg["input_size"], cfg["size"], schedule,
                     ffhq=cfg.get("ds_dataset_type") == "FFHQ")
    weights = models.make_weights(cfg, seed, device, training=True)
    with around():
        system = build(weights)
        start, staged = driver._warm_up(system, feed, tr, weights)
        done, _, _, _ = driver._window(system, feed, tr, 0, staged, device,
                                       count=tr["window_multiple"])
        indices = driver.branch_indices(cfg, schedule, tr["window_start"] + len(done))
        snap = system.snapshot()
        prog = (start, driver.branch_readings(system, feed, indices, snap))
    del system, weights, staged, done
    free(device)
    ref = driver.reference_readings(cfg, tr, seed, feed, indices, snap, device)
    branches = {b: dict(compare.branch_numbers(prog[1][b], ref[1][b]),
                        losses={k: compare.loss_gap([prog[1][b][0]], [{k: v}])
                                for k, v in ref[1][b][0].items()})
                for b in ref[1]}
    return driver.numbers(prog, ref), branches


def train_seed(cell, seed: int, control: bool, device: str = "cuda") -> dict:
    cfg = cell.config
    program = lambda w: models.program_trainer(cfg, seed, w, device)  # noqa: E731
    runs = {"program": (program, contextlib.nullcontext)}
    if control:
        runs["control_tf32"] = (lambda w: models.reference_trainer(cfg, seed, w, device), tf32)
        runs.update({f"fault_{k}": ((lambda w, wrap=wrap: wrap(program(w))), around)
                     for k, (wrap, around) in FAULTS.items()})
    out = {"numbers": {}, "branches": {}}
    for kind, (build, around) in runs.items():
        out["numbers"][kind], out["branches"][kind] = train_numbers(cell, seed, build, around,
                                                                    device)
        free(device)
    return out


def edit_seed(cell, seed: int, control: bool, seconds: float, device: str = "cuda") -> dict:
    from harness import edit_loop
    from harness.feed import EditFeed

    cfg, tr = cell.config, cell.traffic
    kw = edit_loop.forward_kwargs(cfg)
    weights = models.make_weights(cfg, seed, device, training=False)
    prog = models.program_manipulator(cfg, seed, weights, device)
    feed = EditFeed(seed, tr["pool"], cfg["input_size"], tr["distinct_requests"],
                    batch=tr.get("batch"), renders_per_request=tr.get("renders_per_request"))
    reqs = [(torch.from_numpy(p), torch.from_numpy(r)) for p, r in feed.requests]
    outs, _, _, _ = edit_loop._loop(prog, reqs, kw, seconds, 0, device)
    del prog
    free(device)
    picked = compare.sample(seed, len(outs), tr["checked_requests"], must=[len(outs) - 1])
    ref = edit_loop.reference_images(cfg, seed, reqs, picked, device)
    out = {"numbers": {"program": {"image_gap": max(compare.image_gap(outs[j].numpy(), ref[j])
                                                    for j in picked)}}}
    if control:
        bundle = models.reference_manipulator(cfg, weights, device)
        with tf32():
            ctl = edit_loop.reference_images(cfg, seed, reqs, picked, device, bundle=bundle)
        out["numbers"]["control_tf32"] = {"image_gap": max(compare.image_gap(ctl[j], ref[j])
                                                           for j in picked)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0, help="edit cells: the short window")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        control = seed in args.control_seeds
        if cell.driver == "train":
            rec = train_seed(cell, seed, control)
        else:
            rec = edit_seed(cell, seed, control, args.seconds)
        line = json.dumps({"cell": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                           **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
