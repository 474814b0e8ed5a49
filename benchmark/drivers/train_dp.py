"""Data-parallel training cells: the port's ``train_iteration`` on every
rank of a process group, each rank on its contiguous rows of the global
batch, as ``train_3_encoder --data_parallel`` runs it.

The run's own process is rank 0; it starts ranks 1 .. ``ranks`` - 1 as
processes of this file (``python3 benchmark/drivers/train_dp.py --rank R
...``) and waits for them.  Each rank joins the group through the port's
``parallel.init_distributed`` (NCCL on ``cuda:R``; gloo on the CPU, where
the benchmark's tests run it), with ``group_timeout_s``.  A rank that fails
ends the run: rank 0 stops every rank and exits 1.

The global batch is ``batch`` x ``ranks`` rows cut from pools of ``pool`` x
``ranks`` images (``harness/feed.py``); rank R takes rows [R N / W, (R + 1)
N / W) of every array (``RankFeed``).  The configuration's batch sizes are
set to the global batch, as ``--data_parallel`` reads them.  Set-up, the
warm-up order, the window (from ``window_start``, whole PPL periods; rank
0's clock decides when it ends and tells the other ranks over a gloo group
after each iteration), the traced iterations and the comparison are those
of the one-card driver (``drivers/train.py``), on every rank: after the
window each rank copies its state and runs one iteration of each branch
from it, then the reference runs as the same ranks (``harness/
ref_parallel.py`` puts plain ``torch.distributed`` collectives in place of
its one-process helpers) from the weights made again from the seed and
from the copies.  Losses are the global batch's and the gradients the
ranks' average, so rank 0's numbers are the job's.  ``train_ms_per_iter``,
``setup_s`` (from the start of the run, the other ranks' start-up
included), the records of a traced run (rank 0's) and the memory peak are
rank 0's; the model operations are rank 0's share, so ``mfu.train`` reads
one card's share of its peak.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _path in (BENCH_DIR, ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import numpy as np  # noqa: E402

from harness import ref_parallel, spec  # noqa: E402

CELL_FILE = "train_dp_cell.json"


def _one_card():
    return spec.load_module(spec.driver_path("train"), "driver_train")


class RankFeed:
    """A rank's rows of every array of a global feed's batches."""

    def __init__(self, feed, rank: int, world: int):
        self.feed, self.rank, self.world = feed, rank, world

    def batch(self, i: int):
        return tuple(np.ascontiguousarray(a[ref_parallel.local_rows(a.shape[0], self.rank,
                                                                    self.world)])
                     for a in self.feed.batch(i))


def global_config(cfg, tr):
    """The configuration with its batch sizes set to the global batch."""
    n = tr["batch"] * tr["ranks"]
    return dict(cfg, train_config=dict(cfg["train_config"], rec_batch=n, ds_batch=n))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _window(system, feed, tr, seconds, staged, device, stop_group, sync_each=False, first=0,
            count=0):
    """``drivers/train.py``'s window on every rank, ended by rank 0's clock:
    after each iteration rank 0 broadcasts whether the window is over."""
    import torch
    import torch.distributed as dist

    from harness.device import sync

    i = tr["window_start"] + first
    out, step_s = [], []
    flag = torch.zeros(1, dtype=torch.int32)
    sync(device)
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out.append(system.train_iteration(i, *staged))
        staged = system.stage(*feed.batch(i + 1))
        if sync_each:
            sync(device)
            step_s.append(time.perf_counter() - t0)
        i += 1
        if count:
            if len(out) == count:
                break
            continue
        flag[0] = int(time.perf_counter() - start >= seconds
                      and len(out) % tr["window_multiple"] == 0)
        dist.broadcast(flag, src=0, group=stop_group)
        if flag[0]:
            break
    sync(device)
    return out, time.perf_counter() - start, step_s, staged


def rank_run(cell, seed: int, seconds: float, trace_on: bool, build_dir: str, rank: int,
             port: int, device_kind: str, t0: float, fault: str = ""):
    """One rank's run; rank 0 returns the Outcome, the others None.  A
    ``fault`` (``calibrate_dp.py``'s ``FAULTS``) runs on every rank in the
    program's place."""
    import torch.distributed as dist

    from fm3dgan_torch import parallel
    from harness import models, trace
    from harness.device import free, memory_peak, sync
    from harness.feed import TrainFeed

    one = _one_card()
    tr, world = cell.traffic, cell.traffic["ranks"]
    if cell.config["model"] != "3enc":
        raise ValueError("the data-parallel reference runs the 3-encoder trainer only")
    cfg = global_config(cell.config, tr)
    timeout = datetime.timedelta(seconds=tr["group_timeout_s"])
    _, dev = parallel.init_distributed(f"localhost:{port}", world, rank, device=device_kind,
                                       timeout=timeout)
    device = str(dev)
    stop_group = dist.new_group(backend="gloo", timeout=timeout)
    schedule = models.train_config(cfg)
    feed = RankFeed(TrainFeed(seed, tr["pool"] * world, tr["batch"] * world,
                              cfg["input_size"], cfg["size"], schedule, ffhq=False),
                    rank, world)
    weights = models.make_weights(cfg, seed, device, training=True)
    program = contextlib.ExitStack()
    if fault:
        make, around = spec.load_module(os.path.join(BENCH_DIR, "calibrate_dp.py"),
                                        "bench_calibrate_dp").FAULTS[fault]
        program.enter_context(around())
        system = make(cfg, seed, weights, device)
    else:
        system = models.program_trainer(cfg, seed, weights, device=device)
    start, staged = one._warm_up(system, feed, tr, weights)
    del weights
    sync(device)
    dist.barrier(group=stop_group)
    setup_s = time.perf_counter() - t0

    records, busy_s, window_s, breakdown = {}, None, None, None
    if trace_on:
        n_traced = tr["traced_iterations"]
        if rank == 0:
            with trace.traced(build_dir, device) as traced:
                first_part, _, _, staged = _window(system, feed, tr, 0, staged, device,
                                                   stop_group, count=n_traced)
            tr_ = traced["trace"]
        else:
            first_part, _, _, staged = _window(system, feed, tr, 0, staged, device,
                                               stop_group, count=n_traced)
        rest, wall, step_s, staged = _window(system, feed, tr, seconds, staged, device,
                                             stop_group, sync_each=True, first=n_traced)
        done = first_part + rest
        idx = [tr["window_start"] + n_traced + k for k in range(len(rest))]
        if rank == 0:
            records.update(
                trace=tr_, units=n_traced,
                step_ms={"plain": [s * 1e3 for i, s in zip(idx, step_s)
                                   if not one._reg(schedule, i)],
                         "reg": [s * 1e3 for i, s in zip(idx, step_s)
                                 if one._reg(schedule, i)]},
                window_s=wall, indices=idx)
            busy_s, window_s = tr_.busy_s(), tr_.window_s
            breakdown = {"device_ops": tr_.top_device_ops(), "idle_gaps": tr_.idle_gaps()}
        end_to_end = {}
    else:
        done, wall, _, staged = _window(system, feed, tr, seconds, staged, device,
                                        stop_group)
        end_to_end = {"train_ms_per_iter": wall / len(done) * 1e3}
    end_to_end["setup_s"] = setup_s
    attempted, failed = len(done), sum(not one._finite(m) for m in done)
    peak = memory_peak(device)
    indices = one.branch_indices(cfg, schedule, tr["window_start"] + len(done))
    del done, staged
    snap = system.snapshot()
    prog = (start, one.branch_readings(system, feed, indices, snap))
    program.close()
    del system
    free(device)

    with ref_parallel.installed():
        ref = one.reference_readings(cfg, tr, seed, feed, indices, snap, device)
    del snap
    got = one.numbers(prog, ref)
    dist.barrier(group=stop_group)
    parallel.shutdown(wait=False)
    if rank:
        return None
    checks = [spec.Check(k, got[k], limit) for k, limit in cell.limits.items()]
    if trace_on:  # one rank's share: the configuration file's batch is a rank's
        records["flops"] = sum(one._iteration_flops(cell.config, seed, feed, records["indices"]))
    return spec.Outcome(end_to_end=end_to_end, records=records, checks=checks,
                        attempted=attempted, failed=failed, memory_peak_bytes=peak,
                        busy_s=busy_s, window_s=window_s, breakdown=breakdown)


def _cell_json(cell) -> dict:
    return {"name": cell.name, "chips": cell.chips, "config": cell.config,
            "traffic": cell.traffic, "limits": cell.limits, "end_to_end": cell.end_to_end,
            "per_layer": cell.per_layer}


def _watch(procs) -> None:
    """Ends the run at once if a rank exits with an error."""
    while any(p.poll() is None for p in procs):
        for p in procs:
            if p.poll() not in (None, 0):
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                print(f"benchmark: a rank exited with {p.returncode}", file=sys.stderr,
                      flush=True)
                os._exit(1)
        time.sleep(0.5)


def run(ctx: spec.Context, fault: str = "") -> spec.Outcome:
    t0 = time.perf_counter()
    tr = ctx.cell.traffic
    world = tr["ranks"]
    device_kind = "cpu" if str(ctx.device).startswith("cpu") else "cuda"
    os.makedirs(ctx.build_dir, exist_ok=True)
    cell_path = os.path.join(ctx.build_dir, CELL_FILE)
    with open(cell_path, "w") as f:
        json.dump(_cell_json(ctx.cell), f)
    port = _free_port()
    args = [sys.executable, os.path.abspath(__file__), "--cell", cell_path,
            "--seed", str(ctx.seed), "--seconds", str(ctx.seconds), "--trace", str(int(ctx.trace)),
            "--build_dir", ctx.build_dir, "--port", str(port), "--device", device_kind]
    if fault:
        args += ["--fault", fault]
    procs = [subprocess.Popen(args + ["--rank", str(r)], stdout=sys.stderr, cwd=ROOT)
             for r in range(1, world)]
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        outcome = rank_run(ctx.cell, ctx.seed, ctx.seconds, ctx.trace, ctx.build_dir, 0, port,
                           device_kind, t0, fault)
        for p in procs:
            if p.wait(timeout=tr["process_timeout_s"]) != 0:
                raise RuntimeError(f"a rank exited with {p.returncode}")
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
        from fm3dgan_torch import parallel

        parallel.shutdown(wait=False)
        raise
    return outcome


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank (1 or more) of a data-parallel cell")
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--build_dir", required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.Cell(**spec.load_json(args.cell))
    rank_run(cell, args.seed, args.seconds, bool(args.trace), args.build_dir, args.rank,
             args.port, args.device, time.perf_counter(), args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
