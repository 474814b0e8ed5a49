"""What the training CLIs share: a flag for every ``TrainConfig`` field, the
configuration from the parsed flags, the decoded-image cache setting, the
reference batch's downsampling, the divergence guard's count, and the
training loop itself (``train_loop``)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np

from fm3dgan_torch.train.config import TrainConfig


def parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def add_config_flags(p: argparse.ArgumentParser) -> None:
    """``--<field>`` for every TrainConfig field (booleans take true/false;
    ``--w_plus_sliced_layer`` a comma-separated list)."""
    for f in dataclasses.fields(TrainConfig):
        flag = f"--{f.name}"
        if isinstance(f.default, bool):
            p.add_argument(flag, type=parse_bool, default=f.default)
        elif f.default is None or f.name == "w_plus_sliced_layer":
            p.add_argument(flag, type=str, default=None)
        elif isinstance(f.default, int):
            p.add_argument(flag, type=int, default=f.default)
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=f.default)
        else:
            p.add_argument(flag, type=str, default=f.default)


def config_from_args(args) -> TrainConfig:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)}
    if isinstance(kw["w_plus_sliced_layer"], str):
        kw["w_plus_sliced_layer"] = tuple(int(x) for x in kw["w_plus_sliced_layer"].split(","))
    return TrainConfig(**kw)


def resolve_cache(args, cfg: TrainConfig):
    """``--cache_decoded``: True, False, or (auto) an entry cap from about a
    quarter of the available host memory."""
    if args.cache_decoded != "auto":
        return args.cache_decoded == "true"
    from fm3dgan_torch.data.datasets import auto_cache_entries

    return auto_cache_entries(args.input_size or cfg.size)


def downsample_ref(x: np.ndarray, size: int) -> np.ndarray:
    """An NHWC reference batch larger than the generated image (small
    configurations) box-downsampled to ``size``, staying uint8 on the uint8
    path."""
    if x.shape[1] == size:
        return x
    f = x.shape[1] // size
    y = x.reshape(x.shape[0], size, f, size, f, 3).mean(axis=(2, 4))
    if x.dtype == np.uint8:
        return np.clip(np.round(y), 0, 255).astype(np.uint8)
    return y.astype(np.float32)


def _diverged(line, threshold: float) -> bool:
    vals = [line.get("g", 0.0), line.get("l1", 0.0)]
    return threshold > 0 and any(not math.isfinite(v) or abs(v) > threshold for v in vals)


def count_diverged(count: int, lines, threshold: float) -> int:
    """The count of consecutive diverged log lines after ``lines``: each
    diverged line adds one, a healthy line resets it to 0."""
    for line in lines:
        count = count + 1 if _diverged(line, threshold) else 0
    return count


def train_loop(args, cfg: TrainConfig, trainer, start_iter: int, load_batch: Callable,
               ckpt_dir: str, stopper, tags: Callable[[int], str],
               on_sample: Optional[Callable] = None, on_save: Optional[Callable] = None) -> int:
    """Iterations ``start_iter`` .. ``training_iters - 1`` of ``trainer``;
    the exit code (0, or 3 when the divergence guard stops the run).

    ``load_batch(i)`` gives iteration i's staged batch, the arguments of
    ``trainer.train_iteration(i, *batch)``; batch i + 1 is loaded right
    after iteration i is enqueued (double buffering).  Log lines wait until
    ``log_every`` of them are pending (or a sample, a checkpoint, the last
    iteration or a preemption signal is due) and go to
    ``exp_dir/training_log.jsonl`` and stdout, each printed line marked with
    ``tags(i)``.  ``on_sample(i, batch)`` runs every ``val_sample_freq``
    iterations, ``on_save(i, logf)`` ahead of each periodic checkpoint;
    neither runs after a signal, which checkpoints the finished iteration
    and ends the loop."""
    log_path = os.path.join(args.exp_dir, "training_log.jsonl")
    pending: list = []
    diverged_lines = 0
    staged = load_batch(start_iter)
    with open(log_path, "a") as logf:
        for i in range(start_iter, cfg.training_iters):
            t0 = time.time()
            batch = staged
            metrics = trainer.train_iteration(i, *batch)
            # One snapshot per iteration: after a signal, skip the next
            # batch and the hooks, and go straight to the final checkpoint.
            preempt_now = stopper.requested
            load_s = 0.0
            if not preempt_now and i + 1 < cfg.training_iters:
                t_load = time.time()
                staged = load_batch(i + 1)
                load_s = time.time() - t_load
            # Host time of the iteration (the device may still be running it).
            dt = time.time() - t0
            pending.append((i, dt, load_s, metrics))
            sample_due = on_sample is not None and i % cfg.val_sample_freq == 0 and i > 0
            save_due = i % cfg.model_save_freq == 0 and i > 0
            if (len(pending) >= max(1, args.log_every) or i == cfg.training_iters - 1
                    or sample_due or save_due or preempt_now):
                lines = []
                for j, jdt, jload, m in pending:
                    line = {"iter": j, "time_s": round(jdt, 3), "load_s": round(jload, 3),
                            **{k: (float(v) if hasattr(v, "item") else v) for k, v in m.items()}}
                    logf.write(json.dumps(line) + "\n")
                    print(f"[{j}] d={line.get('d', 0):.4f} g={line.get('g', 0):.4f} "
                          f"l1={line.get('l1', 0):.4f} r1={line.get('r1', 0):.4f} "
                          f"ppl={line.get('g_reg', 0):.4f} ({jdt:.2f}s)" + tags(j), flush=True)
                    lines.append(line)
                logf.flush()
                pending.clear()
                diverged_lines = count_diverged(diverged_lines, lines, args.divergence_threshold)
                if diverged_lines >= 2 * max(1, args.log_every):
                    print(f"[{i}] DIVERGENCE: |g| or |l1| beyond {args.divergence_threshold:g} "
                          f"(or non-finite) in {diverged_lines} consecutive log lines: checkpoint "
                          f"{i:06d} and exit 3.  Resume from an earlier checkpoint "
                          f"(--resume_dir {ckpt_dir} --resume_step <last good>), typically "
                          f"with a lower --lr.", flush=True)
                    logf.write(json.dumps({"diverged": i,
                                           "threshold": args.divergence_threshold}) + "\n")
                    logf.flush()
                    trainer.save_checkpoint(ckpt_dir, i)
                    return 3
            if sample_due and not preempt_now:
                on_sample(i, batch)
            if save_due and not preempt_now:
                if on_save is not None:
                    on_save(i, logf)
                trainer.save_checkpoint(ckpt_dir, i)
            if preempt_now:
                stopper.checkpoint_and_exit(trainer, ckpt_dir, i, logf)
                break
    return 0
