"""3-encoder training CLI of the port, the counterpart of ``tools/train_3_encoder.py``.

    python -m fm3dgan_torch.tools.train_3_encoder --fake_data --training_iters 20 \\
        --exp_dir Exp/run                     # on cuda; --device cpu for the CPU

Every ``TrainConfig`` field is a flag (booleans take true/false).  Batches
come from the reference directory layouts (``--rec_data_dir`` with img/ and
render_img/, ``--ds_data_dir`` and ``--ep_data_dir`` with id_*/g_K, r_K
pairs) or from ``--fake_data``.  Writes ``exp_dir/training_log.jsonl``, one
line per iteration (iter, time_s, load_s and the iteration's metrics), and
``exp_dir/ckpt/{iter:06d}.pt`` every ``model_save_freq`` iterations;
``--resume_dir DIR --resume_step N`` continues after iteration N.  On
SIGTERM or SIGINT it checkpoints the finished iteration and exits 0.  Its
divergence guard stops a run whose |g| or |l1| is non-finite or above
``--divergence_threshold`` somewhere in two consecutive flushed log windows:
it writes ``{iter:06d}_diverged.pt``, a name resuming by step skips, and
exits 3.  The JAX CLI's evaluation hook, sample grids and multi-host flags
are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np

from fm3dgan_torch.train.config import TrainConfig


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for f in dataclasses.fields(TrainConfig):
        flag = f"--{f.name}"
        if isinstance(f.default, bool):
            p.add_argument(flag, type=_bool, default=f.default)
        elif f.default is None or f.name == "w_plus_sliced_layer":
            p.add_argument(flag, type=str, default=None)
        elif isinstance(f.default, int):
            p.add_argument(flag, type=int, default=f.default)
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=f.default)
        else:
            p.add_argument(flag, type=str, default=f.default)
    p.add_argument("--exp_dir", type=str, default="./Exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    p.add_argument("--input_size", type=int, default=None,
                   help="encoder input resolution (default: --size)")
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--rec_data_dir", type=str, default=None,
                   help="dir with img/ and render_img/ subfolders")
    p.add_argument("--ds_data_dir", type=str, default=None,
                   help="synthetic id_XXXXX/{g,r}_K.png pair dir")
    p.add_argument("--ep_data_dir", type=str, default=None, help="extreme-pose pair dir")
    p.add_argument("--n_data_workers", type=int, default=4)
    p.add_argument("--input_uint8", type=_bool, default=True,
                   help="load batches as uint8 and normalise on the device (a quarter of "
                        "the bytes to copy, same values); false = float32 batches")
    p.add_argument("--cache_decoded", type=str, default="auto", choices=("auto", "true", "false"),
                   help="keep decoded images in host memory: auto caps the cache at about "
                        "25%% of available memory, true is unbounded")
    p.add_argument("--divergence_threshold", type=float, default=1e6,
                   help="stop (checkpoint {iter}_diverged, exit 3) when |g| or |l1| exceeds "
                        "this, or is non-finite, in two consecutive flushed log windows; "
                        "0 disables")
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--resume_step", type=int, default=None)
    p.add_argument("--log_every", type=int, default=10,
                   help="read the metrics back every N iterations (each read waits for "
                        "the device); 1 logs every iteration as it ends")
    return p


def config_from_args(args) -> TrainConfig:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)}
    if isinstance(kw["w_plus_sliced_layer"], str):
        kw["w_plus_sliced_layer"] = tuple(int(x) for x in kw["w_plus_sliced_layer"].split(","))
    return TrainConfig(**kw)


def _resolve_cache(args, cfg):
    if args.cache_decoded != "auto":
        return args.cache_decoded == "true"
    from fm3dgan_torch.data.datasets import auto_cache_entries

    return auto_cache_entries(args.input_size or cfg.size)


def make_loaders(args, cfg: TrainConfig):
    """(reconstruction, dual-supervision, extreme-pose or None) batch sources."""
    size = args.input_size or cfg.size
    if args.fake_data:
        from fm3dgan_torch.data import RandomFakeData

        return (RandomFakeData(cfg.rec_batch, size, seed=1), RandomFakeData(cfg.ds_batch, size, seed=2),
                RandomFakeData(cfg.ds_batch * 2, size, seed=3))
    from fm3dgan_torch.data import (
        DataLoader,
        ReconstructionDataset,
        SyntheticPairDataset,
        dual_supervision_indices,
        extreme_pose_indices,
    )
    from fm3dgan_torch.data.datasets import default_transform, uint8_transform

    if not (args.rec_data_dir and args.ds_data_dir):
        raise SystemExit("give --rec_data_dir and --ds_data_dir, or --fake_data")
    transform = uint8_transform(size) if args.input_uint8 else default_transform(size)
    cache = _resolve_cache(args, cfg)
    rec_set = ReconstructionDataset(os.path.join(args.rec_data_dir, "img"),
                                    os.path.join(args.rec_data_dir, "render_img"),
                                    transform=transform, cache=cache)
    rec = DataLoader(rec_set, cfg.rec_batch, num_workers=args.n_data_workers)
    ds_set = SyntheticPairDataset(args.ds_data_dir, transform=transform, cache=cache)
    ds = DataLoader(ds_set, cfg.ds_batch, num_workers=args.n_data_workers,
                    index_sampler=lambda rng: dual_supervision_indices(
                        len(ds_set), ds_set.n_img_per_id, rng))
    ep = None
    if args.ep_data_dir:
        ep_set = SyntheticPairDataset(args.ep_data_dir, transform=transform, cache=cache)
        ep = DataLoader(ep_set, cfg.ds_batch * 2,  # halved by the even-index slice
                        num_workers=args.n_data_workers,
                        index_sampler=lambda rng: extreme_pose_indices(
                            len(ep_set), ep_set.n_img_per_id, rng))
    return rec, ds, ep


def _diverged(line, threshold: float) -> bool:
    vals = [line.get("g", 0.0), line.get("l1", 0.0)]
    return threshold > 0 and any(not math.isfinite(v) or abs(v) > threshold for v in vals)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)

    from fm3dgan_torch.data import data_loading
    from fm3dgan_torch.train.loop import Trainer
    from fm3dgan_torch.train.preempt import GracefulShutdown

    ckpt_dir = os.path.join(args.exp_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    trainer = Trainer(cfg, seed=args.seed, device=args.device, input_size=args.input_size)
    start_iter = 0
    if args.resume_dir:
        trainer.load_checkpoint(args.resume_dir, args.resume_step)
        start_iter = args.resume_step + 1
    rec, ds, ep = make_loaders(args, cfg)

    def load_batch(i):
        g_input, r_input, g_ref = data_loading(rec, ds, cfg.is_ds_iter(i), extreme_loader=ep or ds,
                                               extreme_ds_flag=cfg.is_extreme_ds_iter(i))
        if g_ref.shape[1] != cfg.size:
            # Encoder inputs larger than the generated image (small
            # configurations): box-downsample the references to its size,
            # staying uint8 on the uint8 path.
            f = g_ref.shape[1] // cfg.size
            dtype = g_ref.dtype
            g_ref = g_ref.reshape(g_ref.shape[0], cfg.size, f, cfg.size, f, 3).mean(axis=(2, 4))
            g_ref = (np.clip(np.round(g_ref), 0, 255).astype(np.uint8) if dtype == np.uint8
                     else g_ref.astype(np.float32))
        return g_input, r_input, g_ref

    if args.fake_data:
        # The fake sources are seeded streams: a resumed run draws past the
        # batches of the iterations already run, so it reads what the
        # uninterrupted run read.
        for i in range(start_iter):
            data_loading(rec, ds, cfg.is_ds_iter(i), extreme_loader=ep or ds,
                         extreme_ds_flag=cfg.is_extreme_ds_iter(i))

    stopper = GracefulShutdown()
    try:
        return _train(args, cfg, trainer, start_iter, load_batch, ckpt_dir, stopper)
    finally:
        stopper.restore()


def _train(args, cfg, trainer, start_iter, load_batch, ckpt_dir, stopper) -> int:
    log_path = os.path.join(args.exp_dir, "training_log.jsonl")
    pending: list = []
    diverged_windows = 0
    # Double-buffered input: batch i is on the device (or on its way) when
    # iteration i is enqueued; batch i + 1's copy starts right after.
    staged = trainer.stage_batch(*load_batch(start_iter))
    with open(log_path, "a") as logf:
        for i in range(start_iter, cfg.training_iters):
            t0 = time.time()
            ds_flag, ep_flag = cfg.is_ds_iter(i), cfg.is_extreme_ds_iter(i)
            metrics = trainer.train_iteration(i, *staged)
            # One snapshot per iteration: after a signal, skip the next batch
            # and go straight to the final checkpoint.
            preempt_now = stopper.requested
            load_s = 0.0
            if not preempt_now and i + 1 < cfg.training_iters:
                t_load = time.time()
                staged = trainer.stage_batch(*load_batch(i + 1))
                load_s = time.time() - t_load
            # Host time of the iteration (the device may still be running it).
            dt = time.time() - t0
            pending.append((i, dt, load_s, ds_flag, ep_flag, metrics))
            if (len(pending) >= max(1, args.log_every) or i == cfg.training_iters - 1
                    or (i % cfg.val_sample_freq == 0 and i > 0)
                    or (i % cfg.model_save_freq == 0 and i > 0) or preempt_now):
                window_diverged = False
                for j, jdt, jload, jds, jep, m in pending:
                    line = {"iter": j, "time_s": round(jdt, 3), "load_s": round(jload, 3),
                            **{k: (float(v) if hasattr(v, "item") else v) for k, v in m.items()}}
                    logf.write(json.dumps(line) + "\n")
                    print(f"[{j}] d={line.get('d', 0):.4f} g={line.get('g', 0):.4f} "
                          f"l1={line.get('l1', 0):.4f} r1={line.get('r1', 0):.4f} "
                          f"ppl={line.get('g_reg', 0):.4f} ({jdt:.2f}s)"
                          + (" [DS]" if jds else "") + (" [EP]" if jep else ""), flush=True)
                    window_diverged |= _diverged(line, args.divergence_threshold)
                logf.flush()
                pending.clear()
                diverged_windows = diverged_windows + 1 if window_diverged else 0
                if diverged_windows >= 2:
                    print(f"[{i}] DIVERGENCE: |g| or |l1| beyond {args.divergence_threshold:g} "
                          f"(or non-finite) in 2 consecutive log windows: checkpoint "
                          f"{i:06d}_diverged and exit 3.  Resume from an earlier checkpoint "
                          f"(--resume_dir {ckpt_dir} --resume_step <last good>), typically "
                          f"with a lower --lr.", flush=True)
                    logf.write(json.dumps({"diverged": i,
                                           "threshold": args.divergence_threshold}) + "\n")
                    logf.flush()
                    trainer.save_checkpoint(ckpt_dir, i, tag="_diverged")
                    return 3
            if i % cfg.model_save_freq == 0 and i > 0 and not preempt_now:
                trainer.save_checkpoint(ckpt_dir, i)
            if preempt_now:
                stopper.checkpoint_and_exit(trainer, ckpt_dir, i, logf)
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
