"""3-encoder training CLI of the port, the counterpart of ``tools/train_3_encoder.py``.

    python -m fm3dgan_torch.tools.train_3_encoder --fake_data --training_iters 20 \\
        --exp_dir Exp/run                     # on cuda; --device cpu for the CPU

Every ``TrainConfig`` field is a flag (booleans take true/false).  Batches
come from the reference directory layouts (``--rec_data_dir`` with img/ and
render_img/, ``--ds_data_dir`` and ``--ep_data_dir`` with id_*/g_K, r_K
pairs) or from ``--fake_data``.  Writes ``exp_dir/training_log.jsonl``, one
line per iteration (iter, time_s, load_s and the iteration's metrics), and
``exp_dir/ckpt/{iter:06d}.pt`` every ``model_save_freq`` iterations;
``--resume_dir DIR --resume_step N`` continues after iteration N.

Every ``val_sample_freq`` iterations it writes ``exp_dir/sample/{iter:06d}.png``,
a grid of the EMA generator's edits of a fixed validation set (``.npy``
bundles from ``--val_bundle_dir``, identities of ``--ds_data_dir``, or a
seeded random set with ``--fake_data``).  Every ``model_save_freq``
iterations, before the checkpoint, it scores the EMA generator on held-out
batches (``--rec_eval_dir``, ``--edit_eval_dir``, or random ones with
``--fake_data``) and appends ``{"eval": {...}}`` to the log: identity
cosine, LPIPS and L1 of the reconstruction; identity cosine, FID (with
``--fid_stats_path``; InceptionV3 from ``--inception_ckpt``, a pytorch-fid
``.pth``, else random weights) and face-regional error of the edit, its
heatmap and landmark errors NaN as in the JAX CLI.  ``--hmap_loss_lambda``
above 0 adds the FAN heatmap loss past ``--hmap_iter_thres``, with FAN's
input at ``--fan_input_size``.

On SIGTERM or SIGINT it checkpoints the finished iteration, skips the grid
and the scores, and exits 0.  Its divergence guard counts consecutive log
lines whose |g| or |l1| is non-finite or above ``--divergence_threshold``
(a healthy line resets the count); at ``2 * log_every`` of them it writes
``{iter:06d}.pt`` and exits 3.  The JAX CLI's mesh and multi-host flags are
not ported yet.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional

import numpy as np

from fm3dgan_torch.tools.common import (
    add_config_flags,
    config_from_args,
    downsample_ref,
    parse_bool,
    resolve_cache,
    train_loop,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_config_flags(p)
    p.add_argument("--exp_dir", type=str, default="./Exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    p.add_argument("--input_size", type=int, default=None,
                   help="encoder input resolution (default: --size)")
    p.add_argument("--fan_input_size", type=int, default=256,
                   help="heatmap FAN input resolution (256 for the pretrained 2DFAN-4 "
                        "weights; a multiple of 64)")
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--rec_data_dir", type=str, default=None,
                   help="dir with img/ and render_img/ subfolders")
    p.add_argument("--ds_data_dir", type=str, default=None,
                   help="synthetic id_XXXXX/{g,r}_K.png pair dir")
    p.add_argument("--ep_data_dir", type=str, default=None, help="extreme-pose pair dir")
    p.add_argument("--rec_eval_dir", type=str, default=None,
                   help="held-out reconstruction eval dir (img/ and render_img/)")
    p.add_argument("--edit_eval_dir", type=str, default=None,
                   help="held-out edit eval dir (img/ and edit_render_img/)")
    p.add_argument("--fid_stats_path", type=str, default=None,
                   help="real-image InceptionV3 statistics (a pickle of mean and cov) for "
                        "the edit score's FID")
    p.add_argument("--inception_ckpt", type=str, default=None,
                   help="pytorch-fid InceptionV3 .pth for the FID (default: random weights)")
    p.add_argument("--n_eval_batches", type=int, default=None,
                   help="cap on the eval batches of each score")
    p.add_argument("--val_bundle_dir", type=str, default=None,
                   help="dir of .npy visual validation bundles")
    p.add_argument("--n_real_eval_faces", type=int, default=2)
    p.add_argument("--n_syn_eval_faces", type=int, default=2)
    p.add_argument("--n_data_workers", type=int, default=4)
    p.add_argument("--input_uint8", type=parse_bool, default=True,
                   help="load batches as uint8 and normalise on the device (a quarter of "
                        "the bytes to copy, same values); false = float32 batches")
    p.add_argument("--cache_decoded", type=str, default="auto", choices=("auto", "true", "false"),
                   help="keep decoded images in host memory: auto caps the cache at about "
                        "25%% of available memory, true is unbounded")
    p.add_argument("--divergence_threshold", type=float, default=1e6,
                   help="stop (checkpoint, exit 3) after 2 * log_every consecutive log lines "
                        "whose |g| or |l1| exceeds this or is non-finite; 0 disables")
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--resume_step", type=int, default=None)
    p.add_argument("--log_every", type=int, default=10,
                   help="read the metrics back every N iterations (each read waits for "
                        "the device); 1 logs every iteration as it ends")
    return p


def make_loaders(args, cfg):
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
    cache = resolve_cache(args, cfg)
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


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)

    from fm3dgan_torch.data import data_loading
    from fm3dgan_torch.train.loop import Trainer
    from fm3dgan_torch.train.preempt import GracefulShutdown

    ckpt_dir = os.path.join(args.exp_dir, "ckpt")
    sample_dir = os.path.join(args.exp_dir, "sample")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(sample_dir, exist_ok=True)
    trainer = Trainer(cfg, seed=args.seed, device=args.device, input_size=args.input_size,
                      fan_input_size=args.fan_input_size)
    start_iter = 0
    if args.resume_dir:
        trainer.load_checkpoint(args.resume_dir, args.resume_step)
        start_iter = args.resume_step + 1
    rec, ds, ep = make_loaders(args, cfg)
    eval_hook = _make_eval_hook(args, cfg, trainer)
    val_sets = _make_val_sets(args, cfg)

    def load_batch(i):
        g_input, r_input, g_ref = data_loading(rec, ds, cfg.is_ds_iter(i), extreme_loader=ep or ds,
                                               extreme_ds_flag=cfg.is_extreme_ds_iter(i))
        return g_input, r_input, downsample_ref(g_ref, cfg.size)

    if args.fake_data:
        # The fake sources are seeded streams: a resumed run draws past the
        # batches of the iterations already run, so it reads what the
        # uninterrupted run read.
        for i in range(start_iter):
            data_loading(rec, ds, cfg.is_ds_iter(i), extreme_loader=ep or ds,
                         extreme_ds_flag=cfg.is_extreme_ds_iter(i))

    def on_sample(i, batch):
        if val_sets is not None:
            _save_val_set_grid(trainer, val_sets, sample_dir, i)
        else:
            _save_sample_grid(trainer, batch[0], batch[1], sample_dir, i)

    def on_save(i, logf):
        if eval_hook is None:
            return
        scores = eval_hook(i)
        logf.write(json.dumps({"eval": scores}) + "\n")
        logf.flush()
        printable = {k: round(v, 4) for k, v in scores.items()
                     if isinstance(v, float) and math.isfinite(v)}
        print(f"[{i}] quant eval: {printable}", flush=True)

    def tags(i):
        return (" [DS]" if cfg.is_ds_iter(i) else "") + (" [EP]" if cfg.is_extreme_ds_iter(i) else "")

    stopper = GracefulShutdown()
    try:
        return train_loop(args, cfg, trainer, start_iter,
                          lambda i: trainer.stage_batch(*load_batch(i)), ckpt_dir, stopper, tags,
                          on_sample=on_sample, on_save=on_save)
    finally:
        stopper.restore()


def _make_eval_hook(args, cfg, trainer):
    """The quantitative-eval hook of the run, or None without eval data."""
    from fm3dgan_torch.train.eval_hook import (
        QuantEvalHook,
        make_dir_eval_batches,
        make_fake_eval_batches,
    )

    size = args.input_size or cfg.size
    if args.rec_eval_dir or args.edit_eval_dir:
        from fm3dgan_torch.data.datasets import default_transform

        rec_fn, edit_fn = make_dir_eval_batches(args.rec_eval_dir, args.edit_eval_dir,
                                                cfg.quant_eval_batch_size,
                                                n_batches=args.n_eval_batches,
                                                transform=default_transform(size))
    elif args.fake_data:
        rec_fn, edit_fn = make_fake_eval_batches(size, batch=2, n_batches=args.n_eval_batches or 1)
    else:
        return None

    inception_fn = real_stats = None
    if args.fid_stats_path:
        import torch

        from fm3dgan_torch.eval.fid import load_stats
        from fm3dgan_torch.models.inception import InceptionV3Pool3, fid_inception_state_dict

        real_stats = load_stats(args.fid_stats_path)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            inception = InceptionV3Pool3()
        if args.inception_ckpt:
            sd = torch.load(args.inception_ckpt, map_location="cpu", weights_only=True)
            inception.load_state_dict(fid_inception_state_dict(sd, inception))
        else:
            print("WARNING: random-init inception features for in-loop FID", flush=True)
        inception_fn = inception.requires_grad_(False).eval().to(trainer.device)

    return QuantEvalHook(trainer, rec_batches=rec_fn, edit_batches=edit_fn,
                         inception_fn=inception_fn, real_stats=real_stats)


def _make_val_sets(args, cfg):
    """The fixed visual validation set: .npy bundles and/or synthetic
    identities, or a seeded random set for --fake_data; None if none."""
    import glob

    size = args.input_size or cfg.size
    rng = np.random.RandomState(args.seed + 77)
    sets = []
    if args.val_bundle_dir:
        from fm3dgan_torch.eval.visual_eval import get_real_img_val_sample

        paths = sorted(glob.glob(os.path.join(args.val_bundle_dir, "*.npy")))
        sets += get_real_img_val_sample(paths, args.n_real_eval_faces, size=size, rng=rng)
    if args.ds_data_dir and not args.fake_data:
        from fm3dgan_torch.data import SyntheticPairDataset
        from fm3dgan_torch.data.datasets import default_transform
        from fm3dgan_torch.eval.visual_eval import get_syn_img_val_sample

        ds_set = SyntheticPairDataset(args.ds_data_dir, transform=default_transform(size))
        sets += get_syn_img_val_sample(ds_set, args.n_syn_eval_faces,
                                       n_img_per_id=ds_set.n_img_per_id, rng=rng)
    if not sets and args.fake_data:
        sets = [rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32) for _ in range(6)]
    return sets or None


def _save_val_set_grid(trainer, val_sets, sample_dir, step):
    from fm3dgan_torch.eval.visual_eval import get_val_sample_grid, grid_to_image, save_image
    from fm3dgan_torch.train.eval_hook import ema_forward_fn

    grid = get_val_sample_grid(ema_forward_fn(trainer), val_sets)
    save_image(os.path.join(sample_dir, f"{step:06d}.png"), grid_to_image(grid))


def _save_sample_grid(trainer, photos, renders, sample_dir, step, n=4):
    """Photo x render editing grid of the training batch, from g_ema."""
    from fm3dgan_torch.eval.visual_eval import get_batch_eval_result, grid_to_image, save_image
    from fm3dgan_torch.train.eval_hook import ema_forward_fn
    from fm3dgan_torch.train.steps import prepare_batch

    # NHWC float in [-1, 1] on the host (the batch may be uint8, on the device).
    photos, renders = (prepare_batch(a[:n], "cpu").permute(0, 2, 3, 1).numpy()
                       for a in (photos, renders))
    grid = get_batch_eval_result(ema_forward_fn(trainer), photos, renders)
    save_image(os.path.join(sample_dir, f"{step:06d}.png"), grid_to_image(grid))


if __name__ == "__main__":
    sys.exit(main())
