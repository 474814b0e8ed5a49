"""2-encoder training CLI of the port, the counterpart of ``tools/train_2_encoder.py``.

    python -m fm3dgan_torch.tools.train_2_encoder --fake_data --training_iters 20 \\
        --co_mod "Tensor Transform" --ds_dataset_type FFHQ \\
        --exp_dir Exp2/run                    # on cuda; --device cpu for the CPU

A tensor encoder and a modulation encoder (``--mod_encode`` names the
modulation encoder's input without co-modulation; ``--co_mod`` picks
Multiplication, Concatenation or Tensor Transform) train with G, D and, with
``--ds_dataset_type FFHQ``, D_ffhq: on each dual-supervision iteration the
edit of a photo by another face's render is judged against FFHQ photos
(``--ffhq_data_dir``) and then replaces the photo for the iteration's D and G
steps.  LPIPS and ArcFace are built when their loss weights are above 0.
Every ``TrainConfig`` field is a flag (booleans take true/false).

Batches come from the reference directory layouts (``--rec_data_dir`` with
img/ and render_img/; ``--ds_data_dir`` with id_*/g_K, r_K pairs, or for
FFHQ dual supervision img/, render_img/ and edit_render_img/) or from
``--fake_data``.  Writes ``exp_dir/training_log.jsonl``, one line per
iteration (iter, time_s, load_s and the iteration's losses), and
``exp_dir/ckpt/{iter:06d}.pt`` every ``model_save_freq`` iterations;
``--resume_dir DIR --resume_step N`` continues after iteration N.  On SIGTERM
or SIGINT it checkpoints the finished iteration and exits 0; its divergence
guard counts consecutive log lines whose |g| or |l1| is non-finite or above
``--divergence_threshold`` and at ``2 * log_every`` of them writes
``{iter:06d}.pt`` and exits 3.  Like the JAX CLI it writes no sample grids
and runs no evaluation; the JAX CLI's mesh and multi-host flags are not
ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from fm3dgan_torch.pipeline.forward import CO_MODULATION_MODE, MODULATION_ENCODING
from fm3dgan_torch.tools.common import (
    add_config_flags,
    config_from_args,
    downsample_ref,
    parse_bool,
    resolve_cache,
    train_loop,
)
from fm3dgan_torch.train.loop2 import DS_DATASET_TYPES, Trainer2


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_config_flags(p)
    p.add_argument("--exp_dir", type=str, default="./Exp2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    p.add_argument("--input_size", type=int, default=None,
                   help="encoder input resolution (default: --size)")
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--rec_data_dir", type=str, default=None,
                   help="dir with img/ and render_img/ subfolders")
    p.add_argument("--ds_data_dir", type=str, default=None,
                   help="synthetic id_XXXXX/{g,r}_K.png pair dir, or the FFHQ editing layout "
                        "(img/, render_img/, edit_render_img/) for --ds_dataset_type FFHQ")
    p.add_argument("--ffhq_data_dir", type=str, default=None,
                   help="flat FFHQ image folder (D_ffhq's reals)")
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
    p.add_argument("--mod_encode", default="Render Image", choices=MODULATION_ENCODING)
    p.add_argument("--co_mod", default=None, choices=CO_MODULATION_MODE)
    p.add_argument("--ds_dataset_type", default="Synthetic", choices=DS_DATASET_TYPES)
    return p


class _EditPairs:
    """(photo, edit render) batches of an EditingDataset loader in train
    mode, which yields (photo, its own render, an edit render)."""

    def __init__(self, loader):
        self.loader = loader

    def __next__(self):
        photo, _own, edit = next(self.loader)
        return photo, edit


def make_loaders(args, cfg):
    """(reconstruction, dual-supervision, FFHQ reals or None) batch sources;
    the FFHQ reals are at the generator's size, the rest at the encoders'."""
    size = args.input_size or cfg.size
    if args.fake_data:
        from fm3dgan_torch.data import RandomFakeData

        return (RandomFakeData(cfg.rec_batch, size, seed=1), RandomFakeData(cfg.ds_batch, size, seed=2),
                RandomFakeData(cfg.ds_batch, cfg.size, seed=3))
    from fm3dgan_torch.data import (
        DataLoader,
        EditingDataset,
        ImageFolderDataset,
        ReconstructionDataset,
        SyntheticPairDataset,
        dual_supervision_indices,
    )
    from fm3dgan_torch.data.datasets import default_transform, uint8_transform

    ffhq_ds = args.ds_dataset_type == "FFHQ"
    if not (args.rec_data_dir and args.ds_data_dir and (args.ffhq_data_dir or not ffhq_ds)):
        raise SystemExit("give --rec_data_dir and --ds_data_dir (and --ffhq_data_dir for "
                         "--ds_dataset_type FFHQ), or --fake_data")
    transform_at = lambda s: uint8_transform(s) if args.input_uint8 else default_transform(s)  # noqa: E731
    transform = transform_at(size)
    cache = resolve_cache(args, cfg)
    rec_set = ReconstructionDataset(os.path.join(args.rec_data_dir, "img"),
                                    os.path.join(args.rec_data_dir, "render_img"),
                                    transform=transform, cache=cache)
    rec = DataLoader(rec_set, cfg.rec_batch, num_workers=args.n_data_workers)
    if not ffhq_ds:
        ds_set = SyntheticPairDataset(args.ds_data_dir, transform=transform, cache=cache)
        ds = DataLoader(ds_set, cfg.ds_batch, num_workers=args.n_data_workers,
                        index_sampler=lambda rng: dual_supervision_indices(
                            len(ds_set), ds_set.n_img_per_id, rng))
        return rec, ds, None
    ds_set = EditingDataset(os.path.join(args.ds_data_dir, "img"),
                            os.path.join(args.ds_data_dir, "edit_render_img"),
                            render_image_folder=os.path.join(args.ds_data_dir, "render_img"),
                            train=True, transform=transform, cache=cache)
    ds = _EditPairs(DataLoader(ds_set, cfg.ds_batch, num_workers=args.n_data_workers))
    ffhq_set = ImageFolderDataset(args.ffhq_data_dir, transform=transform_at(cfg.size), cache=cache)
    return rec, ds, DataLoader(ffhq_set, cfg.ds_batch, num_workers=args.n_data_workers)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)

    from fm3dgan_torch.data import data_loading
    from fm3dgan_torch.train.preempt import GracefulShutdown

    ckpt_dir = os.path.join(args.exp_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    trainer = Trainer2(cfg, seed=args.seed, mod_encode=args.mod_encode, co_modulation=args.co_mod,
                       ds_dataset_type=args.ds_dataset_type,
                       use_lpips=cfg.lpips_loss_lambda > 0,
                       use_arcface=cfg.face_id_loss_lambda > 0, device=args.device,
                       input_size=args.input_size)
    start_iter = 0
    if args.resume_dir:
        trainer.load_checkpoint(args.resume_dir, args.resume_step)
        start_iter = args.resume_step + 1
    rec, ds, ffhq = make_loaders(args, cfg)

    def draw(i):
        """The iteration's raw batches: (photo, render, ref, FFHQ reals or None)."""
        if cfg.is_ds_iter(i) and args.ds_dataset_type == "FFHQ":
            g_input, r_input = next(ds)
            # The reference is the photo itself, at the generator's size.
            return g_input, r_input, g_input, next(ffhq)[0]
        return (*data_loading(rec, ds, cfg.is_ds_iter(i)), None)

    def load_batch(i):
        g_input, r_input, g_ref, ffhq_ref = draw(i)
        staged = trainer.stage_batch(g_input, r_input, downsample_ref(g_ref, cfg.size))
        if ffhq_ref is None:
            return staged + (None,)
        return staged + trainer.stage_batch(downsample_ref(ffhq_ref, cfg.size))

    if args.fake_data:
        # The fake sources are seeded streams: a resumed run draws past the
        # batches of the iterations already run, so it reads what the
        # uninterrupted run read.
        for i in range(start_iter):
            draw(i)

    stopper = GracefulShutdown()
    try:
        return train_loop(args, cfg, trainer, start_iter, load_batch, ckpt_dir, stopper,
                          tags=lambda i: " [DS]" if cfg.is_ds_iter(i) else "")
    finally:
        stopper.restore()


if __name__ == "__main__":
    sys.exit(main())
