"""Quantitative evaluation CLI of the port, the counterpart of
``tools/quant_eval.py``: the reconstruction and edit scores of a
checkpoint's EMA generator and encoders on directory layouts.

    python -m fm3dgan_torch.tools.quant_eval --ckpt_dir Exp/ckpt --step 10000 \\
        --recon_dir /data/val --edit_dir /data/val \\
        [--arcface_ckpt resnet18_arcfacenet.pth] [--lpips_heads vgg.pth] \\
        [--inception_ckpt pt_inception.pth] [--ffhq_stats stats.pkl] [--device cpu]

--recon_dir holds img/ and render_img/, --edit_dir img/ and edit_render_img/
(four renders per photo).  As in the JAX CLI, batches come from the
prefetching loader (seed 0, the tail batch kept) and max(1, len // batch) of
them are scored, so a short tail is left out.  ArcFace takes 128 px faces
(the reference's weights), other sizes resized; an edited image smaller than
the photos (small configurations) is resized up to them.  A scorer without
its ``.pth`` has random weights; FID needs --ffhq_stats; FAN's heatmap and
landmark errors are NaN, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from typing import List, Optional

import torch


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--recon_dir", default=None,
                   help="dir with img/ + render_img/ for reconstruction eval")
    p.add_argument("--edit_dir", default=None,
                   help="dir with img/ + edit_render_img/ for editing eval")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--edit_batch", type=int, default=16)
    p.add_argument("--arcface_ckpt", default=None)
    p.add_argument("--lpips_heads", default=None)
    p.add_argument("--vgg_backbone", default=None)
    p.add_argument("--inception_ckpt", default=None)
    p.add_argument("--ffhq_stats", default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from fm3dgan_torch.data import DataLoader, EditingDataset, ReconstructionDataset
    from fm3dgan_torch.data.datasets import default_transform
    from fm3dgan_torch.eval.quant_eval import get_edit_score, get_recon_score
    from fm3dgan_torch.nn.resize import resize_bilinear
    from fm3dgan_torch.pipeline.forward import forward_3_encoder
    from fm3dgan_torch.tools.nets import arcface_net, inception_net, lpips_net
    from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

    models, meta = build_manipulator_from_checkpoint(args.ckpt_dir, args.step, device=args.device)
    device = models.device
    transform = default_transform(meta.get("input_size") or meta["size"])
    sliced = tuple(meta["sliced_layer"]) if meta.get("sliced_layer") else None

    def forward_fn(photo, render):
        # On the bundle's device, so that the image stays there for the scorers.
        photo = torch.as_tensor(photo).to(device)
        img = forward_3_encoder(models, photo, torch.as_tensor(render).to(device),
                                tsr_encode=meta["tsr_encode"], sliced_layer=sliced,
                                use_tanh=meta["use_tanh"]).float()
        if img.shape[1] != photo.shape[1]:
            img = resize_bilinear(img.permute(0, 3, 1, 2), photo.shape[1]).permute(0, 2, 3, 1)
        return img

    arcface = arcface_net(device, args.arcface_ckpt)
    face_rec_fn = lambda x: arcface(resize_bilinear(x, 128))  # noqa: E731

    if args.recon_dir:
        lpips = lpips_net(device, args.lpips_heads, args.vgg_backbone)
        ds = ReconstructionDataset(os.path.join(args.recon_dir, "img"),
                                   os.path.join(args.recon_dir, "render_img"), transform=transform)
        loader = DataLoader(ds, args.batch, drop_last=False)
        n_batches = max(1, len(ds) // args.batch)
        cos, lpips_v, l1 = get_recon_score(itertools.islice(loader, n_batches), forward_fn,
                                           face_rec_fn, lpips, info_print=True)
        print(f"RECON  id-cosine={cos:.4f}  lpips={lpips_v:.4f}  l1={l1:.4f}")

    if args.edit_dir:
        inception = inception_net(device, args.inception_ckpt)
        ds = EditingDataset(os.path.join(args.edit_dir, "img"),
                            os.path.join(args.edit_dir, "edit_render_img"), transform=transform)
        loader = DataLoader(ds, args.edit_batch, drop_last=False)
        n_batches = max(1, len(ds) // args.edit_batch)
        cos, fid, hmap, lmark, freg = get_edit_score(
            itertools.islice(loader, n_batches), forward_fn, face_rec_fn, inception,
            real_stats_path=args.ffhq_stats, info_print=True)
        print(f"EDIT   id-cosine={cos:.4f}  fid={fid:.2f}  hmap={hmap:.4f}  "
              f"lmark={lmark:.4f}  face-reg={freg:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
