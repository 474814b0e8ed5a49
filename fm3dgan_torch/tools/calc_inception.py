"""Image folder -> InceptionV3 (mean, cov) statistics pickle, the
counterpart of ``tools/calc_inception.py``: the real statistics that the FID
of ``fm3dgan_torch.tools.fid`` and of the training CLI's eval lines compare
against.

    python -m fm3dgan_torch.tools.calc_inception --img_dir /data/ffhq_val --out stats.pkl \\
        [--inception_ckpt pt_inception-2015-12-05.pth] [--batch 64] [--n_sample 50000] [--device cpu]

Images are read at 256 px (the reference transform) in name order.  ``--size``
is accepted as the JAX tool takes it; there it only shapes the dummy input
of the random init, and here it changes nothing: the features and the images
are the same with or without it.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--inception_ckpt", default=None,
                   help="pytorch-fid InceptionV3 .pth (random init if absent)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n_sample", type=int, default=50_000)
    p.add_argument("--size", type=int, default=256,
                   help="accepted for the JAX tool's command lines; no effect (no image is resized)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from fm3dgan_torch.data import ImageFolderDataset
    from fm3dgan_torch.eval.fid import compute_inception_stats, save_stats
    from fm3dgan_torch.pipeline.forward import resolve_device
    from fm3dgan_torch.tools.nets import inception_net

    device = resolve_device(args.device)
    model = inception_net(device, args.inception_ckpt)
    dataset = ImageFolderDataset(args.img_dir)
    n = min(args.n_sample, len(dataset))
    feats = []
    with torch.no_grad():
        for i in range(0, n, args.batch):
            batch = np.stack([dataset[j] for j in range(i, min(i + args.batch, n))])
            x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2)
            feats.append(model(x).float().cpu().numpy())
            if (i // args.batch) % 10 == 0:
                print(f"{i + len(batch)}/{n}")
    feats = np.concatenate(feats, axis=0)
    mean, cov = compute_inception_stats(feats)
    save_stats(args.out, mean, cov)
    print(f"saved stats for {feats.shape[0]} images -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
