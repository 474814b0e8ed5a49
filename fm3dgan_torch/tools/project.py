"""GAN-inversion CLI of the port, the counterpart of ``tools/project.py``:
optimise (W, noise maps) so that a checkpoint's EMA generator reconstructs
an image.

    python -m fm3dgan_torch.tools.project --ckpt_dir Exp/ckpt --step 10000 \\
        --image face.png [--steps 1000] [--optimizer adam|lbfgs] [--out recon.png] [--device cpu]

As in the JAX CLI no LPIPS network is given, so the loss stays MSE past
--lpips_start_step.  The image is read at the generator's size (the JAX CLI
reads 256 px, its shipped size); the start is drawn from a seed-0 generator.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--optimizer", default="adam", choices=["adam", "lbfgs"])
    p.add_argument("--lpips_start_step", type=int, default=500)
    p.add_argument("--out", default="projected.png")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from fm3dgan_torch.data.datasets import default_transform, load_image
    from fm3dgan_torch.eval.projector import ProjectorConfig, project_image, psnr
    from fm3dgan_torch.eval.visual_eval import save_image, tensor_to_image
    from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

    models, meta = build_manipulator_from_checkpoint(args.ckpt_dir, args.step, device=args.device)
    g = models.generator
    target = torch.from_numpy(load_image(args.image, default_transform(meta["size"])))
    target = target.permute(2, 0, 1)[None].to(models.device)
    cfg = ProjectorConfig(steps=args.steps, lr=args.lr, optimizer=args.optimizer,
                          lpips_start_step=args.lpips_start_step)
    res = project_image(g, target, torch.Generator().manual_seed(0), config=cfg)
    save_image(args.out, tensor_to_image(res["image"].permute(0, 2, 3, 1))[0])
    print(f"final loss {res['losses'][-1]:.5f}  psnr {psnr(res['image'], target):.2f} dB  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
