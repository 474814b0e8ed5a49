"""PPL CLI of the port, the counterpart of ``tools/ppl.py``: the perceptual
path length of a checkpoint's EMA generator.

    python -m fm3dgan_torch.tools.ppl --ckpt_dir Exp/ckpt --step 10000 \\
        [--n_sample 5000] [--batch 16] [--eps 1e-4] [--lpips_heads vgg.pth \\
        [--vgg_backbone vgg16.pth]] [--device cpu]

--lpips_heads (LPIPS v0.1 heads) and --vgg_backbone (torchvision VGG16)
load into the port's LPIPS as they are; without them LPIPS has random
weights.  z and t come from a seed-0 generator.
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
    p.add_argument("--n_sample", type=int, default=5000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--eps", type=float, default=1e-4)
    p.add_argument("--lpips_heads", default=None, help="LPIPS v0.1 vgg heads .pth (linear weights)")
    p.add_argument("--vgg_backbone", default=None, help="torchvision VGG16 state dict .pth")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from fm3dgan_torch.eval.ppl import get_ppl_score
    from fm3dgan_torch.tools.nets import lpips_net
    from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

    models, _ = build_manipulator_from_checkpoint(args.ckpt_dir, args.step, device=args.device)
    g, device = models.generator, models.device
    lpips = lpips_net(device, args.lpips_heads, args.vgg_backbone)
    ppl = get_ppl_score(
        lambda z: g.get_latent(z.to(device)),
        lambda w: g(input_is_latent=True, latent_styles=[w], randomize_noise=False),
        lpips, n_sample=args.n_sample, batch_size=args.batch, latent_dim=g.style_dim,
        eps=args.eps, generator=torch.Generator().manual_seed(0), info_print=True)
    print(f"PPL: {ppl:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
