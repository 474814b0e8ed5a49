"""Unconditional FID CLI of the port, the counterpart of ``tools/fid.py``:
the FID of a checkpoint's EMA generator (z samples, fixed noise) against
stored real statistics.

    python -m fm3dgan_torch.tools.fid --ckpt_dir Exp/ckpt --step 10000 --stats ffhq_stats.pkl \\
        [--n_sample 50000] [--batch 100] [--inception_ckpt pt_inception.pth] [--device cpu]

z comes from a seed-0 generator; InceptionV3 has random weights without
--inception_ckpt.  ``--data_parallel`` under ``torchrun --nproc_per_node N``
shards the Inception features of each batch over the processes (NCCL on
cuda, gloo with ``--device cpu``); every process generates the images as one
process does, and rank 0 prints the score.
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
    p.add_argument("--stats", required=True)
    p.add_argument("--n_sample", type=int, default=50_000)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--inception_ckpt", default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the Inception features over torchrun's processes")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    from fm3dgan_torch import parallel
    from fm3dgan_torch.tools.common import run_in_group

    shard = None
    if args.data_parallel:
        shard, device = parallel.init_distributed(device=args.device or "cuda")
        args.device = str(device)
    return run_in_group(shard, lambda: _score(args))


def _score(args) -> int:
    from fm3dgan_torch import parallel
    from fm3dgan_torch.eval.fid import get_model_fid_score
    from fm3dgan_torch.tools.nets import inception_net
    from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

    models, _ = build_manipulator_from_checkpoint(args.ckpt_dir, args.step, device=args.device)
    g, device = models.generator, models.device
    inception = inception_net(device, args.inception_ckpt)
    fid = get_model_fid_score(lambda z: g(z.to(device), randomize_noise=False), inception,
                              args.stats, generator=torch.Generator().manual_seed(0),
                              latent_dim=g.style_dim, n_sample=args.n_sample,
                              batch_size=args.batch, data_parallel=args.data_parallel)
    if parallel.is_main():
        print(f"FID ({args.n_sample} samples): {fid:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
