"""Photo editing CLI of the port, the serving entry: the counterpart of
``tools/edit.py``.

Runs ``forward_3_encoder`` of a training checkpoint on image files: each
(photo, render) pair gives an edited photo whose pose, expression and
illumination follow the render while identity and appearance follow the
photo.

    # From a checkpoint of the training CLI (EMA generator by default), on cuda:
    python -m fm3dgan_torch.tools.edit --ckpt_dir Exp/ckpt --step 420000 \\
        --photo me.png --render pose1.png pose2.png --out_dir edited/ [--device cpu]

Equal-length lists pair element-wise; one photo and N renders (reanimation)
or N photos and one render (style transfer) pair every photo with every
render.  Writes <photo-stem>__<render-stem>.png, and with --grid a
photo | render | edited strip <photo-stem>__<render-stem>_grid.png.  Pairs
run in batches of --batch (the last one short).  --dtype bfloat16 runs the
modules in bfloat16; the images are written from float32.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def pair_files(photos: List[str], renders: List[str]):
    """Element-wise for equal-length lists, every combination when one side
    is a single file; None otherwise."""
    if len(photos) == len(renders):
        return list(zip(photos, renders))
    if len(photos) == 1 or len(renders) == 1:
        return list(itertools.product(photos, renders))
    return None


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", type=str, required=True,
                   help="checkpoint directory of the training CLI ({step:06d}.pt and .json)")
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--no_ema", action="store_true",
                   help="use the live generator instead of the EMA copy")
    p.add_argument("--photo", type=str, nargs="+", required=True)
    p.add_argument("--render", type=str, nargs="+", required=True)
    p.add_argument("--out_dir", type=str, default="./edited")
    p.add_argument("--input_size", type=int, default=None,
                   help="encoder input resolution (default: the checkpoint's)")
    p.add_argument("--batch", type=int, default=16, help="pairs per forward")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--grid", action="store_true",
                   help="also save photo|render|edited contact sheets")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    p = build_arg_parser()
    args = p.parse_args(argv)
    pairs = pair_files(args.photo, args.render)
    if pairs is None:
        p.error("--photo and --render must be equal-length, or one of them a single file")

    from PIL import Image

    from fm3dgan_torch.data.datasets import default_transform, load_image
    from fm3dgan_torch.eval.visual_eval import save_image, tensor_to_image
    from fm3dgan_torch.pipeline.forward import forward_3_encoder
    from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    models, meta = build_manipulator_from_checkpoint(args.ckpt_dir, args.step,
                                                     use_ema=not args.no_ema,
                                                     device=args.device, dtype=dtype)
    in_size = args.input_size or meta.get("input_size") or meta["size"]
    tf = default_transform(in_size)
    sliced = tuple(meta["sliced_layer"]) if meta.get("sliced_layer") else None

    os.makedirs(args.out_dir, exist_ok=True)
    n_done = 0
    for lo in range(0, len(pairs), args.batch):
        chunk = pairs[lo:lo + args.batch]
        photo = np.stack([load_image(a, tf) for a, _ in chunk])
        render = np.stack([load_image(b, tf) for _, b in chunk])
        out = forward_3_encoder(models, torch.from_numpy(photo), torch.from_numpy(render),
                                tsr_encode=meta.get("tsr_encode", "Render Image"),
                                sliced_layer=sliced, use_tanh=bool(meta.get("use_tanh", False)))
        out = out.float().cpu().numpy()
        for k, (pa, pb) in enumerate(chunk):
            stem_a = os.path.splitext(os.path.basename(pa))[0]
            stem_b = os.path.splitext(os.path.basename(pb))[0]
            dst = os.path.join(args.out_dir, f"{stem_a}__{stem_b}.png")
            save_image(dst, tensor_to_image(out[k]))
            if args.grid:
                tiles = [tensor_to_image(photo[k]), tensor_to_image(render[k]),
                         tensor_to_image(out[k])]
                side = max(t.shape[0] for t in tiles)
                tiles = [t if t.shape[0] == side else
                         np.asarray(Image.fromarray(t).resize((side, side), Image.NEAREST))
                         for t in tiles]
                save_image(os.path.join(args.out_dir, f"{stem_a}__{stem_b}_grid.png"),
                           np.concatenate(tiles, axis=1))
            n_done += 1
            print(f"[{n_done}/{len(pairs)}] {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
