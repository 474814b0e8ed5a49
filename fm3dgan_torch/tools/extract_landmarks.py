"""Batch facial-landmark extraction over an image directory: the counterpart
of ``tools/extract_landmarks.py``.

For each face image, detect the face with S3FD (single face, full-image
fallback), crop it with the 0.12 vertical offset, run FAN's 68 heatmaps,
decode them back to the original frame and write one ``<image_name>.txt``
with the 5 keypoints (left eye, right eye, nose, left and right mouth
corner; ``landmarks_68_to_5``) as ``x y`` lines, the reference's
Write_Detection_Result format; with ``--points 68`` all 68 points.

    python -m fm3dgan_torch.tools.extract_landmarks --img_dir faces/ --out_dir lms/ \\
        --sfd_ckpt s3fd.pth --fan_ckpt 2DFAN4.pth [--points 68] [--device cpu]

The checkpoints load in their public torch layout (s3fd; 2DFAN-4 without
the ``conv_last``/``bl``/``al`` biases, which FAN does not have and the JAX
converter drops too); ``--random_init`` runs the stack with seeded random
weights (S3FD from seed 0, FAN from seed 1): the landmarks are meaningless,
but the pipeline and the file contract run end to end.  The nets run on the
device (cuda unless ``--device cpu``), the box decode and crops on the host.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import List, Optional

import numpy as np
import torch

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
# FAN's biases that face-alignment's 2DFAN-4 has and FAN lacks.
_FAN_EXTRA = re.compile(r"^(conv_last|bl|al)\d+\.bias$")


def _load_image(path: str, size: Optional[int]):
    """One decode per file: (pixels resized to size², original (w, h))."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        orig_size = img.size
        if size is not None and img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.float32), orig_size


def _write_landmarks(path: str, lm: np.ndarray) -> None:
    # Write_Detection_Result format: one "x y" line per keypoint.
    with open(path, "w") as f:
        for x, y in lm:
            f.write(f"{x} {y}\n")


def build_stack(args, device):
    """(detector_fn, fan_fn): S3FD's maps and FAN's heatmaps on ``device``."""
    from fm3dgan_torch.models.fan_landmark import FAN
    from fm3dgan_torch.models.sfd_detector import S3FD, sfd_detector_fn
    from fm3dgan_torch.tools.nets import frozen, load_reference_state_dict, seeded

    if not (args.random_init or (args.sfd_ckpt and args.fan_ckpt)):
        raise SystemExit("--sfd_ckpt and --fan_ckpt are required "
                         "(or pass --random_init for a smoke run)")
    sfd = seeded(S3FD, 0)
    fan = seeded(FAN, 1)
    if not args.random_init:
        sfd.load_state_dict(load_reference_state_dict(args.sfd_ckpt))
        sd = load_reference_state_dict(args.fan_ckpt)
        dropped = sorted(k for k in sd if _FAN_EXTRA.match(k))
        if dropped:
            print(f"WARNING: FAN has no {', '.join(dropped)}; dropped", file=sys.stderr)
        fan.load_state_dict({k: v for k, v in sd.items() if k not in dropped})
    sfd, fan = frozen(sfd, device), frozen(fan, device)

    def fan_fn(crops):
        with torch.inference_mode():
            return fan(crops.to(device))

    return sfd_detector_fn(sfd), fan_fn


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sfd_ckpt", default=None, help="public s3fd torch checkpoint (.pth)")
    p.add_argument("--fan_ckpt", default=None, help="public 2DFAN-4 torch checkpoint (.pth)")
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights (pipeline smoke run)")
    p.add_argument("--points", type=int, default=5, choices=(5, 68))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256,
                   help="images are resized to size^2 before detection; landmarks are scaled "
                        "back to the original frame")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from fm3dgan_torch.models.fan_landmark import landmarks_68_to_5
    from fm3dgan_torch.models.sfd_detector import make_heatmap_landmark_fn
    from fm3dgan_torch.pipeline.forward import resolve_device

    detector_fn, fan_fn = build_stack(args, resolve_device(args.device))
    landmark_fn = make_heatmap_landmark_fn(detector_fn, fan_fn)

    files = sorted(f for f in os.listdir(args.img_dir) if f.lower().endswith(IMG_EXTS))
    if not files:
        raise SystemExit(f"no images found in {args.img_dir}")
    os.makedirs(args.out_dir, exist_ok=True)

    n_done = 0
    for start in range(0, len(files), args.batch):
        chunk = files[start:start + args.batch]
        imgs, orig_sizes = [], []
        for f in chunk:
            pixels, wh = _load_image(os.path.join(args.img_dir, f), args.size)
            imgs.append(pixels)
            orig_sizes.append(wh)
        batch = np.stack(imgs) / 255.0 * 2.0 - 1.0  # [-1, 1] NHWC
        _, lm68 = landmark_fn(batch)
        lm = lm68 if args.points == 68 else landmarks_68_to_5(lm68)
        for i, f in enumerate(chunk):
            w, h = orig_sizes[i]
            scaled = lm[i] * np.array([w / args.size, h / args.size], np.float32)
            _write_landmarks(os.path.join(args.out_dir, os.path.splitext(f)[0] + ".txt"), scaled)
            n_done += 1
        print(f"[extract_landmarks] {n_done}/{len(files)}", file=sys.stderr)
    print(f"wrote {n_done} landmark files to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
