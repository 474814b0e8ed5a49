"""Generate the on-disk dataset layouts the training pipeline consumes: the
port's counterpart of ``tools/make_dataset_layouts.py``.

  synthetic  id_XXXXX/{g_K.png, r_K.png}   K in 0..n_var-1 (one identity
             held across its n_var variations)
  ffhq       img/NNNNN.png + render_img/NNNNN.png (reconstruction pairs)
             + edit_render_img/NNNNN_e{0..n_edits-1}.png (edits per photo)
  valnpy     NNNNN.npy visual-validation bundles [photo, own render, edit
             renders]

    python -m fm3dgan_torch.tools.make_dataset_layouts synthetic out/ds --n_ids 16 \\
        [--source procedural|model] [--ckpt_dir DIR:STEP] [--device cpu]

Image sources:
  --source procedural  deterministic smooth random fields (numpy only): the
                       same files, byte for byte, as the JAX tool writes.
  --source model       a generator (random weights from --seed, or the EMA
                       generator of --ckpt_dir DIR:STEP): one W per identity
                       on the layers below the mix point and a fresh W per
                       variation above it (style mixing with inject_index:
                       the last 6 layers with --mix_mode fine, all but the
                       first 3 with middle), fresh noise per variation,
                       drawn from torch generators seeded from (seed,
                       identity).  Runs on cuda unless --device says
                       otherwise.
Renders are stand-ins: a grayscale face-region crop of the image, the
background at exactly 0 (-1 after the [-1, 1] transform, what the
face-regional loss masks on).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np

_T0 = time.time()


def _log(msg: str) -> None:
    print(f"[datagen +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _save_png(path: str, arr01: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(arr01, 0.0, 1.0) * 255).astype(np.uint8)).save(path)


def _procedural_image(rng: np.random.RandomState, size: int) -> np.ndarray:
    """Deterministic smooth random field in [0,1], [H,W,3]."""
    small = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    ys = np.linspace(0, 7, size)
    xs = np.linspace(0, 7, size)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = (ys - yi)[:, None, None], (xs - xi)[None, :, None]
    yi2, xi2 = np.minimum(yi + 1, 7), np.minimum(xi + 1, 7)
    a = small[yi][:, xi] * (1 - yf) * (1 - xf)
    b = small[yi][:, xi2] * (1 - yf) * xf
    c = small[yi2][:, xi] * yf * (1 - xf)
    d = small[yi2][:, xi2] * yf * xf
    return a + b + c + d


def _render_standin(img01: np.ndarray) -> np.ndarray:
    """Grayscale face-region crop, background at exactly 0."""
    h, w, _ = img01.shape
    gray = img01.mean(axis=2, keepdims=True).repeat(3, axis=2)
    out = np.zeros_like(gray)
    y0, y1 = int(0.15 * h), int(0.95 * h)
    x0, x1 = int(0.2 * w), int(0.8 * w)
    out[y0:y1, x0:x1] = np.maximum(gray[y0:y1, x0:x1], 1.0 / 255.0)
    return out


class ModelSampler:
    """Style-mixed variations of one identity from a port ``Generator``."""

    def __init__(self, size: int, ckpt_dir: Optional[str], seed: int, mix_mode: str = "fine",
                 device=None):
        import torch

        from fm3dgan_torch.models.generator import Generator
        from fm3dgan_torch.pipeline.forward import resolve_device

        if mix_mode not in ("fine", "middle"):
            raise ValueError(f"mix_mode must be 'fine' or 'middle', got {mix_mode!r}")
        if ckpt_dir:
            # "dir:step" names a checkpoint of the training CLI.
            from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

            d, step = ckpt_dir.rsplit(":", 1)
            self.generator = build_manipulator_from_checkpoint(d, int(step), device=device)[0].generator
        else:
            device = resolve_device(device)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                self.generator = Generator(size=size).to(device).eval()
        n_latent = self.generator.n_latent
        self.inject = max(1, n_latent - 6) if mix_mode == "fine" else min(3, n_latent - 1)

    def identity_images(self, seed: int, n_var: int) -> np.ndarray:
        """[n_var, H, W, 3] in [0, 1]: the identity W (drawn first) below the
        mix point, one W per variation above it, noise from the device."""
        import torch

        g = self.generator
        rng = torch.Generator().manual_seed(seed)
        z_id = torch.randn(1, g.style_dim, generator=rng)
        z_var = torch.randn(n_var, g.style_dim, generator=rng)
        noise_rng = torch.Generator(device=g.device).manual_seed(seed)
        with torch.no_grad():
            w_id = g.get_latent(z_id.to(g.device)).expand(n_var, -1)
            w_var = g.get_latent(z_var.to(g.device))
            img = g(input_is_latent=True, latent_styles=[w_id, w_var], inject_index=self.inject,
                    noise_generator=noise_rng)
        return ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("layout", choices=("synthetic", "ffhq", "valnpy"))
    p.add_argument("out_dir")
    p.add_argument("--n_ids", type=int, default=16)
    p.add_argument("--n_var", type=int, default=7,
                   help="variations per identity (synthetic layout; the reference uses 7)")
    p.add_argument("--n_edits", type=int, default=4,
                   help="edit renders per photo (ffhq/valnpy; the reference's 4)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--source", choices=("procedural", "model"), default="procedural")
    p.add_argument("--ckpt_dir", default=None,
                   help="with --source model: a training checkpoint as DIR:STEP")
    p.add_argument("--mix_mode", choices=("fine", "middle"), default="fine",
                   help="with --source model: which layers the per-variation W drives. fine = "
                        "last 6 (color/texture; strongest identity hold). middle = all but the "
                        "first 3 (structure/pose too) — for layouts standing in for "
                        "pose-varying data (extreme-pose DS)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="with --source model: torch device (default cuda; cpu for the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    sampler = None
    if args.source == "model":
        sampler = ModelSampler(args.size, args.ckpt_dir, args.seed, mix_mode=args.mix_mode,
                               device=args.device)

    def identity_batch(idx: int, n: int) -> np.ndarray:
        if sampler is not None:
            return sampler.identity_images(args.seed * 100003 + idx, n)
        rng = np.random.RandomState(args.seed * 100003 + idx)
        base = _procedural_image(rng, args.size)
        out = []
        for _ in range(n):
            out.append(np.clip(base + rng.uniform(-0.15, 0.15, base.shape), 0, 1))
        return np.stack(out)

    if args.layout == "synthetic":
        for i in range(args.n_ids):
            if i % 25 == 0:
                _log(f"synthetic id {i}/{args.n_ids}")
            id_dir = os.path.join(args.out_dir, f"id_{i:05d}")
            os.makedirs(id_dir, exist_ok=True)
            imgs = identity_batch(i, args.n_var)
            for k in range(args.n_var):
                _save_png(os.path.join(id_dir, f"g_{k}.png"), imgs[k])
                _save_png(os.path.join(id_dir, f"r_{k}.png"), _render_standin(imgs[k]))
        print(f"synthetic layout: {args.n_ids} ids x {args.n_var} pairs -> {args.out_dir}")
    elif args.layout == "ffhq":
        img_d = os.path.join(args.out_dir, "img")
        ren_d = os.path.join(args.out_dir, "render_img")
        edit_d = os.path.join(args.out_dir, "edit_render_img")
        for d in (img_d, ren_d, edit_d):
            os.makedirs(d, exist_ok=True)
        for i in range(args.n_ids):
            if i % 25 == 0:
                _log(f"ffhq id {i}/{args.n_ids}")
            imgs = identity_batch(i, 1 + args.n_edits)
            _save_png(os.path.join(img_d, f"{i:05d}.png"), imgs[0])
            _save_png(os.path.join(ren_d, f"{i:05d}.png"), _render_standin(imgs[0]))
            for e in range(args.n_edits):
                _save_png(os.path.join(edit_d, f"{i:05d}_e{e}.png"), _render_standin(imgs[1 + e]))
        print(f"ffhq layout: {args.n_ids} photos (+{args.n_edits} edits each) -> {args.out_dir}")
    else:  # valnpy
        for i in range(args.n_ids):
            imgs = identity_batch(i, 1 + args.n_edits)
            bundle = [imgs[0] * 2 - 1, _render_standin(imgs[0]) * 2 - 1]
            bundle += [_render_standin(imgs[1 + e]) * 2 - 1 for e in range(args.n_edits)]
            np.save(os.path.join(args.out_dir, f"{i:05d}.npy"), np.stack(bundle).astype(np.float32))
        print(f"valnpy bundles: {args.n_ids} -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
