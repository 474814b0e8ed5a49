"""bf16-vs-fp32 training parity, the counterpart of ``tools/validate_bf16.py``.

Runs the same seeded smoke training twice, ``compute_dtype`` float32 and
bfloat16, on identical synthetic data (the JAX tool's draws: per iteration
a uniform photo, the render as the photo plus 0.1 x noise with its top
eighth set to -1, a uniform reference at ``--size``), and reports for each
tracked metric the fp32 and bf16 means of the last quarter, the largest
relative deviation of the windowed means, and whether the bf16 values are
finite.  The hand-written kernels run in their float32 and bfloat16
instantiations.  The face-regional loss needs render and fake at one
resolution, which this geometry (``--size`` 64 against 128 px inputs) does
not have, so its three weights are 0, as in JAX.

    python -m fm3dgan_torch.tools.validate_bf16 --iters 100 --size 64 --batch 4 [--device cpu]

Prints the report as indented JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

from fm3dgan_torch.train import TrainConfig, Trainer

TRACKED = ("d", "g", "l1", "r1", "g_reg", "lpips", "face_id")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--input_size", type=int, default=128)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lpips_lambda", type=float, default=3.0)
    p.add_argument("--face_id_lambda", type=float, default=30.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def run(dtype: str, args) -> Dict[str, List[float]]:
    """The tracked metrics of ``args.iters`` iterations in ``dtype``."""
    cfg = TrainConfig(
        size=args.size,
        rec_batch=args.batch,
        ds_batch=args.batch,
        d_reg_every=4,
        g_reg_every=4,
        compute_dtype=dtype,
        lpips_loss_lambda=args.lpips_lambda,
        face_id_loss_lambda=args.face_id_lambda,
        rec_face_reg_loss_lambda=0.0,
        ds_face_reg_loss_lambda=0.0,
        ep_face_reg_loss_lambda=0.0,
    )
    trainer = Trainer(cfg, seed=0, use_lpips=args.lpips_lambda > 0,
                      use_arcface=args.face_id_lambda > 0, input_size=args.input_size,
                      device=args.device)
    rng = np.random.RandomState(0)
    s, si = args.size, args.input_size
    history: Dict[str, List[float]] = {k: [] for k in TRACKED}
    for i in range(args.iters):
        photo = rng.uniform(-1, 1, (args.batch, si, si, 3)).astype(np.float32)
        render = photo + 0.1 * rng.randn(args.batch, si, si, 3).astype(np.float32)
        render[:, : si // 8] = -1.0
        ref = rng.uniform(-1, 1, (args.batch, s, s, 3)).astype(np.float32)
        m = trainer.train_iteration(i, photo, render, ref)
        for k in TRACKED:
            if k in m:
                history[k].append(float(m[k]))
    return history


def report(h32: Dict[str, List[float]], h16: Dict[str, List[float]]) -> dict:
    """Per tracked metric: the last window's fp32 and bf16 means, the largest
    relative deviation of the windowed means (windows of n // 4, scale
    max(|fp32 mean|, 1e-2)) and whether the bf16 values are finite."""
    out = {}
    ok = True
    for k in TRACKED:
        a = np.asarray(h32[k])
        b = np.asarray(h16[k])
        if a.size == 0:
            continue
        n = min(a.size, b.size)
        a, b = a[:n], b[:n]
        # Windowed means: per-step values of a GAN diverge chaotically under
        # any change of precision; the training signal is the trajectory.
        w = max(1, n // 4)
        ma = np.array([a[i: i + w].mean() for i in range(0, n - w + 1, w)])
        mb = np.array([b[i: i + w].mean() for i in range(0, n - w + 1, w)])
        scale = np.maximum(np.abs(ma), 1e-2)
        rel = float(np.max(np.abs(ma - mb) / scale))
        finite = bool(np.isfinite(b).all())
        out[k] = {
            "fp32_tail_mean": round(float(a[-w:].mean()), 4),
            "bf16_tail_mean": round(float(b[-w:].mean()), 4),
            "max_windowed_rel_dev": round(rel, 4),
            "finite": finite,
        }
        ok = ok and finite
    out["all_bf16_finite"] = ok
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    h32 = run("float32", args)
    h16 = run("bfloat16", args)
    print(json.dumps(report(h32, h16), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
