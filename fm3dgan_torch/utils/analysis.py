"""Training-log analysis and the checkpoint -> inference-stack builder.

Counterpart of ``fm3dgan/utils/analysis.py``: training logs are JSONL, and
a checkpoint is the port's ``{step:06d}.pt`` with its ``{step:06d}.json``
meta file (``fm3dgan_torch/train/loop.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def load_training_log(path: str) -> List[Dict[str, Any]]:
    """Read a training_log.jsonl into a list of per-iteration dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def metric_curve(log: List[Dict[str, Any]], key: str,
                 smooth: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(iters, values) for one metric; optional moving-average smoothing."""
    iters = np.asarray([r["iter"] for r in log if key in r])
    vals = np.asarray([float(r[key]) for r in log if key in r])
    if smooth > 1 and len(vals) >= smooth:
        kernel = np.ones(smooth) / smooth
        vals = np.convolve(vals, kernel, mode="valid")
        iters = iters[smooth - 1:]
    return iters, vals


def build_manipulator_from_checkpoint(ckpt_dir: str, step: int, use_ema: bool = True,
                                      device=None, dtype: torch.dtype = torch.float32):
    """The inference stack of a 3-encoder ``Trainer`` checkpoint: the
    ``FaceManipulator`` (G from ``g_ema``, or ``g`` without ``use_ema``, and
    the three encoders with their BatchNorm statistics) in eval mode on
    ``device`` (default ``cuda``), computing in ``dtype``; returns (models,
    meta).

    The widths come from the meta file (``width_mult``, ``latent``,
    ``channel_multiplier``); a meta without them gives the defaults, as the
    JAX builder always does.  Only the modules are built and only their
    tensors are read: the discriminators and the optimizer states of the
    checkpoint stay in the file (the frozen loss networks are not in it)."""
    from fm3dgan_torch.pipeline.forward import FaceManipulator, resolve_device

    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, f"{step:06d}.json")) as f:
        meta = json.load(f)
    # Memory-mapped: only the tensors loaded below are read from the file.
    ckpt = torch.load(os.path.join(ckpt_dir, f"{step:06d}.pt"), map_location="cpu",
                      weights_only=True, mmap=True)
    size = meta["size"]
    models = FaceManipulator.create(
        size=size, style_dim=meta.get("latent", 512),
        channel_multiplier=meta.get("channel_multiplier", 2),
        input_size=meta.get("input_size") or size, width_mult=meta.get("width_mult", 1.0),
        dtype=dtype, device="cpu")
    models.load_variables({"g": ckpt["g_ema" if use_ema else "g"], "e_tsr": ckpt["e_tsr"],
                           "e_w": ckpt["e_w"], "e_w_plus": ckpt["e_w_plus"]})
    return models.to(device).eval(), meta
