"""Quantitative evaluation: the reconstruction and the edit score.

Counterpart of ``fm3dgan/eval/quant_eval.py``:

  * ``get_recon_score``: ArcFace identity cosine, LPIPS and per-image L1 of
    the reconstruction against the photo;
  * ``get_edit_score``: identity cosine, FID against stored real
    statistics, heatmap L2 and landmark MSE (FAN), and face-regional MSE,
    over batches of one photo and four edit renders.

Eval batches are NHWC arrays in [-1, 1], as the JAX functions take them, and
``forward_fn(photo, render)`` returns the NHWC edited image, as
``forward_3_encoder`` does, on its inputs' device (host inputs give a host
image, so a caller sends them to the card first).  The scorers run NCHW on
the output's device:
``face_rec_fn`` ([N, 1, S, S] grayscale -> [N, 512]), ``lpips_fn`` (a, b ->
[N]), ``inception_fn`` (images -> [N, 2048]) and ``heatmap_landmark_fn``
(images -> (heatmaps, landmarks [N, 68, 2])).  Per-image scores are taken on
the device and averaged on the host.  A scorer that is None gives NaN for its
scores.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from fm3dgan_torch.eval.fid import calc_fid, compute_inception_stats, load_stats
from fm3dgan_torch.losses.geometry import get_render_mask
from fm3dgan_torch.losses.recon import convert_for_face_recognition


def _nchw(x, device) -> torch.Tensor:
    """NHWC array or tensor -> NCHW float32 tensor on ``device``."""
    return torch.as_tensor(x).to(device).float().permute(0, 3, 1, 2)


def _host(t: torch.Tensor) -> List[float]:
    return list(t.float().cpu().numpy())


def _mean(vals: List[float]) -> float:
    return float(np.mean(vals)) if vals else float("nan")


def compute_face_identity_similarity(output, target: torch.Tensor, face_rec_fn) -> np.ndarray:
    """Cosine similarity of the identity embeddings of ``output`` (one NCHW
    batch, or a list of them) and ``target``: [N], or [K, N] for a list."""
    tgt = face_rec_fn(convert_for_face_recognition(target)).float()
    outs = output if isinstance(output, (list, tuple)) else [output]
    sims = []
    for o in outs:
        feat = face_rec_fn(convert_for_face_recognition(o)).float()
        den = torch.clamp(feat.norm(dim=-1) * tgt.norm(dim=-1), min=1e-8)
        sims.append(((feat * tgt).sum(-1) / den).cpu().numpy())
    return np.stack(sims) if isinstance(output, (list, tuple)) else sims[0]


@torch.no_grad()
def get_recon_score(eval_batches, forward_fn: Callable, face_rec_fn: Optional[Callable],
                    lpips_fn: Optional[Callable],
                    info_print: bool = False) -> Tuple[float, float, float]:
    """(mean identity cosine, mean LPIPS, mean per-image L1) over
    ``eval_batches`` of (photo, render)."""
    cos_sim, lpips_vals, l1_vals = [], [], []
    for idx, (photo, render) in enumerate(eval_batches):
        if info_print:
            print(f"Batch: {idx}")
        out = torch.as_tensor(forward_fn(photo, render))
        out, photo = _nchw(out, out.device), _nchw(photo, out.device)
        if face_rec_fn is not None:
            cos_sim += list(compute_face_identity_similarity(out, photo, face_rec_fn))
        if lpips_fn is not None:
            lpips_vals += _host(lpips_fn(out, photo).reshape(-1))
        l1_vals += _host((out - photo).abs().mean(dim=(1, 2, 3)))
    return _mean(cos_sim), _mean(lpips_vals), _mean(l1_vals)


@torch.no_grad()
def get_edit_score(eval_batches, forward_fn: Callable, face_rec_fn: Optional[Callable],
                   inception_fn: Optional[Callable], real_stats_path: Optional[str] = None,
                   real_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   heatmap_landmark_fn: Optional[Callable] = None, info_print: bool = False):
    """(mean identity cosine, FID, mean heatmap L2, mean landmark MSE, mean
    face-regional MSE) over ``eval_batches`` of [photo, render_1, ...]; FID
    needs ``inception_fn`` and real statistics (or their file)."""
    cos_sim: List[float] = []
    hmap_scores: List[float] = []
    lmark_scores: List[float] = []
    face_diff: List[float] = []
    feats = []
    for idx, batch in enumerate(eval_batches):
        if info_print:
            print(f"Batch: {idx}")
        photo = batch[0]
        outs = []
        for render in batch[1:]:
            out = torch.as_tensor(forward_fn(photo, render))
            out, render = _nchw(out, out.device), _nchw(render, out.device)
            outs.append(out)
            mask = get_render_mask(render)[:, None]
            face_diff += _host((render * mask - out * mask).square().mean(dim=(1, 2, 3)))
            if heatmap_landmark_fn is not None:
                hm_g, lm_g = heatmap_landmark_fn(out)
                hm_r, lm_r = heatmap_landmark_fn(render)
                hmap_scores += _host((hm_r.float() - hm_g.float()).square().sum(dim=(1, 2, 3)))
                lmark_scores += _host((lm_r.float() - lm_g.float()).square().mean(dim=(1, 2)))
        if face_rec_fn is not None:
            sims = compute_face_identity_similarity(outs, _nchw(photo, outs[0].device), face_rec_fn)
            cos_sim += list(sims.reshape(-1))
        if inception_fn is not None:
            feats.append(inception_fn(torch.cat(outs)).float().cpu().numpy())

    fid = float("nan")
    if inception_fn is not None and (real_stats is not None or real_stats_path is not None):
        sample_mean, sample_cov = compute_inception_stats(np.concatenate(feats, axis=0))
        if real_stats is None:
            real_stats = load_stats(real_stats_path)
        fid = calc_fid(sample_mean, sample_cov, real_stats[0], real_stats[1])
    return _mean(cos_sim), fid, _mean(hmap_scores), _mean(lmark_scores), _mean(face_diff)
