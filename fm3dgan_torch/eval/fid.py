"""FID: the Fréchet distance of InceptionV3 pool3 statistics.

Counterpart of ``fm3dgan/eval/fid.py`` on one device: ``calc_fid`` (scipy's
``sqrtm`` with the eps fallback for a singular product), the statistics and
their pickle files (``{"mean", "cov"}``, the format the JAX package and the
reference write), and the features of z-samples.  The statistics and the
distance are numpy and scipy on the host; the features come from the
device.
"""

from __future__ import annotations

import pickle
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def calc_fid(sample_mean: np.ndarray, sample_cov: np.ndarray, real_mean: np.ndarray,
             real_cov: np.ndarray, eps: float = 1e-6) -> float:
    """|mu_s - mu_r|^2 + tr(S_s) + tr(S_r) - 2 tr(sqrt(S_s S_r)).  Where the
    product's square root is not finite, both covariances get ``eps`` on
    the diagonal; a complex root is accepted when its diagonal is real to
    1e-3 and raises ValueError otherwise."""
    from scipy import linalg

    cov_sqrt = linalg.sqrtm(sample_cov @ real_cov)
    if not np.isfinite(cov_sqrt).all():
        offset = np.eye(sample_cov.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sample_cov + offset) @ (real_cov + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(cov_sqrt.imag))}")
        cov_sqrt = cov_sqrt.real
    mean_diff = sample_mean - real_mean
    trace = np.trace(sample_cov) + np.trace(real_cov) - 2 * np.trace(cov_sqrt)
    return float(mean_diff @ mean_diff + trace)


def compute_inception_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features [N, F] -> (mean [F], covariance [F, F])."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def save_stats(path: str, mean: np.ndarray, cov: np.ndarray) -> None:
    with open(path, "wb") as f:
        pickle.dump({"mean": mean, "cov": cov}, f)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, cov) from a file :func:`save_stats` (or the JAX package's
    ``save_stats``) wrote."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["mean"], d["cov"]


@torch.no_grad()
def extract_features_from_samples(generator_fn: Callable[[torch.Tensor], torch.Tensor],
                                  inception_fn: Callable[[torch.Tensor], torch.Tensor],
                                  latent_dim: int, n_sample: int, batch_size: int,
                                  generator: torch.Generator) -> np.ndarray:
    """z ~ N(0, I) from ``generator`` (on the device it names) in batches of
    ``batch_size`` -> ``generator_fn`` (NCHW images) -> ``inception_fn`` ->
    [n_sample, F] on the host."""
    feats = []
    for start in range(0, n_sample, batch_size):
        bsz = min(batch_size, n_sample - start)
        z = torch.randn(bsz, latent_dim, generator=generator, device=generator.device)
        feats.append(inception_fn(generator_fn(z)).float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def get_model_fid_score(generator_fn: Callable[[torch.Tensor], torch.Tensor],
                        inception_fn: Callable[[torch.Tensor], torch.Tensor],
                        real_stats_path: str, generator: Optional[torch.Generator] = None,
                        latent_dim: int = 512, n_sample: int = 50_000,
                        batch_size: int = 100) -> float:
    """FID of ``n_sample`` z-samples of a z -> image generator against the
    statistics in ``real_stats_path``; z from ``generator`` (default: seed 0
    on the CPU)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    features = extract_features_from_samples(generator_fn, inception_fn, latent_dim, n_sample,
                                             batch_size, generator)
    real_mean, real_cov = load_stats(real_stats_path)
    return calc_fid(*compute_inception_stats(features), real_mean, real_cov)
