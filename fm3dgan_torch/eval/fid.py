"""FID: the Fréchet distance of InceptionV3 pool3 statistics.

Counterpart of ``fm3dgan/eval/fid.py``: ``calc_fid`` (scipy's ``sqrtm`` with
the eps fallback for a singular product), the statistics and their pickle
files (``{"mean", "cov"}``, the format the JAX package and the reference
write), the features of z-samples, and their extraction sharded over a
data-parallel group (``make_sharded_feature_fn``, ``make_mesh_feature_fn``).
The statistics and the distance are numpy and scipy on the host; the
features come from the device.
"""

from __future__ import annotations

import pickle
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fm3dgan_torch import parallel


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


def make_sharded_feature_fn(feature_fn: Callable[[torch.Tensor], torch.Tensor]
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """images -> features with the images split over the data-parallel
    group: each rank extracts its rows of the batch (the same batch on every
    rank) and ``all_gather_rows`` gives every rank the whole [N, F] matrix.
    The batch must divide over the ranks.  Without a group it is
    ``feature_fn``."""
    def run(img: torch.Tensor) -> torch.Tensor:
        if not parallel.active():
            return feature_fn(img)
        return parallel.all_gather_rows(feature_fn(img[parallel.local_rows(img.shape[0])]))

    return run


def make_mesh_feature_fn(feature_fn: Callable[[torch.Tensor], torch.Tensor]
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """:func:`make_sharded_feature_fn` for any batch size: the batch is
    zero-padded to a multiple of the world size and the padded rows'
    features trimmed."""
    sharded = make_sharded_feature_fn(feature_fn)

    def run(img: torch.Tensor) -> torch.Tensor:
        b = img.shape[0]
        pad = (-b) % parallel.world_size()
        if pad:
            img = torch.cat([img, img.new_zeros((pad, *img.shape[1:]))])
        return sharded(img)[:b]

    return run


def get_model_fid_score(generator_fn: Callable[[torch.Tensor], torch.Tensor],
                        inception_fn: Callable[[torch.Tensor], torch.Tensor],
                        real_stats_path: str, generator: Optional[torch.Generator] = None,
                        latent_dim: int = 512, n_sample: int = 50_000,
                        batch_size: int = 100, data_parallel: bool = False) -> float:
    """FID of ``n_sample`` z-samples of a z -> image generator against the
    statistics in ``real_stats_path``; z from ``generator`` (default: seed 0
    on the CPU).  With ``data_parallel`` (the JAX function's ``mesh``) every
    rank generates the images as one process does and the Inception features
    are sharded over the group (:func:`make_mesh_feature_fn`)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if data_parallel:
        inception_fn = make_mesh_feature_fn(inception_fn)
    features = extract_features_from_samples(generator_fn, inception_fn, latent_dim, n_sample,
                                             batch_size, generator)
    real_mean, real_cov = load_stats(real_stats_path)
    return calc_fid(*compute_inception_stats(features), real_mean, real_cov)
