"""Perceptual path length.

Counterpart of ``fm3dgan/eval/ppl.py``: W-space lerp pairs at t and t + eps
(eps = 1e-4), the LPIPS distance of each pair, the mean of the distances
between the 1st and 99th percentiles.  As in the JAX package and the
reference, the distances are not divided by eps^2.  The draw of z and t
(``draw_ppl_inputs``, from a ``torch.Generator``) is apart from the
arithmetic (``interpolate_latents``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fm3dgan_torch.nn.resize import resize_bilinear


def interpolate_latents(latent: torch.Tensor, t: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """latent [2B, D] (pairs (2i, 2i + 1)), t [B, 1] -> [2B, D]: the lerps at
    t and t + eps of each pair, interleaved."""
    l0, l1 = latent[::2], latent[1::2]
    e0 = l0 + t * (l1 - l0)
    e1 = l0 + (t + eps) * (l1 - l0)
    return torch.stack([e0, e1], dim=1).reshape(latent.shape)


def draw_ppl_inputs(generator: torch.Generator, batch_size: int,
                    latent_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [2B, D] ~ N(0, I) and t [B, 1] ~ U[0, 1), on the generator's device."""
    z = torch.randn(batch_size * 2, latent_dim, generator=generator, device=generator.device)
    t = torch.rand(batch_size, 1, generator=generator, device=generator.device)
    return z, t


def generate_interpolated_images(style_fn: Callable, synthesis_fn: Callable,
                                 generator: torch.Generator, batch_size: int, latent_dim: int,
                                 eps: float = 1e-4) -> torch.Tensor:
    """[2B, 3, H, W]: image pairs at the W-space lerps t and t + eps of
    ``batch_size`` z pairs, interleaved.  style_fn: z -> W (it moves z to
    its device); synthesis_fn: W [N, D] -> NCHW image (fixed noise)."""
    z, t = draw_ppl_inputs(generator, batch_size, latent_dim)
    latent = style_fn(z)
    return synthesis_fn(interpolate_latents(latent, t.to(latent.device), eps))


def filtered_mean(distances: np.ndarray) -> float:
    """The mean of the distances between the 1st percentile (rounded down
    to a sample) and the 99th (rounded up)."""
    lo = np.percentile(distances, 1, method="lower")
    hi = np.percentile(distances, 99, method="higher")
    return float(distances[(distances >= lo) & (distances <= hi)].mean())


@torch.no_grad()
def get_ppl_score(style_fn: Callable, synthesis_fn: Callable, lpips_fn: Callable, n_sample: int,
                  batch_size: int, latent_dim: int = 512, eps: float = 1e-4,
                  generator: Optional[torch.Generator] = None, info_print: bool = False) -> float:
    """PPL over max(1, n_sample // batch_size) batches of ``batch_size``
    pairs; images above 256 px are resized to 256 (bilinear, antialiased)
    before LPIPS (lpips_fn: a, b NCHW -> [N]).  z and t come from
    ``generator`` (default: seed 0 on the CPU)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    distances = []
    for idx in range(max(1, n_sample // batch_size)):
        if info_print:
            print(f"Evaluating Batch: {idx}")
        img = generate_interpolated_images(style_fn, synthesis_fn, generator, batch_size,
                                           latent_dim, eps)
        if img.shape[2] > 256:
            img = resize_bilinear(img, 256)
        distances.append(lpips_fn(img[::2], img[1::2]).float().reshape(-1).cpu().numpy())
    return filtered_mean(np.concatenate(distances))
