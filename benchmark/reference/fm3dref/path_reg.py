"""Frozen copy of ``fm3dgan_torch/losses/path_reg.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

Path-length (PPL) regulariser.

Counterpart of ``fm3dgan/losses/path_reg.py``: path_lengths =
sqrt(mean over layers of sum over D of (J^T y)^2), y white noise scaled by
1/sqrt(H*W), J the image-latent Jacobian.  J^T y is one
``autograd.grad(create_graph=True)`` of <g_fn(latent), y> with respect to
the latent, so the penalty stays differentiable in the parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from . import parallel
from .precision import acc, acc_dtype


def path_regularize(
    g_fn: Callable[[torch.Tensor], torch.Tensor],
    latent: torch.Tensor,
    mean_path_length: torch.Tensor,
    decay: float = 0.01,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(penalty, new_mean_path_length, path_lengths).

    g_fn: latent [N, n_latent, D] -> image [N, C, H, W], differentiable in
    the parameters it closes over.  noise: optional pre-drawn image, already
    scaled by 1/sqrt(H*W); else drawn from ``generator``.  The running mean
    inside the penalty is not detached; the returned one is.  Under data
    parallelism the noise is the rank's rows of the global batch's draw and
    the running mean moves by the global batch's mean path length, so
    ``new_mean_path_length`` is the same on every rank."""
    if not latent.requires_grad:
        latent = latent.detach().requires_grad_(True)
    fake = g_fn(latent)
    n, _, h, w = fake.shape
    if noise is None:
        noise = parallel.randn_rows(fake.shape, generator=generator, device=fake.device,
                                    dtype=acc_dtype(fake.dtype)) / math.sqrt(h * w)
    (grad,) = torch.autograd.grad((acc(fake) * noise).sum(), latent, create_graph=True)
    path_lengths = torch.sqrt(acc(grad).square().sum(2).mean(1))
    # The global batch's mean, still differentiable.
    batch_mean = parallel.all_reduce_sum(path_lengths.sum()) / (n * parallel.world_size())
    path_mean = mean_path_length + decay * (batch_mean - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    return penalty, path_mean.detach(), path_lengths
