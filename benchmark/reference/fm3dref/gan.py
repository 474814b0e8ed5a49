"""Frozen copy of ``fm3dgan_torch/losses/gan.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

GAN losses and the R1 gradient penalty.

Counterpart of ``fm3dgan/losses/gan.py``.  R1 differentiates through a
gradient: ``autograd.grad(create_graph=True)`` records the input gradient's
graph, which the kernels' ``autograd.Function``s keep twice differentiable.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .precision import acc


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-real).mean() + softplus(fake).mean()."""
    return F.softplus(-acc(real_pred)).mean() + F.softplus(acc(fake_pred)).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-fake).mean()."""
    return F.softplus(-acc(fake_pred)).mean()


def d_r1_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor], real_img: torch.Tensor) -> torch.Tensor:
    """mean over the batch of ||dD(x)/dx||^2; differentiable w.r.t. the
    parameters inside ``d_fn`` (second-order autograd)."""
    real_img = real_img.detach().requires_grad_(True)
    pred = d_fn(real_img)
    (grad,) = torch.autograd.grad(acc(pred).sum(), real_img, create_graph=True)
    return acc(grad).square().reshape(grad.shape[0], -1).sum(1).mean()
