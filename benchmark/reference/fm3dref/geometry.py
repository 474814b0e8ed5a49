"""Frozen copy of ``fm3dgan_torch/losses/geometry.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

Geometry losses: face-regional masked MSE and the landmark-heatmap loss,
NCHW.  Counterpart of ``fm3dgan/losses/geometry.py``."""

from __future__ import annotations

from typing import Callable

import torch

from .precision import acc


def get_render_mask(render_img: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] -> [N, H, W] float mask where the render has content
    (mean over channels > -1)."""
    return (render_img.mean(dim=1) > -1.0).to(render_img.dtype)


def face_regional_loss(r_img: torch.Tensor, g_img: torch.Tensor) -> torch.Tensor:
    """MSE between the render-masked render and the render-masked output."""
    mask = get_render_mask(r_img)[:, None]
    return (acc(r_img) * mask - acc(g_img) * mask).square().mean()


def heat_map_loss(
    g_output: torch.Tensor,
    r_input: torch.Tensor,
    heatmap_fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Mean over the batch of sum((H_render - H_gen)^2) over the heatmaps
    that ``heatmap_fn`` (images -> [N, K, h, w]) gives."""
    hm_r = acc(heatmap_fn(r_input))
    hm_g = acc(heatmap_fn(g_output))
    return (hm_r - hm_g).square().sum(dim=(1, 2, 3)).mean()
