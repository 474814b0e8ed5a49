"""Bilinear resizing with ``jax.image.resize``'s conventions, NCHW.

``jax.image.resize(method="bilinear")`` samples at pixel centres
(``align_corners=False``) and, where it shrinks, widens its triangle filter
by the scale (antialiasing) and renormalises the weights at the borders.
``F.interpolate(antialias=True)`` computes the same weights; where the image
grows, the plain bilinear path is the same function without the
antialiasing path's rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, size, size]; the identity when already there."""
    h, w = x.shape[-2:]
    if h == size and w == size:
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=size < h or size < w)
