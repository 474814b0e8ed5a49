"""The five kernels of ``fm3dgan_torch.ops`` as their plain PyTorch versions.

Copied from ``fm3dgan_torch/ops/upfirdn2d.py`` (``make_kernel``,
``upfirdn2d``, ``upsample2d``, ``downsample2d``, ``blur_plain``,
``upsample2x_plain``, ``downsample2x_plain``) and
``fm3dgan_torch/ops/fused_act.py`` (``fused_leaky_relu_plain``).  The names
the model code calls (``blur``, ``upsample2x``, ``downsample2x``,
``fused_leaky_relu``) are these plain functions; their gradients are
autograd's, not the kernels' hand-written adjoints.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .precision import acc


def make_kernel(k: Sequence[float]) -> np.ndarray:
    """1D -> outer-product 2D FIR kernel, normalized to sum 1 (float32)."""
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / np.sum(k)


def _normalize_args(up, down, pad):
    up_x, up_y = (up, up) if isinstance(up, int) else up
    down_x, down_y = (down, down) if isinstance(down, int) else down
    if len(pad) == 2:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad[0], pad[1], pad[0], pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    return up_x, up_y, down_x, down_y, pad_x0, pad_x1, pad_y0, pad_y1


def upfirdn2d(x: torch.Tensor, kernel, up=1, down=1, pad=(0, 0)) -> torch.Tensor:
    """Upsample (zero insertion), FIR filter (true convolution), decimate, on
    an NCHW tensor, computed in float32 (float64 for float64)."""
    up_x, up_y, down_x, down_y, px0, px1, py0, py1 = _normalize_args(up, down, pad)
    n, c, h, w = x.shape
    y = acc(x)
    k = torch.tensor(np.asarray(kernel, np.float32), device=x.device, dtype=y.dtype)
    kh, kw = k.shape
    if up_x > 1 or up_y > 1:
        y = y.reshape(n, c, h, 1, w, 1)
        y = F.pad(y, (0, up_x - 1, 0, 0, 0, up_y - 1))
        y = y.reshape(n, c, h * up_y, w * up_x)
    y = F.pad(y, (px0, px1, py0, py1))  # negative pads crop
    weight = torch.flip(k, (0, 1)).expand(c, 1, kh, kw)
    out = F.conv2d(y, weight, stride=(down_y, down_x), groups=c)
    return out.to(x.dtype)


def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    kernel = np.asarray(kernel, np.float32) * (factor**2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    kernel = np.asarray(kernel, np.float32)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x: torch.Tensor, kernel, pad, upsample_factor: int = 1) -> torch.Tensor:
    kernel = np.asarray(kernel, np.float32)
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor**2)
    return upfirdn2d(x, kernel, pad=pad)


def upsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """2x upsample with the separable kernel outer(kernel_1d, kernel_1d)."""
    k = np.asarray(kernel_1d, np.float32)
    return upfirdn2d(x, np.outer(k, k), up=2, pad=pad)


def downsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """FIR with outer(kernel_1d, kernel_1d), then keep every second sample."""
    k = np.asarray(kernel_1d, np.float32)
    return upfirdn2d(x, np.outer(k, k), down=2, pad=pad)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """scale * leaky_relu(x + bias) in float32 (float64 for float64); the
    bias is first cast to x's dtype."""
    y = acc(x)
    if bias is not None:
        y = y + bias.to(x.dtype).to(y.dtype).reshape(1, -1, *([1] * (x.dim() - 2)))
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)
