"""Frozen copy of ``fm3dgan_torch/nn/layers.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

StyleGAN2 building blocks, NCHW, equalized learning rate.

Counterparts of ``fm3dgan/nn/layers.py``.  Parameters keep the reference's
torch layout and names (Linear ``[out, in]``, conv OIHW; ``ConvLayer`` is an
``nn.Sequential`` as in the reference, so its keys are ``0.weight``,
``1.bias`` or, downsampling, ``1.weight``, ``2.bias``).  ``dtype`` is the
compute type; parameters stay float32 and are cast at use, as the JAX modules
cast theirs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import parallel
from .ops import blur, downsample2x, fused_leaky_relu, make_kernel, upsample2x
from .precision import acc_dtype


class PixelNorm(nn.Module):
    """x * rsqrt(mean(x^2, dim 1) + 1e-8)."""

    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Linear with runtime weight scale (1/sqrt(in)) * lr_mul."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        bias: bool = True,
        bias_init: float = 0.0,
        lr_mul: float = 1.0,
        activation: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init))) if bias else None
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation
        self.dtype = dtype

    def forward(self, x):
        # The scales apply in the accumulation dtype: a float64 run rounds
        # the scaled weight and bias in float64, as the JAX module does.
        a = acc_dtype(self.dtype)
        out = F.linear(x.to(self.dtype), (self.weight.to(a) * self.scale).to(self.dtype))
        bias = None if self.bias is None else self.bias.to(a) * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, bias)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return out


class EqualConv2d(nn.Module):
    """Conv with runtime 1/sqrt(fan_in) weight scaling."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_channel, in_channel, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x):
        out = F.conv2d(
            x.to(self.dtype),
            (self.weight.to(acc_dtype(self.dtype)) * self.scale).to(self.dtype),
            stride=self.stride,
            padding=self.padding,
        )
        if self.bias is not None:
            out = out + self.bias.to(out.dtype).reshape(1, -1, 1, 1)
        return out


class FusedLeakyReLU(nn.Module):
    """Per-channel bias + LeakyReLU + sqrt(2) scale (CUDA kernel on the card)."""

    def __init__(self, channel: int, negative_slope: float = 0.2, scale: float = math.sqrt(2.0)):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)


class Blur(nn.Module):
    """FIR blur; the kernel is a host constant, scaled by factor**2 after an
    upsampling transposed conv (``fm3dgan/nn/layers.py:130-140``)."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), pad: Tuple[int, int] = (0, 0),
                 upsample_factor: int = 1):
        super().__init__()
        k = make_kernel(kernel)
        if upsample_factor > 1:
            k = k * (upsample_factor**2)
        self.kernel = k
        self.pad = tuple(pad)

    def forward(self, x):
        return blur(x, self.kernel, self.pad)


class Upsample(nn.Module):
    """FIR 2x upsample with a separable kernel: outer(k, k) / sum**2 * 4,
    pads (2, 1) for k = 4 (``fm3dgan/ops/upfirdn2d.py:211-216``)."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        if factor != 2:
            raise ValueError("Upsample supports factor 2 only")
        k = np.asarray(kernel, np.float32)
        if k.ndim != 1:
            raise ValueError("Upsample takes 1-D taps (a separable kernel)")
        self.kernel_1d = k / k.sum() * factor
        p = k.size - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x):
        return upsample2x(x, self.kernel_1d, self.pad)


class ScaledLeakyReLU(nn.Module):
    """leaky_relu * sqrt(2) (``fm3dgan/nn/layers.py:107-114``)."""

    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return torch.where(x >= 0, x, x * self.negative_slope) * math.sqrt(2.0)


class Downsample(nn.Module):
    """FIR 2x downsample with a separable kernel: outer(k, k) / sum**2, pads
    ((p+1)//2, p//2) with p = k - 2 (``fm3dgan/ops/upfirdn2d.py``
    ``downsample2d``)."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        if factor != 2:
            raise ValueError("Downsample supports factor 2 only")
        k = np.asarray(kernel, np.float32)
        if k.ndim != 1:
            raise ValueError("Downsample takes 1-D taps (a separable kernel)")
        self.kernel_1d = k / k.sum()
        p = k.size - factor
        self.pad = ((p + 1) // 2, p // 2)

    def forward(self, x):
        return downsample2x(x, self.kernel_1d, self.pad)


class ConvLayer(nn.Sequential):
    """Discriminator conv block: [Blur ->] EqualConv2d [-> activation].

    With ``downsample`` the blur pads ((p+1)//2, p//2), p = len(blur) - 2 +
    kernel_size - 1, and the conv runs at stride 2 without padding."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        downsample: bool = False,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        bias: bool = True,
        activate: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride=stride,
                                  padding=padding, bias=bias and not activate, dtype=dtype))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias else ScaledLeakyReLU(0.2))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Discriminator residual block, (conv2(conv1(x)) + skip(x)) / sqrt(2)."""

    def __init__(self, in_channel: int, out_channel: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3, dtype=dtype)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel, dtype=dtype)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True, blur_kernel=blur_kernel,
                              activate=False, bias=False, dtype=dtype)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, num_features: int = 1) -> torch.Tensor:
    """Append the per-group mean feature stddev as extra channels (NCHW): the
    reference's group reshape [G, N/G, F, C/F, H, W], biased variance, +1e-8.
    Under data parallelism the groups are those of the global batch: the
    rows are gathered over the ranks and each rank keeps its rows of the
    stddev channels."""
    n, c, h, w = x.shape
    full = parallel.all_gather_rows(x)
    group = min(full.shape[0], group_size)
    y = full.reshape(group, -1, num_features, c // num_features, h, w)
    stddev = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
    stddev = stddev.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)  # [N/G, F, 1, 1]
    stddev = stddev.repeat(group, 1, h, w)
    if full.shape[0] != n:
        stddev = stddev[parallel.local_rows(full.shape[0])]
    return torch.cat([x, stddev.to(x.dtype)], dim=1)
