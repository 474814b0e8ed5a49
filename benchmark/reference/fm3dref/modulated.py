"""Frozen copy of ``fm3dgan_torch/nn/modulated.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

Modulated convolution and generator blocks, NCHW.

Counterpart of ``fm3dgan/nn/modulated.py`` with the same formulation: since
convolution is linear in a per-input-channel scale,

    out[b] = demod[b] * conv(x[b] * style[b], scale * W)

so the inputs are scaled per sample, ONE convolution runs with a weight
shared across the batch (never ``groups=batch``), and the outputs are scaled
by the demodulation factor, computed from (scale*W)^2 and style^2 in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import parallel
from .layers import Blur, EqualLinear, FusedLeakyReLU, Upsample
from .precision import acc_dtype


class ModulatedConv2d(nn.Module):
    """Style-modulated, optionally demodulated conv; ``upsample`` runs a
    stride-2 transposed conv (output 2R+1) and a (1, 1)-padded blur (2R)."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        style_dim: int,
        demodulate: bool = True,
        upsample: bool = False,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.weight = nn.Parameter(
            torch.randn(1, out_channel, in_channel, kernel_size, kernel_size)
        )
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0, dtype=acc_dtype(dtype))
        self.demodulate = demodulate
        self.upsample = upsample
        self.dtype = dtype
        if upsample:
            factor = 2
            p = (len(blur_kernel) - factor) - (kernel_size - 1)
            pad0 = (p + 1) // 2 + factor - 1
            pad1 = p // 2 + 1
            self.blur = Blur(blur_kernel, pad=(pad0, pad1), upsample_factor=factor)

    def forward(self, x, style, return_style_scalars: bool = False):
        """x: [N, Cin, H, W]; style: [N, style_dim] -> [N, Cout, H', W'];
        with ``return_style_scalars`` also the modulation s [N, Cin], the
        per-sample scale before it is folded into the input."""
        s = self.modulation(style)  # [N, Cin], float32 (float64 for float64)
        w = self.weight[0].to(s.dtype) * self.scale  # [O, I, k, k]
        x = (x * s[:, :, None, None]).to(self.dtype)
        w_c = w.to(self.dtype)
        if self.upsample:
            out = F.conv_transpose2d(x, w_c.transpose(0, 1).contiguous(), stride=2, padding=0)
        else:
            out = F.conv2d(x, w_c, padding=self.kernel_size // 2)
        if self.demodulate:
            w2 = torch.sum(w * w, dim=(2, 3))  # [O, I]
            demod = torch.rsqrt((s * s) @ w2.t() + 1e-8)  # [N, O]
            out = out * demod[:, :, None, None].to(out.dtype)
        if self.upsample:
            out = self.blur(out)
        if return_style_scalars:
            return out, s
        return out


class NoiseInjection(nn.Module):
    """image + weight * noise; noise drawn from ``generator`` when not given."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if noise is None:
            n, _, h, w = image.shape
            # Under data parallelism: the rank's rows of the global batch's draw.
            noise = parallel.randn_rows(
                (n, 1, h, w), generator=generator, device=image.device, dtype=image.dtype
            )
        return image + self.weight.to(image.dtype) * noise.to(image.dtype)


class ConstantInput(nn.Module):
    def __init__(self, channel: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channel, size, size))

    def forward(self, batch: int):
        return self.input.repeat(batch, 1, 1, 1)


class StyledConv(nn.Module):
    """ModulatedConv2d -> NoiseInjection -> FusedLeakyReLU."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        style_dim: int,
        upsample: bool = False,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        demodulate: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_channel, out_channel, kernel_size, style_dim, demodulate=demodulate,
            upsample=upsample, blur_kernel=blur_kernel, dtype=dtype,
        )
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x, style, noise=None, generator=None, return_style_scalars: bool = False):
        out, s = self.conv(x, style, return_style_scalars=True)
        out = self.activate(self.noise(out, noise, generator))
        return (out, s) if return_style_scalars else out


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) to RGB, plus the 2x-upsampled skip."""

    def __init__(
        self,
        in_channel: int,
        style_dim: int,
        upsample: bool = True,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None, return_style_scalars: bool = False):
        out, s = self.conv(x, style, return_style_scalars=True)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return (out, s) if return_style_scalars else out
