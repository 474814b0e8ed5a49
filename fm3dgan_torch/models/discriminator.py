"""StyleGAN2 discriminator, NCHW.

Counterpart of ``fm3dgan/models/discriminator.py`` with the reference's
module and state-dict names: ``convs.0`` (the 1x1 from-RGB ConvLayer),
``convs.{i}.conv1/conv2/skip`` (ResBlocks down to 4x4), ``final_conv`` and
``final_linear.{0,1}``.  The flatten before ``final_linear.0`` is NCHW, as
in the reference; ``compat.from_jax.discriminator_from_jax`` undoes the JAX
package's NHWC flatten permutation.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from fm3dgan_torch.models.generator import channel_table
from fm3dgan_torch.nn.layers import ConvLayer, EqualLinear, ResBlock, minibatch_stddev


class Discriminator(nn.Module):
    def __init__(
        self,
        size: int,
        channel_multiplier: int = 2,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        stddev_group: int = 4,
        stddev_feat: int = 1,
        width_mult: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        channels = channel_table(channel_multiplier, width_mult)
        log_size = int(math.log2(size))
        convs = [ConvLayer(3, channels[size], 1, dtype=dtype)]
        in_channel = channels[size]
        for i in range(log_size, 2, -1):
            out_channel = channels[2 ** (i - 1)]
            convs.append(ResBlock(in_channel, out_channel, blur_kernel, dtype=dtype))
            in_channel = out_channel
        self.convs = nn.Sequential(*convs)
        self.stddev_group = stddev_group
        self.stddev_feat = stddev_feat
        self.final_conv = ConvLayer(in_channel + 1, channels[4], 3, dtype=dtype)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation="fused_lrelu", dtype=dtype),
            EqualLinear(channels[4], 1, dtype=dtype),
        )

    def forward(self, x):
        """x: [N, 3, size, size] in [-1, 1] -> logits [N, 1]."""
        out = self.convs(x)
        out = minibatch_stddev(out, self.stddev_group, self.stddev_feat)
        out = self.final_conv(out)
        return self.final_linear(out.reshape(out.shape[0], -1))
