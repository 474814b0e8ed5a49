"""Frozen copy of ``fm3dgan_torch/models/lpips.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

LPIPS perceptual distance (net-lin v0.1, VGG16 backbone), NCHW.

Counterpart of ``fm3dgan/models/lpips.py``: the ImageNet scaling layer
((x - shift) / scale on [-1, 1] inputs), VGG16's five feature slices
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), each unit-normalised over
channels with 1e-10 added to the norm, squared differences, the 1x1 linear
heads without bias, a spatial mean, and the sum over the five layers: [N].

State-dict names: torchvision's VGG16 ``features.{0, 2, 5, 7, 10, 12, 14,
17, 19, 21, 24, 26, 28}`` and the LPIPS heads ``lin{k}.model.1.weight``
[1, C, 1, 1], the names ``fm3dgan/compat/torch_port.py``'s
``convert_lpips`` reads; the heads start at 1/C, as in the JAX module.
Always frozen (dropout is the identity).  ``dtype`` is the compute dtype of
the convolutions (``_common``); the normalisation and the heads run in
float32 at least.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import conv, lecun_normal_
from .precision import acc

# (x - shift) / scale.
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

# VGG16 blocks (channels, convs); a slice after each block's last ReLU and a
# 2x2 max-pool before each block but the first.
VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_CHANNELS = tuple(c for c, _ in VGG_BLOCKS)


class NetLinLayer(nn.Module):
    """The reference's head: dropout (identity here), 1x1 conv, no bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.constant_(self.model[1].weight, 1.0 / channels)


class LPIPS(nn.Module):
    """dist = LPIPS(in0, in1); images [N, 3, H, W] in [-1, 1] -> [N]."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers: List[nn.Module] = []
        in_ch = 3
        for bi, (ch, n_convs) in enumerate(VGG_BLOCKS):
            if bi > 0:
                layers.append(nn.MaxPool2d(2, 2))
            for _ in range(n_convs):
                layers += [nn.Conv2d(in_ch, ch, 3, 1, 1), nn.ReLU()]
                in_ch = ch
        self.features = nn.Sequential(*layers)
        lecun_normal_(self.features)
        for k, ch in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(ch))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)

    def _slices(self, x) -> List[torch.Tensor]:
        x = (x.to(self.dtype) - self.shift.to(self.dtype)) / self.scale.to(self.dtype)
        feats, i = [], 0
        for bi, (_, n_convs) in enumerate(VGG_BLOCKS):
            if bi > 0:
                x = F.max_pool2d(x, 2, 2)
                i += 1
            for _ in range(n_convs):
                x = F.relu(conv(self.features[i], x, self.dtype))
                i += 2
            feats.append(x)
        return feats

    def forward(self, in0, in1):
        val = 0.0
        for k, (a, b) in enumerate(zip(self._slices(in0), self._slices(in1))):
            a, b = acc(a), acc(b)
            na = a / (a.square().sum(1, keepdim=True).sqrt() + 1e-10)
            nb = b / (b.square().sum(1, keepdim=True).sqrt() + 1e-10)
            w = getattr(self, f"lin{k}").model[1].weight.to(a.dtype)  # [1, C, 1, 1]
            val = val + ((na - nb).square() * w).sum(1).mean(dim=(1, 2))
        return val
