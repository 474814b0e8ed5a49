"""Frozen copy of ``fm3dgan_torch/models/resnet_encoder.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

ResNet-18 encoders E_Tsr / E_W, NCHW.

Counterpart of ``fm3dgan/models/resnet_encoder.py`` with torchvision's
state-dict names: BasicBlock [2, 2, 2, 2], the classifier removed.

* ``tensor_encoding=True``: average pool with window max(1, H/4) ->
  [N, 8w, 4, 4], the tensor that replaces the generator's constant input.
* ``tensor_encoding=False``: global average pool -> [N, 8w] W vector.
* ``tensor_transform=True`` (with ``tensor_encoding``): the tensor and a
  vector from the linear ``ten_fc`` over its flattening, for the 2-encoder
  Tensor Transform mode.  ``ten_fc.weight`` is [8w, 8w * 16] in the
  reference's CHW flatten order, which the forward keeps.

BatchNorm eps 1e-5; ``forward(x, train=True)`` normalises with the batch
statistics and updates the running ones (``models/_common.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import bn, conv


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1),
            )
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        out = F.relu(bn(self.bn1, conv(self.conv1, x, self.dtype), train))
        out = bn(self.bn2, conv(self.conv2, out, self.dtype), train)
        if self.downsample is not None:
            identity = bn(self.downsample[1], conv(self.downsample[0], x, self.dtype), train)
        else:
            identity = x
        return F.relu(out + identity)


class ResNet18Encoder(nn.Module):
    """E_Tsr (tensor_encoding=True) / E_W (False) / the tensor-transform
    variant; ``width`` is the stem width (64 in the reference), output
    channels 8 * width."""

    def __init__(self, tensor_encoding: bool = True, width: int = 64,
                 dtype: torch.dtype = torch.float32, tensor_transform: bool = False):
        super().__init__()
        if tensor_transform and not tensor_encoding:
            raise ValueError("tensor_transform requires tensor_encoding")
        self.tensor_encoding = tensor_encoding
        self.tensor_transform = tensor_transform
        self.dtype = dtype
        w = width
        self.conv1 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(w, eps=1e-5, momentum=0.1)
        in_planes = w
        for li, (planes, stride) in enumerate([(w, 1), (2 * w, 2), (4 * w, 2), (8 * w, 2)], start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(in_planes, planes, stride, dtype),
                BasicBlock(planes, planes, 1, dtype),
            ))
            in_planes = planes
        if tensor_transform:
            self.ten_fc = nn.Linear(8 * w * 16, 8 * w)

    def forward(self, x, train: bool = False):
        """x: [N, 3, H, W] in [-1, 1] -> [N, 8w, 4, 4], [N, 8w], or both
        as (tensor, vector) with ``tensor_transform``."""
        out = F.relu(bn(self.bn1, conv(self.conv1, x, self.dtype), train))
        out = F.max_pool2d(out, 3, 2, 1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                out = block(out, train)
        if self.tensor_encoding:
            win = max(1, out.shape[2] // 4)
            tensor = F.avg_pool2d(out, win, win)
            if self.tensor_transform:
                fc = self.ten_fc
                vector = F.linear(tensor.flatten(1).to(self.dtype), fc.weight.to(self.dtype),
                                  fc.bias.to(self.dtype))
                return tensor, vector
            return tensor
        return out.mean(dim=(2, 3))
