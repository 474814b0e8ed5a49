"""Frozen copy of ``fm3dgan_torch/models/arcface.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

ArcFace ResNetFace-18 identity network, NCHW.

Counterpart of ``fm3dgan/models/arcface.py``: the reference's
``ResNetFace(IRBlock, [2, 2, 2, 2], use_se=False)`` with its state-dict
names (``conv1``, ``bn1``, ``prelu``, ``layer{1..4}.{0,1}.{bn0, conv1, bn1,
prelu, conv2, bn2, downsample.0, downsample.1}``, ``bn4``, ``fc5``, ``bn5``),
the names ``fm3dgan/compat/torch_port.py``'s ``convert_arcface`` reads.

Always frozen: BatchNorm normalises with the running statistics and dropout
is the identity.  Input [N, 1, S, S] grayscale in [-1, 1]
(``losses.recon.convert_for_face_recognition``), output [N, 512];
``input_size`` S sets fc5's width, 512 * (S/16)^2 (S = 128 in the
reference).  Each IRBlock's two activations share one scalar PReLU, as in
the reference.  ``dtype`` is the compute dtype (``_common``); fc5 runs in
float32 at least, as the JAX module's Dense, which has no dtype of its own.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import bn, conv, lecun_normal_, prelu

LAYERS = ((64, 1), (128, 2), (256, 2), (512, 2))  # (planes, stride) of layer1..4


class IRBlock(nn.Module):
    """bn0 -> conv3x3(in, in) -> bn1 -> prelu -> conv3x3(in, planes, stride)
    -> bn2 -> + shortcut -> prelu, one PReLU for both activations."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(inplanes, eps=1e-5)
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(inplanes, eps=1e-5)
        self.prelu = nn.PReLU()
        self.conv2 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=1e-5),
            )
        self.dtype = dtype

    def forward(self, x):
        out = conv(self.conv1, bn(self.bn0, x), self.dtype)
        out = prelu(self.prelu, bn(self.bn1, out))
        out = bn(self.bn2, conv(self.conv2, out, self.dtype))
        if self.downsample is None:
            residual = x
        else:
            residual = bn(self.downsample[1], conv(self.downsample[0], x, self.dtype))
        return prelu(self.prelu, out + residual)


class ResNetFace18(nn.Module):
    """[N, 1, S, S] grayscale in [-1, 1] -> [N, 512] identity embedding."""

    def __init__(self, input_size: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.prelu = nn.PReLU()
        inplanes, side = 64, input_size // 2  # after the 2x2 max-pool
        for li, (planes, stride) in enumerate(LAYERS, start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                IRBlock(inplanes, planes, stride, dtype), IRBlock(planes, planes, 1, dtype)))
            inplanes = planes
            side = (side - 1) // stride + 1
        self.bn4 = nn.BatchNorm2d(512, eps=1e-5)
        self.fc5 = nn.Linear(512 * side * side, 512)
        self.bn5 = nn.BatchNorm1d(512, eps=1e-5)
        lecun_normal_(self)

    def forward(self, x):
        x = prelu(self.prelu, bn(self.bn1, conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 2, 2)
        for li in range(1, len(LAYERS) + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x)
        x = bn(self.bn4, x).flatten(1)  # NCHW flatten, as fc5's weight expects
        dt = torch.promote_types(x.dtype, torch.float32)
        x = F.linear(x.to(dt), self.fc5.weight.to(dt), self.fc5.bias.to(dt))
        return bn(self.bn5, x).to(self.dtype)
