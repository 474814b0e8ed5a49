"""Frozen copy of ``fm3dgan_torch/models/psp_encoder.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

pSp GradualStyleEncoder (E_W+), NCHW.

Counterpart of ``fm3dgan/models/psp_encoder.py`` with the reference pSp
state-dict names (``input_layer``, ``body.{i}``, ``styles.{j}``,
``latlayer1/2``): an IR-SE backbone with FPN taps at three levels,
align_corners bilinear lateral fusion, and n_styles GradualStyleBlocks split
coarse/middle/fine at indices 3/7 -> [N, n_styles, style_dim].  The IR / IR-SE
face-recognition :class:`Backbone` (``IR_50`` ... ``IR_SE_152``) shares its
bottleneck units, with the reference ``model_irse`` names (``input_layer``,
``body.{i}``, ``output_layer.{0, 3, 4}``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import bn, conv, prelu
from .layers import EqualLinear
from .precision import acc


def get_blocks(num_layers: int, width: int = 64) -> List[List[Tuple[int, int, int]]]:
    """(in_channel, depth, stride) units per stage; ``width`` scales depths."""

    def block(in_channel, depth, num_units, stride=2):
        in_channel = in_channel * width // 64
        depth = depth * width // 64
        return [(in_channel, depth, stride)] + [(depth, depth, 1) for _ in range(num_units - 1)]

    units = {
        18: (2, 2, 2, 2),
        50: (3, 4, 14, 3),
        100: (3, 13, 30, 3),
        152: (3, 8, 36, 3),
    }
    if num_layers not in units:
        raise ValueError(f"num_layers must be in (18, 50, 100, 152), got {num_layers}")
    n = units[num_layers]
    return [
        block(64, 64, n[0]),
        block(64, 128, n[1]),
        block(128, 256, n[2]),
        block(256, 512, n[3]),
    ]


class SEModule(nn.Module):
    """Squeeze-excitation; the reduced width has a floor of 1 channel."""

    def __init__(self, channels: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = max(1, channels // reduction)
        self.fc1 = nn.Conv2d(channels, mid, 1, bias=False)
        self.fc2 = nn.Conv2d(mid, channels, 1, bias=False)
        self.dtype = dtype

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(conv(self.fc1, s, self.dtype))
        s = conv(self.fc2, s, self.dtype)
        return x * torch.sigmoid(s)


class BottleneckIRSE(nn.Module):
    def __init__(self, in_channel: int, depth: int, stride: int, use_se: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        if in_channel == depth:
            self.shortcut_layer = None  # MaxPool2d(1, stride): a strided subsample
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False), nn.BatchNorm2d(depth),
            )
        layers = [
            nn.BatchNorm2d(in_channel),
            nn.Conv2d(in_channel, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            nn.BatchNorm2d(depth),
        ]
        if use_se:
            layers.append(SEModule(depth, 16, dtype))
        self.res_layer = nn.Sequential(*layers)

    def forward(self, x, train: bool = False):
        if self.shortcut_layer is None:
            shortcut = x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = bn(self.shortcut_layer[1], conv(self.shortcut_layer[0], x, self.dtype), train)
        r = self.res_layer
        res = bn(r[0], x, train)
        res = prelu(r[2], conv(r[1], res, self.dtype))
        res = bn(r[4], conv(r[3], res, self.dtype), train)
        if len(r) > 5:
            res = r[5](res)
        return res + shortcut


class Backbone(nn.Module):
    """IR / IR-SE face-recognition backbone: [N, 3, S, S] (S = 112 or 224)
    -> l2-normalised [N, 512] embedding.

    Frozen, as the JAX module is used: BatchNorm normalises with the running
    statistics and the dropout of ``output_layer.1`` is the identity.  The
    output layer is BatchNorm2d, Dropout, the NCHW flatten, Linear(512 * (S /
    16)^2, 512) and BatchNorm1d (without scale and bias unless ``affine``);
    the embedding is divided by its norm, without eps."""

    def __init__(self, input_size: int = 112, num_layers: int = 50, mode: str = "ir",
                 drop_ratio: float = 0.4, affine: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_size not in (112, 224):
            raise ValueError(f"input_size should be 112 or 224, got {input_size}")
        if num_layers not in (50, 100, 152):
            raise ValueError(f"num_layers should be 50, 100 or 152, got {num_layers}")
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"mode should be ir or ir_se, got {mode}")
        self.dtype = dtype
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64), nn.PReLU(64),
        )
        self.body = nn.Sequential(*(
            BottleneckIRSE(cin, depth, stride, mode == "ir_se", dtype)
            for stage in get_blocks(num_layers) for (cin, depth, stride) in stage
        ))
        side = input_size // 16
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(512), nn.Dropout(drop_ratio), nn.Flatten(),
            nn.Linear(512 * side * side, 512), nn.BatchNorm1d(512, affine=affine),
        )

    def forward(self, x):
        il, ol = self.input_layer, self.output_layer
        x = prelu(il[2], bn(il[1], conv(il[0], x, self.dtype)))
        for unit in self.body:
            x = unit(x)
        x = bn(ol[0], x).flatten(1)
        x = F.linear(x.to(self.dtype), ol[3].weight.to(self.dtype), ol[3].bias.to(self.dtype))
        b = ol[4]
        xf = acc(x)
        x = F.batch_norm(xf, b.running_mean.to(xf.dtype), b.running_var.to(xf.dtype),
                         None if b.weight is None else b.weight.to(xf.dtype),
                         None if b.bias is None else b.bias.to(xf.dtype),
                         False, 0.0, b.eps).to(x.dtype)
        return x / torch.linalg.vector_norm(acc(x), dim=-1, keepdim=True).to(x.dtype)


def IR_50(input_size: int = 112, dtype: torch.dtype = torch.float32) -> Backbone:
    return Backbone(input_size, 50, "ir", affine=False, dtype=dtype)


def IR_101(input_size: int = 112, dtype: torch.dtype = torch.float32) -> Backbone:
    return Backbone(input_size, 100, "ir", affine=False, dtype=dtype)


def IR_152(input_size: int = 112, dtype: torch.dtype = torch.float32) -> Backbone:
    return Backbone(input_size, 152, "ir", affine=False, dtype=dtype)


def IR_SE_50(input_size: int = 112, dtype: torch.dtype = torch.float32) -> Backbone:
    return Backbone(input_size, 50, "ir_se", affine=False, dtype=dtype)


def IR_SE_101(input_size: int = 112, dtype: torch.dtype = torch.float32) -> Backbone:
    return Backbone(input_size, 100, "ir_se", affine=False, dtype=dtype)


def IR_SE_152(input_size: int = 112, dtype: torch.dtype = torch.float32) -> Backbone:
    return Backbone(input_size, 152, "ir_se", affine=False, dtype=dtype)


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 convs with LeakyReLU(0.01), then EqualLinear."""

    def __init__(self, in_c: int, out_c: int, spatial: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_c = out_c
        self.dtype = dtype
        mods = []
        for i in range(int(math.log2(spatial))):
            mods += [nn.Conv2d(in_c if i == 0 else out_c, out_c, 3, 2, 1), nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*mods)
        self.linear = EqualLinear(out_c, out_c, dtype=dtype)

    def forward(self, x):
        for m in self.convs[::2]:
            x = F.leaky_relu(conv(m, x, self.dtype), 0.01)
        return self.linear(x.reshape(x.shape[0], self.out_c))


class GradualStyleEncoder(nn.Module):
    """E_W+: photo [N, 3, H, W] -> [N, n_styles, style_dim] W+ codes."""

    def __init__(
        self,
        num_layers: int = 18,
        mode: str = "ir_se",
        n_styles: int = 14,
        input_nc: int = 3,
        coarse_ind: int = 3,
        middle_ind: int = 7,
        input_size: int = 256,
        width: int = 64,
        style_dim: int = 512,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if num_layers not in (18, 50):
            raise ValueError("FPN tap indices are defined for 18 and 50 layers")
        self.dtype = dtype
        self.coarse_ind = coarse_ind
        self.middle_ind = middle_ind
        self.taps = {18: (3, 5, 7), 50: (6, 20, 23)}[num_layers]
        self.input_layer = nn.Sequential(
            nn.Conv2d(input_nc, width, 3, 1, 1, bias=False), nn.BatchNorm2d(width), nn.PReLU(width),
        )
        use_se = mode == "ir_se"
        self.body = nn.ModuleList(
            BottleneckIRSE(cin, depth, stride, use_se, dtype)
            for stage in get_blocks(num_layers, width)
            for (cin, depth, stride) in stage
        )
        fpn_c = 8 * width
        self.styles = nn.ModuleList()
        # As in the JAX module, the coarse and middle blocks always exist, so
        # n_styles < middle_ind still yields middle_ind codes.
        for j in range(max(n_styles, middle_ind)):
            spatial = input_size // (16 if j < coarse_ind else 8 if j < middle_ind else 4)
            self.styles.append(GradualStyleBlock(fpn_c, style_dim, spatial, dtype))
        self.latlayer1 = nn.Conv2d(4 * width, fpn_c, 1)
        self.latlayer2 = nn.Conv2d(2 * width, fpn_c, 1)

    def forward(self, x, train: bool = False):
        """x: [N, 3, H, W]; ``train`` normalises with batch statistics and
        updates the running ones."""
        il = self.input_layer
        x = prelu(il[2], bn(il[1], conv(il[0], x, self.dtype), train))
        feats = {}
        for i, unit in enumerate(self.body):
            x = unit(x, train)
            if i in self.taps:
                feats[i] = x
        c1, c2, c3 = (feats[t] for t in self.taps)

        latents = [self.styles[j](c3) for j in range(self.coarse_ind)]
        lat1 = conv(self.latlayer1, c2, self.dtype)
        p2 = _upsample_align_corners(c3, lat1) + lat1
        latents += [self.styles[j](p2) for j in range(self.coarse_ind, self.middle_ind)]
        lat2 = conv(self.latlayer2, c1, self.dtype)
        p1 = _upsample_align_corners(p2, lat2) + lat2
        latents += [self.styles[j](p1) for j in range(self.middle_ind, len(self.styles))]
        return torch.stack(latents, dim=1)


def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] interpolation matrix for align_corners=True bilinear."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


def _upsample_align_corners(x, like):
    """Bilinear resize (align_corners=True) to ``like``'s size as two small
    interpolation matmuls, as the JAX module computes it.  Unlike
    ``F.interpolate``, whose CUDA backward accumulates with atomics, the
    gradient is the same from run to run."""
    (h, w), (oh, ow) = x.shape[2:], like.shape[2:]
    if (h, w) == (oh, ow):
        return x
    wy = torch.as_tensor(_align_corners_matrix(h, oh), dtype=x.dtype, device=x.device)
    wx = torch.as_tensor(_align_corners_matrix(w, ow), dtype=x.dtype, device=x.device)
    x = torch.einsum("oh,nchw->ncow", wy, x)
    return torch.einsum("ow,nchw->ncho", wx, x)
