"""pSp GradualStyleEncoder (E_W+), NCHW.

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

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fm3dgan_torch.models._common import bn, conv, prelu
from fm3dgan_torch.nn.layers import EqualLinear
from fm3dgan_torch.precision import acc
from fm3dgan_torch.utils import streams
from fm3dgan_torch.utils.spans import span


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
        with span("fm3d.model.psp_body"):
            x = prelu(il[2], bn(il[1], conv(il[0], x, self.dtype), train))
            feats = {}
            for i, unit in enumerate(self.body):
                x = unit(x, train)
                if i in self.taps:
                    feats[i] = x
        c1, c2, c3 = (feats[t] for t in self.taps)

        # Each style block is a branch of its own (utils/streams.py), forked
        # as soon as its input exists: while a CUDA graph is captured the
        # coarse blocks run beside the lateral fusion, the middle ones beside
        # p1's, and all join before the stack.
        def blocks(lo, hi, x):
            return [functools.partial(self.styles[j], x) for j in range(lo, hi)]

        def fine(p2):
            lat2 = conv(self.latlayer2, c1, self.dtype)
            p1 = _upsample_align_corners(p2, lat2) + lat2
            return streams.fork(blocks(self.middle_ind, len(self.styles), p1))[1]

        def middle_and_fine():
            lat1 = conv(self.latlayer1, c2, self.dtype)
            p2 = _upsample_align_corners(c3, lat1) + lat1
            fine_latents, middle = streams.fork(blocks(self.coarse_ind, self.middle_ind, p2),
                                                functools.partial(fine, p2))
            return middle + fine_latents

        with span("fm3d.model.psp_styles"):
            rest, coarse = streams.fork(blocks(0, self.coarse_ind, c3), middle_and_fine)
            return torch.stack(coarse + rest, dim=1)


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


@functools.lru_cache(maxsize=None)
def _align_corners_weights(in_size: int, out_size: int, dtype: torch.dtype,
                           device: torch.device) -> torch.Tensor:
    """:func:`_align_corners_matrix` on ``device``, made once: a CUDA graph's
    capture cannot copy from the host, and an eager call saves the copy.  It
    is never an inference tensor, so a forward with gradients can save it."""
    with torch.inference_mode(False):
        return torch.as_tensor(_align_corners_matrix(in_size, out_size), dtype=dtype,
                               device=device)


def _interpolation(in_size: int, out_size: int, x: torch.Tensor) -> torch.Tensor:
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        # A tracer's tensors must not outlive the trace in the cache.
        return torch.as_tensor(_align_corners_matrix(in_size, out_size), dtype=x.dtype,
                               device=x.device)
    return _align_corners_weights(in_size, out_size, x.dtype, x.device)


def _upsample_align_corners(x, like):
    """Bilinear resize (align_corners=True) to ``like``'s size as two small
    interpolation matmuls, as the JAX module computes it.  Unlike
    ``F.interpolate``, whose CUDA backward accumulates with atomics, the
    gradient is the same from run to run."""
    (h, w), (oh, ow) = x.shape[2:], like.shape[2:]
    if (h, w) == (oh, ow):
        return x
    wy, wx = _interpolation(h, oh, x), _interpolation(w, ow, x)
    x = torch.einsum("oh,nchw->ncow", wy, x)
    return torch.einsum("ow,nchw->ncho", wx, x)
