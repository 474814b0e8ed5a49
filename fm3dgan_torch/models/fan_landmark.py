"""FAN 2-D facial-landmark network (68 heatmaps) and its decoding, NCHW.

Counterpart of ``fm3dgan/models/fan_landmark.py``: the 4-stack hourglass
FAN of face-alignment's 2DFAN-4, [N, 3, S, S] RGB in [0, 1] -> [N, 68, S/4,
S/4] heatmaps; ``heatmaps_to_landmarks`` (argmax with the quarter-pixel
refinement), ``landmarks_68_to_5``, ``center_crop_for_fan`` and
``fan_heatmap_fn``.

State-dict names are face-alignment's (``conv1``, ``bn1``, ``conv2..4``,
``m{i}.b{1,2,3}_{n}`` and ``m{i}.b2_plus_1``, ``top_m_{i}``,
``conv_last{i}``, ``bn_end{i}``, ``l{i}``, ``bl{i}``, ``al{i}``; each
ConvBlock ``bn1..3``, ``conv1..3`` and ``downsample.{0, 2}``), the names
``fm3dgan/models/fan_landmark.py``'s ``convert_fan`` reads.  As in the JAX
module, ``conv_last{i}``, ``bl{i}`` and ``al{i}`` have no bias.

Always frozen: BatchNorm normalises with the running statistics (eps 1e-5).
``dtype`` is the compute dtype of the convolutions (``_common``), as for the
other frozen networks.  Inputs are a multiple of 64 px: the stem and the
hourglass halve them six times.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fm3dgan_torch.models._common import bn, conv, lecun_normal_
from fm3dgan_torch.nn.resize import resize_bilinear

N_LANDMARKS = 68


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5)


class ConvBlock(nn.Module):
    """bn-relu-conv3x3 three times at C/2, C/4, C/4, concatenated, plus the
    input (through bn-relu-conv1x1 where the width changes)."""

    def __init__(self, in_planes: int, out_planes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        o2, o4 = out_planes // 2, out_planes // 4
        self.bn1 = _bn(in_planes)
        self.conv1 = nn.Conv2d(in_planes, o2, 3, 1, 1, bias=False)
        self.bn2 = _bn(o2)
        self.conv2 = nn.Conv2d(o2, o4, 3, 1, 1, bias=False)
        self.bn3 = _bn(o4)
        self.conv3 = nn.Conv2d(o4, o4, 3, 1, 1, bias=False)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(_bn(in_planes), nn.ReLU(),
                                            nn.Conv2d(in_planes, out_planes, 1, bias=False))
        self.dtype = dtype

    def forward(self, x):
        y1 = conv(self.conv1, F.relu(bn(self.bn1, x)), self.dtype)
        y2 = conv(self.conv2, F.relu(bn(self.bn2, y1)), self.dtype)
        y3 = conv(self.conv3, F.relu(bn(self.bn3, y2)), self.dtype)
        out = torch.cat([y1, y2, y3], dim=1)
        if self.downsample is None:
            return out + x
        return out + conv(self.downsample[2], F.relu(bn(self.downsample[0], x)), self.dtype)


class HourGlass(nn.Module):
    """Recursive hourglass of ``depth`` levels over ``features`` channels."""

    def __init__(self, depth: int = 4, features: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for n in range(depth, 0, -1):
            self.add_module(f"b1_{n}", ConvBlock(features, features, dtype))
            self.add_module(f"b2_{n}", ConvBlock(features, features, dtype))
            if n == 1:
                self.add_module(f"b2_plus_{n}", ConvBlock(features, features, dtype))
            self.add_module(f"b3_{n}", ConvBlock(features, features, dtype))

    def _level(self, n: int, x):
        up1 = getattr(self, f"b1_{n}")(x)
        low1 = getattr(self, f"b2_{n}")(F.avg_pool2d(x, 2, 2))
        low2 = self._level(n - 1, low1) if n > 1 else getattr(self, f"b2_plus_{n}")(low1)
        low3 = getattr(self, f"b3_{n}")(low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(self.depth, x)


class FAN(nn.Module):
    """[N, 3, S, S] RGB in [0, 1] -> [N, 68, S/4, S/4] heatmaps (those of the
    last stack)."""

    def __init__(self, num_modules: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_modules = num_modules
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = _bn(64)
        self.conv2 = ConvBlock(64, 128, dtype)
        self.conv3 = ConvBlock(128, 128, dtype)
        self.conv4 = ConvBlock(128, 256, dtype)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256, dtype))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, dtype))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1, bias=False))
            self.add_module(f"bn_end{i}", _bn(256))
            self.add_module(f"l{i}", nn.Conv2d(256, N_LANDMARKS, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1, bias=False))
                self.add_module(f"al{i}", nn.Conv2d(N_LANDMARKS, 256, 1, bias=False))
        lecun_normal_(self)

    def forward(self, x):
        x = F.relu(bn(self.bn1, conv(self.conv1, x, self.dtype)))
        x = F.avg_pool2d(self.conv2(x), 2, 2)
        previous = self.conv4(self.conv3(x))
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(bn(getattr(self, f"bn_end{i}"), conv(getattr(self, f"conv_last{i}"), ll,
                                                               self.dtype)))
            heatmap = conv(getattr(self, f"l{i}"), ll, self.dtype)
            if i < self.num_modules - 1:
                previous = (previous + conv(getattr(self, f"bl{i}"), ll, self.dtype)
                            + conv(getattr(self, f"al{i}"), heatmap, self.dtype))
        return heatmap


def heatmaps_to_landmarks(heatmaps: torch.Tensor) -> torch.Tensor:
    """[N, 68, H, W] -> [N, 68, 2] (x, y), float32: the first maximum of each
    map, moved a quarter pixel toward the larger of its two neighbours along
    each axis (no move on a tie; neighbours clamped at the border)."""
    n, c, h, w = heatmaps.shape
    idx = heatmaps.reshape(n, c, h * w).argmax(dim=-1)
    ys, xs = idx // w, idx % w
    rows = heatmaps.gather(2, ys[..., None, None].expand(n, c, 1, w)).squeeze(2)  # [N, C, W]
    cols = heatmaps.gather(3, xs[..., None, None].expand(n, c, h, 1)).squeeze(3)  # [N, C, H]

    def step(line, i, size):
        hi = line.gather(-1, (i + 1).clamp(max=size - 1)[..., None])[..., 0]
        lo = line.gather(-1, (i - 1).clamp(min=0)[..., None])[..., 0]
        return torch.sign(hi - lo).float() * 0.25

    return torch.stack([xs.float() + step(rows, xs, w), ys.float() + step(cols, ys, h)], dim=-1)


def landmarks_68_to_5(lm68) -> np.ndarray:
    """[N, 68, 2] iBUG landmarks -> [N, 5, 2]: left eye, right eye (each the
    centroid of its 6-point contour), nose tip (30), left and right mouth
    corners (48, 54)."""
    lm68 = np.asarray(lm68)
    return np.stack([lm68[:, 36:42].mean(axis=1), lm68[:, 42:48].mean(axis=1), lm68[:, 30],
                     lm68[:, 48], lm68[:, 54]], axis=1)


def center_crop_for_fan(images: torch.Tensor, target_size: int = 256) -> torch.Tensor:
    """[N, 3, H, W] aligned face crops in [-1, 1] -> FAN input in [0, 1] at
    ``target_size`` (256 for the pretrained 2DFAN-4): for aligned crops the
    reference's full-image face box makes the crop a rescale."""
    return resize_bilinear((images + 1.0) / 2.0, target_size)


def fan_heatmap_fn(fan: FAN, target_size: int = 256) -> Callable[[torch.Tensor], torch.Tensor]:
    """images [N, 3, H, W] in [-1, 1] -> heatmaps, for the heatmap loss."""
    return lambda images: fan(center_crop_for_fan(images, target_size))


def fan_heatmap_landmark_fn(
    fan: FAN, target_size: int = 256
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """images [N, 3, H, W] in [-1, 1] -> (heatmaps, landmarks), the
    ``heatmap_landmark_fn`` of the edit score."""
    heatmap_fn = fan_heatmap_fn(fan, target_size)

    def fn(images):
        hm = heatmap_fn(images)
        return hm, heatmaps_to_landmarks(hm)

    return fn
