"""FID InceptionV3 (pool3 features), NCHW.

Counterpart of ``fm3dgan/models/inception.py``: pytorch-fid's port of the
TF-FID InceptionV3, torchvision's topology with the FID patches (the
average pools of InceptionA, C and E leave the padding out of the count; the
last InceptionE pools with a 3x3 max pool), returning the 2048-wide pool3
features.  Inputs are in [-1, 1] (pytorch-fid's ``normalize_input=False``),
resized to 299 px bilinearly first unless ``resize_input`` is False.

State-dict names are torchvision's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ...), the names
``convert_fid_inception`` reads; :func:`fid_inception_state_dict` drops the
``fc`` and ``AuxLogits`` entries of a pytorch-fid ``.pth``.  BasicConv2d's
BatchNorm uses eps 1e-3.  Always frozen.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fm3dgan_torch.models._common import bn, conv, lecun_normal_
from fm3dgan_torch.nn.resize import resize_bilinear
from fm3dgan_torch.precision import acc

Pad = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], stride: int = 1,
                 padding: Pad = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, tuple(kernel), stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)
        self.dtype = dtype

    def forward(self, x):
        return F.relu(bn(self.bn, conv(self.conv, x, self.dtype)))


def _avg_pool_3x3(x):
    """3x3 average pool, stride 1, padding 1, the padding left out of the
    count (the TF/FID convention)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.branch1x1 = c(in_ch, 64, (1, 1))
        self.branch5x5_1 = c(in_ch, 48, (1, 1))
        self.branch5x5_2 = c(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = c(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = c(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = c(96, 96, (3, 3), padding=1)
        self.branch_pool = c(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.branch3x3 = c(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = c(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = c(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = c(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        c7 = channels_7x7
        self.branch1x1 = c(in_ch, 192, (1, 1))
        self.branch7x7_1 = c(in_ch, c7, (1, 1))
        self.branch7x7_2 = c(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = c(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = c(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = c(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = c(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = c(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = c(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = c(in_ch, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.branch3x3_1 = c(in_ch, 192, (1, 1))
        self.branch3x3_2 = c(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = c(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = c(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = c(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = c(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, use_max_pool: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.use_max_pool = use_max_pool
        self.branch1x1 = c(in_ch, 320, (1, 1))
        self.branch3x3_1 = c(in_ch, 384, (1, 1))
        self.branch3x3_2a = c(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = c(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = c(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = c(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = c(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = c(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = c(in_ch, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool else _avg_pool_3x3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Pool3(nn.Module):
    """Images [N, 3, H, W] in [-1, 1] -> [N, 2048] pool3 features."""

    def __init__(self, resize_input: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resize_input = resize_input
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)  # noqa: E731
        self.Conv2d_1a_3x3 = c(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = c(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = c(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = c(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = c(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32, dtype)
        self.Mixed_5c = InceptionA(256, 64, dtype)
        self.Mixed_5d = InceptionA(288, 64, dtype)
        self.Mixed_6a = InceptionB(288, dtype)
        self.Mixed_6b = InceptionC(768, 128, dtype)
        self.Mixed_6c = InceptionC(768, 160, dtype)
        self.Mixed_6d = InceptionC(768, 160, dtype)
        self.Mixed_6e = InceptionC(768, 192, dtype)
        self.Mixed_7a = InceptionD(768, dtype)
        self.Mixed_7b = InceptionE(1280, dtype=dtype)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True, dtype=dtype)
        lecun_normal_(self)

    def forward(self, x):
        if self.resize_input:
            x = resize_bilinear(x, 299)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return acc(x).mean(dim=(2, 3))


def fid_inception_state_dict(sd: Dict[str, torch.Tensor],
                             module: InceptionV3Pool3) -> Dict[str, torch.Tensor]:
    """A pytorch-fid InceptionV3 state dict (``pt_inception-2015-12-05``)
    -> one that ``module`` loads strictly: without ``fc`` and ``AuxLogits``,
    with the module's own BatchNorm step counters where the file has none."""
    out = {k: v for k, v in sd.items() if not k.startswith(("fc.", "AuxLogits."))}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out.setdefault(k, v)
    return out
