"""upfirdn2d: upsample (zero-insertion) -> FIR filter -> downsample, NCHW.

Counterpart of ``fm3dgan/ops/upfirdn2d.py``:

    out[h, w] = sum_{kh, kw} k[kh, kw] * pad(upsample(x))[h*down + kh, w*down + kw]

as true convolution (flipped kernel), with per-axis zero-insertion by ``up``
(``up-1`` trailing zeros after the last sample), edge pads ``(pad0, pad1)``
that may be negative (cropping) and stride-``down`` decimation.

:func:`upfirdn2d`, :func:`upsample2d`, :func:`downsample2d` and the ``*_plain``
functions are plain PyTorch.  :func:`blur` and :func:`upsample2x` are the
wrappers of the hand-written CUDA kernels in ``csrc/upfirdn2d.cu``: on a CPU
tensor they run the plain version, on a CUDA tensor they launch the kernel or
raise for a configuration it does not take.  FIR kernels are host constants
(sequences or numpy arrays), as the TPU kernels needed static taps.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fm3dgan_torch.ops import _build


def make_kernel(k: Sequence[float]) -> np.ndarray:
    """1D -> outer-product 2D FIR kernel, normalized to sum 1 (float32)."""
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / np.sum(k)


def _normalize_args(up, down, pad):
    up_x, up_y = (up, up) if isinstance(up, int) else up
    down_x, down_y = (down, down) if isinstance(down, int) else down
    if len(pad) == 2:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad[0], pad[1], pad[0], pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    return up_x, up_y, down_x, down_y, pad_x0, pad_x1, pad_y0, pad_y1


def upfirdn2d(x: torch.Tensor, kernel, up=1, down=1, pad=(0, 0)) -> torch.Tensor:
    """Plain upfirdn2d on an NCHW tensor, computed in float32.

    kernel: [kh, kw] host array (true convolution).  up/down: int or (x, y).
    pad: (pad0, pad1) on both axes or (pad_x0, pad_x1, pad_y0, pad_y1).
    """
    up_x, up_y, down_x, down_y, px0, px1, py0, py1 = _normalize_args(up, down, pad)
    n, c, h, w = x.shape
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    kh, kw = k.shape
    y = x.float()
    if up_x > 1 or up_y > 1:
        y = y.reshape(n, c, h, 1, w, 1)
        y = F.pad(y, (0, up_x - 1, 0, 0, 0, up_y - 1))
        y = y.reshape(n, c, h * up_y, w * up_x)
    y = F.pad(y, (px0, px1, py0, py1))  # negative pads crop
    weight = torch.flip(k, (0, 1)).expand(c, 1, kh, kw)
    out = F.conv2d(y, weight, stride=(down_y, down_x), groups=c)
    return out.to(x.dtype)


def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """FIR upsample; the kernel is scaled by factor**2 (``upfirdn2d.py:211``)."""
    kernel = np.asarray(kernel, np.float32) * (factor**2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    kernel = np.asarray(kernel, np.float32)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def blur_plain(x: torch.Tensor, kernel, pad, upsample_factor: int = 1) -> torch.Tensor:
    kernel = np.asarray(kernel, np.float32)
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor**2)
    return upfirdn2d(x, kernel, pad=pad)


def upsample2x_plain(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """2x upsample with the separable kernel outer(kernel_1d, kernel_1d)."""
    k = np.asarray(kernel_1d, np.float32)
    return upfirdn2d(x, np.outer(k, k), up=2, pad=pad)


def _host_floats(a: np.ndarray):
    return (ctypes.c_float * a.size)(*a.astype(np.float32).ravel().tolist())


def blur(x: torch.Tensor, kernel, pad, upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (up = down = 1), pads (p0, p1) on both axes.

    Replaces fm3dgan/ops/pallas/upfirdn2d_kernel.py ``_blur_pallas``; on a CUDA
    tensor it launches ``fm_blur`` (any C, kernel <= 8x8, 0 <= p < k)."""
    if not _build.use_kernel(x):
        return blur_plain(x, kernel, pad, upsample_factor)
    k = np.asarray(kernel, np.float32)
    if upsample_factor > 1:
        k = k * (upsample_factor**2)
    p0, p1 = (int(v) for v in pad)
    _build.check_input(x, "blur")
    if x.dim() != 4 or k.ndim != 2:
        raise ValueError("blur takes an NCHW tensor and a 2-D kernel")
    kh, kw = k.shape
    n, c, h, w = x.shape
    if not (1 <= kh <= 8 and 1 <= kw <= 8):
        raise ValueError(f"blur kernel must be at most 8x8, got {k.shape}")
    if not (0 <= p0 < min(kh, kw) and 0 <= p1 < min(kh, kw)):
        raise ValueError(f"blur pads must satisfy 0 <= p < k, got {(p0, p1)}")
    oh, ow = h + p0 + p1 - kh + 1, w + p0 + p1 - kw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"blur output would be empty: {(oh, ow)}")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    taps = _host_floats(k)
    with torch.cuda.device(x.device):
        err = _build.library("upfirdn2d").fm_blur(
            x.data_ptr(), y.data_ptr(), ctypes.addressof(taps),
            _build.dtype_code(x), n * c, h, w, kh, kw, p0, p1, _build.stream_of(x),
        )
    _build.check(err, "fm_blur")
    blur.launches += 1
    return y


blur.launches = 0


def upsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """Separable 2x upsample, pads (p0, p1) with p0 + p1 = k - 1.

    Replaces ``_updown_pallas`` mode up2 (and the XLA ``_up2_polyphase_k4``
    at the ToRGB skip); on a CUDA tensor it launches ``fm_upsample2x``
    (any C, k <= 8)."""
    k = np.asarray(kernel_1d, np.float32)
    p0, p1 = (int(v) for v in pad)
    if k.ndim != 1 or p0 + p1 != k.size - 1 or p0 < 0 or p1 < 0:
        raise ValueError(
            f"upsample2x takes 1-D taps and pads p0 + p1 = k - 1, got k={k.shape}, "
            f"pad={(p0, p1)}"
        )
    if not _build.use_kernel(x):
        return upsample2x_plain(x, k, pad)
    _build.check_input(x, "upsample2x")
    if x.dim() != 4 or k.size > 8:
        raise ValueError("upsample2x takes an NCHW tensor and at most 8 taps")
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    taps = _host_floats(k)
    with torch.cuda.device(x.device):
        err = _build.library("upfirdn2d").fm_upsample2x(
            x.data_ptr(), y.data_ptr(), ctypes.addressof(taps), ctypes.addressof(taps),
            _build.dtype_code(x), n * c, h, w, k.size, p0, _build.stream_of(x),
        )
    _build.check(err, "fm_upsample2x")
    upsample2x.launches += 1
    return y


upsample2x.launches = 0
