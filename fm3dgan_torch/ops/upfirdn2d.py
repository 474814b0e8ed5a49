"""upfirdn2d: upsample (zero-insertion) -> FIR filter -> downsample, NCHW.

Counterpart of ``fm3dgan/ops/upfirdn2d.py``:

    out[h, w] = sum_{kh, kw} k[kh, kw] * pad(upsample(x))[h*down + kh, w*down + kw]

as true convolution (flipped kernel), with per-axis zero-insertion by ``up``
(``up-1`` trailing zeros after the last sample), edge pads ``(pad0, pad1)``
that may be negative (cropping) and stride-``down`` decimation.

:func:`upfirdn2d`, :func:`upsample2d`, :func:`downsample2d` and the ``*_plain``
functions are plain PyTorch.  :func:`blur`, :func:`upsample2x` and
:func:`downsample2x` wrap the hand-written CUDA kernels in
``csrc/upfirdn2d.cu`` in ``torch.autograd.Function``s whose backwards are the
adjoints of ``fm3dgan/ops/pallas/upfirdn2d_kernel.py`` (``_blur_bwd``,
``_resample_bwd``), built from the same Functions and so twice
differentiable:

* blur -> blur with the flipped kernel and pads (k-1-p0, k-1-p1);
* up2 (pads p0, p1) -> down2 with the flipped taps and pads (k-p0-1, p0-1);
* down2 (pads p0, p1) -> up2 with the flipped taps and pads
  (k-p0-1, H-2*OH+p0), an exact 2x upsample when H = 2*OH.

Every launch goes through one ``_launch_*`` helper, which runs the plain
version on a CPU tensor (and under ``plain_versions()``) and launches the
kernel on a CUDA tensor or raises for a configuration it does not take; so
the CPU runs the same autograd wiring as the card.  FIR kernels are host
constants (sequences or numpy arrays), as the TPU kernels needed static taps.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fm3dgan_torch.ops import _build
from fm3dgan_torch.precision import acc


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
    """Plain upfirdn2d on an NCHW tensor, computed in float32 (float64 for
    float64).

    kernel: [kh, kw] host array (true convolution).  up/down: int or (x, y).
    pad: (pad0, pad1) on both axes or (pad_x0, pad_x1, pad_y0, pad_y1).
    """
    up_x, up_y, down_x, down_y, px0, px1, py0, py1 = _normalize_args(up, down, pad)
    n, c, h, w = x.shape
    y = acc(x)
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device, dtype=y.dtype)
    kh, kw = k.shape
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


def downsample2x_plain(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """FIR with outer(kernel_1d, kernel_1d), then keep every second sample."""
    k = np.asarray(kernel_1d, np.float32)
    return upfirdn2d(x, np.outer(k, k), down=2, pad=pad)


def _host_floats(a: np.ndarray):
    return (ctypes.c_float * a.size)(*a.astype(np.float32).ravel().tolist())


def _launch_blur(x: torch.Tensor, k: np.ndarray, p0: int, p1: int) -> torch.Tensor:
    if not _build.use_kernel(x):
        return upfirdn2d(x, k, pad=(p0, p1))
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


def _launch_up2(x: torch.Tensor, k: np.ndarray, p0: int, p1: int) -> torch.Tensor:
    if not _build.use_kernel(x):
        return upsample2x_plain(x, k, (p0, p1))
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


def _launch_down2(x: torch.Tensor, k: np.ndarray, p0: int, p1: int) -> torch.Tensor:
    if not _build.use_kernel(x):
        return downsample2x_plain(x, k, (p0, p1))
    _build.check_input(x, "downsample2x")
    if x.dim() != 4 or k.size > 8:
        raise ValueError("downsample2x takes an NCHW tensor and at most 8 taps")
    n, c, h, w = x.shape
    y = torch.empty((n, c) + _down2_hw(h, w, k.size, p0, p1), dtype=x.dtype, device=x.device)
    taps = _host_floats(k)
    with torch.cuda.device(x.device):
        err = _build.library("upfirdn2d").fm_downsample2x(
            x.data_ptr(), y.data_ptr(), ctypes.addressof(taps), ctypes.addressof(taps),
            _build.dtype_code(x), n * c, h, w, k.size, p0, p1, _build.stream_of(x),
        )
    _build.check(err, "fm_downsample2x")
    downsample2x.launches += 1
    return y


def _down2_hw(h: int, w: int, k: int, p0: int, p1: int):
    if h + p0 + p1 - k < 0 or w + p0 + p1 - k < 0:
        raise ValueError(f"downsample2x output would be empty: {(h, w)}, k={k}, pad={(p0, p1)}")
    return (h + p0 + p1 - k) // 2 + 1, (w + p0 + p1 - k) // 2 + 1


class _BlurFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, p0, p1):
        ctx.k, ctx.pads = k, (p0, p1)
        return _launch_blur(x, k, p0, p1)

    @staticmethod
    def backward(ctx, grad):
        k = ctx.k
        kh, kw = k.shape
        if kh != kw:
            raise NotImplementedError("the blur adjoint takes square kernels (_blur_bwd)")
        p0, p1 = ctx.pads
        kflip = np.ascontiguousarray(k[::-1, ::-1])
        return _BlurFn.apply(grad.contiguous(), kflip, kh - 1 - p0, kh - 1 - p1), None, None, None


class _Upsample2xFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, p0, p1):
        ctx.k, ctx.p0 = k, p0
        return _launch_up2(x, k, p0, p1)

    @staticmethod
    def backward(ctx, grad):
        k, p0 = ctx.k, ctx.p0
        kflip = np.ascontiguousarray(k[::-1])
        # _resample_bwd with up=2, down=1, OH = 2H: g1 = p0 - 1.
        return _Downsample2xFn.apply(grad.contiguous(), kflip, k.size - p0 - 1, p0 - 1), None, None, None


class _Downsample2xFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, p0, p1):
        ctx.k, ctx.p0, ctx.in_hw = k, p0, tuple(x.shape[2:])
        return _launch_down2(x, k, p0, p1)

    @staticmethod
    def backward(ctx, grad):
        k, p0 = ctx.k, ctx.p0
        (h, w), (oh, ow) = ctx.in_hw, tuple(grad.shape[2:])
        if h != 2 * oh or w != 2 * ow:
            raise NotImplementedError(
                f"the down2 adjoint is an exact 2x upsample only when H = 2*OH; got "
                f"{(h, w)} -> {(oh, ow)}"
            )
        kflip = np.ascontiguousarray(k[::-1])
        # _resample_bwd with up=1, down=2: g0 = k-p0-1, g1 = H-2*OH+p0 = p0.
        return _Upsample2xFn.apply(grad.contiguous(), kflip, k.size - p0 - 1, p0), None, None, None


def blur(x: torch.Tensor, kernel, pad, upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (up = down = 1), pads (p0, p1) on both axes.

    Replaces fm3dgan/ops/pallas/upfirdn2d_kernel.py ``_blur_pallas`` and its
    adjoint ``_blur_bwd``; on a CUDA tensor it launches ``fm_blur`` (any C,
    kernel <= 8x8, 0 <= p < k)."""
    k = np.asarray(kernel, np.float32)
    if upsample_factor > 1:
        k = k * (upsample_factor**2)
    p0, p1 = (int(v) for v in pad)
    return _BlurFn.apply(x, k, p0, p1)


def upsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """Separable 2x upsample, pads (p0, p1) with p0 + p1 = k - 1.

    Replaces ``_updown_pallas`` mode up2 (and the XLA ``_up2_polyphase_k4``
    at the ToRGB skip); on a CUDA tensor it launches ``fm_upsample2x``
    (any C, k <= 8).  Its backward is :func:`downsample2x`."""
    k = np.asarray(kernel_1d, np.float32)
    p0, p1 = (int(v) for v in pad)
    if k.ndim != 1 or p0 + p1 != k.size - 1 or p0 < 0 or p1 < 0:
        raise ValueError(
            f"upsample2x takes 1-D taps and pads p0 + p1 = k - 1, got k={k.shape}, "
            f"pad={(p0, p1)}"
        )
    return _Upsample2xFn.apply(x, k, p0, p1)


def downsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """Separable FIR with stride-2 decimation, pads (p0, p1) on both axes,
    output ((H + p0 + p1 - k)//2 + 1, (W + p0 + p1 - k)//2 + 1).

    Replaces ``_updown_pallas`` mode down2, the counterpart of
    ``resample2x_pallas(x, k, k, 1, 2, p0, p1)``; on a CUDA tensor it launches
    ``fm_downsample2x`` (any C, k <= 8).  Its backward is :func:`upsample2x`."""
    k = np.asarray(kernel_1d, np.float32)
    if k.ndim != 1:
        raise ValueError(f"downsample2x takes 1-D taps, got {k.shape}")
    p0, p1 = (int(v) for v in pad)
    _down2_hw(x.shape[2], x.shape[3], k.size, p0, p1)
    return _Downsample2xFn.apply(x, k, p0, p1)


blur.launches = 0
upsample2x.launches = 0
downsample2x.launches = 0
