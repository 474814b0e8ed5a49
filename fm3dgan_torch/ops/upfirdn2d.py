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
constants (sequences or numpy arrays), as the TPU kernels needed static taps;
each distinct value becomes one cached ``_build.HostTaps``.  blur, up2 and
down2 go through their Function only where autograd records (an input that
requires grad, grad mode on), and are launched directly otherwise: the
Function's host cost is larger than the kernel at the small shapes.

The blur kernel stages a tile of each plane in shared memory and sums the
taps row by row, column by column, the plain version's order to the bit.
Unlike the TPU kernel it does not filter rank-1 taps rows, then columns:
for StyleGAN2's 4 x 4 ``make_kernel`` taps that order's other rounding
moved noise-dominated 256 px R1 gradients past their bar
(``csrc/upfirdn2d.cu``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

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
    k = torch.tensor(np.asarray(kernel, np.float32), device=x.device, dtype=y.dtype)
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


def phase_taps(k1d, p0: int) -> List[List[Tuple[int, float]]]:
    """For output phase a in {0, 1} of a 2x upsample with pads (p0, k-1-p0):
    the (input offset, weight) taps, out[2y + a] = sum w * x[y + offset]
    (``_phase_taps(k1d, 2, p0)`` of the TPU kernel)."""
    kf = np.asarray(k1d, np.float32)[::-1]  # true convolution
    return [[((a - p0 + t) // 2, float(kf[t])) for t in range(kf.size) if (a - p0 + t) % 2 == 0]
            for a in (0, 1)]


class _Up2Phases(ctypes.Structure):
    """``Up2Phases`` of csrc/upfirdn2d.cu: out[2y + a] = sum_{j < nt}
    w[a][j] * x[y + base + (shift1 if a else 0) + j]."""

    _fields_ = [("nt", ctypes.c_int), ("base", ctypes.c_int), ("shift1", ctypes.c_int),
                ("w", (ctypes.c_float * 4) * 2)]


_up2_tables: Dict[Tuple, Tuple[_Up2Phases, int]] = {}


def up2_phases(taps: "_build.HostTaps", p0: int) -> Tuple[_Up2Phases, int]:
    """K4's phase table for these taps and p0, and its address; built once.

    Each phase's offsets are consecutive; phase 0 starts at ``base``, phase 1
    at ``base + shift1`` with shift1 = 1 when p0 is even, else 0.  Shorter
    phases are padded with zero weights to nt, an empty one (k = 1) wholly.
    p0 may be negative: the down2 adjoint calls up2 with pads (k-p0-1, p0)."""
    key = (taps.key, p0)
    entry = _up2_tables.get(key)
    if entry is None:
        phases = phase_taps(taps.array, p0)
        base = (phases[0] or phases[1])[0][0]
        shift1 = phases[1][0][0] - base if phases[0] and phases[1] else 0
        table = _Up2Phases(max(len(ph) for ph in phases), base, shift1)
        for a, ph in enumerate(phases):
            for j, (offset, w) in enumerate(ph):
                assert offset == base + (shift1 if a else 0) + j, (phases, p0)
                table.w[a][j] = w
        assert 1 <= table.nt <= 4 and shift1 in (0, 1), (phases, p0)
        entry = _up2_tables.setdefault(key, (table, ctypes.addressof(table)))
    return entry


class _Down2Params(ctypes.Structure):
    """``Down2Params`` of csrc/upfirdn2d.cu: out[o] = sum_t w[t] * xpad[2o + t]
    with w the flipped taps, pads (p0, p1)."""

    _fields_ = [("k", ctypes.c_int), ("p0", ctypes.c_int), ("p1", ctypes.c_int),
                ("w", ctypes.c_float * 8)]


_down2_tables: Dict[Tuple, Tuple[_Down2Params, int]] = {}


def down2_params(taps: "_build.HostTaps", p0: int, p1: int) -> Tuple[_Down2Params, int]:
    """K5's taps (flipped) and pads, and their address; built once."""
    key = (taps.key, p0, p1)
    entry = _down2_tables.get(key)
    if entry is None:
        kf = taps.flipped.array
        params = _Down2Params(kf.size, p0, p1)
        params.w[:kf.size] = kf.tolist()
        entry = _down2_tables.setdefault(key, (params, ctypes.addressof(params)))
    return entry


def _launch_blur(x: torch.Tensor, taps: "_build.HostTaps", p0: int, p1: int) -> torch.Tensor:
    k = taps.array
    if not _build.use_kernel(x):
        return upfirdn2d(x, k, pad=(p0, p1))
    code = _build.check_input(x, "blur")
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
    _build.launch(_build.library("upfirdn2d").fm_blur, x, x.data_ptr(), y.data_ptr(),
                  taps.address, code, n * c, h, w, kh, kw, p0, p1)
    blur.launches += 1
    return y


def _launch_up2(x: torch.Tensor, taps: "_build.HostTaps", p0: int, p1: int) -> torch.Tensor:
    if not _build.use_kernel(x):
        return upsample2x_plain(x, taps.array, (p0, p1))
    code = _build.check_input(x, "upsample2x")
    if x.dim() != 4 or taps.array.size > 8:
        raise ValueError("upsample2x takes an NCHW tensor and at most 8 taps")
    n, c, h, w = x.shape
    y = x.new_empty((n, c, 2 * h, 2 * w))
    _build.launch(_build.library("upfirdn2d").fm_upsample2x, x, x.data_ptr(), y.data_ptr(),
                  up2_phases(taps, p0)[1], code, n * c, h, w)
    upsample2x.launches += 1
    return y


def _launch_down2(x: torch.Tensor, taps: "_build.HostTaps", p0: int, p1: int) -> torch.Tensor:
    if not _build.use_kernel(x):
        return downsample2x_plain(x, taps.array, (p0, p1))
    code = _build.check_input(x, "downsample2x")
    k = taps.array.size
    if x.dim() != 4 or k > 8:
        raise ValueError("downsample2x takes an NCHW tensor and at most 8 taps")
    n, c, h, w = x.shape
    y = x.new_empty((n, c) + _down2_hw(h, w, k, p0, p1))
    _build.launch(_build.library("upfirdn2d").fm_downsample2x, x, x.data_ptr(), y.data_ptr(),
                  down2_params(taps, p0, p1)[1], code, n * c, h, w)
    downsample2x.launches += 1
    return y


def _down2_hw(h: int, w: int, k: int, p0: int, p1: int):
    if h + p0 + p1 - k < 0 or w + p0 + p1 - k < 0:
        raise ValueError(f"downsample2x output would be empty: {(h, w)}, k={k}, pad={(p0, p1)}")
    return (h + p0 + p1 - k) // 2 + 1, (w + p0 + p1 - k) // 2 + 1


def _records_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def _blur(x, taps, p0, p1):
    if _records_grad(x):
        return _BlurFn.apply(x, taps, p0, p1)
    return _launch_blur(x, taps, p0, p1)


def _up2(x, taps, p0, p1):
    if _records_grad(x):
        return _Upsample2xFn.apply(x, taps, p0, p1)
    return _launch_up2(x, taps, p0, p1)


def _down2(x, taps, p0, p1):
    if _records_grad(x):
        return _Downsample2xFn.apply(x, taps, p0, p1)
    return _launch_down2(x, taps, p0, p1)


class _BlurFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps, p0, p1):
        ctx.taps, ctx.pads = taps, (p0, p1)
        return _launch_blur(x, taps, p0, p1)

    @staticmethod
    def backward(ctx, grad):
        taps = ctx.taps
        kh, kw = taps.array.shape
        if kh != kw:
            raise NotImplementedError("the blur adjoint takes square kernels (_blur_bwd)")
        p0, p1 = ctx.pads
        return _blur(grad.contiguous(), taps.flipped, kh - 1 - p0, kh - 1 - p1), None, None, None


class _Upsample2xFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps, p0, p1):
        ctx.taps, ctx.p0 = taps, p0
        return _launch_up2(x, taps, p0, p1)

    @staticmethod
    def backward(ctx, grad):
        taps, p0 = ctx.taps, ctx.p0
        # _resample_bwd with up=2, down=1, OH = 2H: g1 = p0 - 1.
        return _down2(grad.contiguous(), taps.flipped, taps.array.size - p0 - 1, p0 - 1), None, None, None


class _Downsample2xFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps, p0, p1):
        ctx.taps, ctx.p0, ctx.in_hw = taps, p0, tuple(x.shape[2:])
        return _launch_down2(x, taps, p0, p1)

    @staticmethod
    def backward(ctx, grad):
        taps, p0 = ctx.taps, ctx.p0
        (h, w), (oh, ow) = ctx.in_hw, tuple(grad.shape[2:])
        if h != 2 * oh or w != 2 * ow:
            raise NotImplementedError(
                f"the down2 adjoint is an exact 2x upsample only when H = 2*OH; got "
                f"{(h, w)} -> {(oh, ow)}"
            )
        # _resample_bwd with up=1, down=2: g0 = k-p0-1, g1 = H-2*OH+p0 = p0.
        return _up2(grad.contiguous(), taps.flipped, taps.array.size - p0 - 1, p0), None, None, None


def blur(x: torch.Tensor, kernel, pad, upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (up = down = 1), pads (p0, p1) on both axes.

    Replaces fm3dgan/ops/pallas/upfirdn2d_kernel.py ``_blur_pallas`` and its
    adjoint ``_blur_bwd``; on a CUDA tensor it launches ``fm_blur`` (any C,
    kernel <= 8x8, 0 <= p < min(kh, kw))."""
    if upsample_factor > 1:
        kernel = np.asarray(kernel, np.float32) * (upsample_factor**2)
    return _blur(x, _build.host_taps(kernel), int(pad[0]), int(pad[1]))


def upsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """Separable 2x upsample, pads (p0, p1) with p0 + p1 = k - 1.

    Replaces ``_updown_pallas`` mode up2 (and the XLA ``_up2_polyphase_k4``
    at the ToRGB skip); on a CUDA tensor it launches ``fm_upsample2x``
    (any C, k <= 8).  Its backward is :func:`downsample2x`."""
    taps = _build.host_taps(kernel_1d)
    k = taps.array
    p0, p1 = int(pad[0]), int(pad[1])
    if k.ndim != 1 or p0 + p1 != k.size - 1 or p0 < 0 or p1 < 0:
        raise ValueError(
            f"upsample2x takes 1-D taps and pads p0 + p1 = k - 1, got k={k.shape}, "
            f"pad={(p0, p1)}"
        )
    return _up2(x, taps, p0, p1)


def downsample2x(x: torch.Tensor, kernel_1d, pad) -> torch.Tensor:
    """Separable FIR with stride-2 decimation, pads (p0, p1) on both axes,
    output ((H + p0 + p1 - k)//2 + 1, (W + p0 + p1 - k)//2 + 1).

    Replaces ``_updown_pallas`` mode down2, the counterpart of
    ``resample2x_pallas(x, k, k, 1, 2, p0, p1)``; on a CUDA tensor it launches
    ``fm_downsample2x`` (any C, k <= 8).  Its backward is :func:`upsample2x`."""
    taps = _build.host_taps(kernel_1d)
    k = taps.array
    if k.ndim != 1:
        raise ValueError(f"downsample2x takes 1-D taps, got {k.shape}")
    p0, p1 = int(pad[0]), int(pad[1])
    _down2_hw(x.shape[2], x.shape[3], k.size, p0, p1)
    return _down2(x, taps, p0, p1)


blur.launches = 0
upsample2x.launches = 0
downsample2x.launches = 0
