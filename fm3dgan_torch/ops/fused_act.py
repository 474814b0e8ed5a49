"""Fused bias + LeakyReLU + scale, NCHW.

    y = scale * leaky_relu(x + bias)      # bias over dim 1 (channels)

Counterpart of ``fm3dgan/ops/fused_act.py``.  :func:`fused_leaky_relu_plain`
is plain PyTorch; :func:`fused_leaky_relu` wraps the CUDA kernel in
``csrc/fused_act.cu``: the plain version on a CPU tensor, the kernel on a CUDA
tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fm3dgan_torch.ops import _build


def fused_leaky_relu_plain(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """In float32; the bias is first cast to x's dtype, as the JAX op adds it."""
    y = x.float()
    if bias is not None:
        y = y + bias.to(x.dtype).float().reshape(1, -1, *([1] * (x.dim() - 2)))
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Replaces fm3dgan/ops/pallas/fused_act_kernel.py ``_call_fwd``; on a CUDA
    tensor it launches ``fm_fused_leaky_relu`` on [N, C, ...] input."""
    if not _build.use_kernel(x):
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    _build.check_input(x, "fused_leaky_relu")
    if x.dim() < 2:
        raise ValueError("fused_leaky_relu takes [N, C, ...] input")
    c = x.shape[1]
    hw = x[0, 0].numel()
    b = None
    if bias is not None:
        if bias.shape != (c,) or bias.device != x.device:
            raise ValueError(f"bias must be [{c}] on {x.device}, got {tuple(bias.shape)}")
        _build.check_input(bias.contiguous(), "fused_leaky_relu bias")
        b = bias.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.library("fused_act").fm_fused_leaky_relu(
            x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            _build.dtype_code(x), x.numel(), c, hw,
            float(negative_slope), float(scale), _build.stream_of(x),
        )
    _build.check(err, "fm_fused_leaky_relu")
    fused_leaky_relu.launches += 1
    return y


fused_leaky_relu.launches = 0
