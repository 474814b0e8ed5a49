"""Fused bias + LeakyReLU + scale, NCHW, and its gradient.

    y  = scale * leaky_relu(x + bias)            # bias over dim 1 (channels)
    dx = g * (scale if y >= 0 else slope * scale)
    dbias = sum(dx) over every dim but 1

Counterpart of ``fm3dgan/ops/fused_act.py`` and of the custom VJP in
``fm3dgan/ops/pallas/fused_act_kernel.py``.  :func:`fused_leaky_relu_plain`
and :func:`fused_leaky_relu_bwd_plain` are plain PyTorch.
:func:`fused_leaky_relu` and :func:`fused_leaky_relu_bwd` wrap the CUDA
kernels in ``csrc/fused_act.cu`` in ``torch.autograd.Function``s, twice
differentiable as the reference's ``op/fused_act.py:29-66``: the forward saves
only its output; its backward is the backward Function, which runs the
backward kernel and sums ``dbias``; the backward of that is the backward
kernel again on ``ggx + ggb``.  Every launch goes through the operators
``torch.ops.fm3dgan_torch.fused_leaky_relu`` and ``fused_leaky_relu_bwd``
(``_build.define_op``), whose CPU kernels (and, under ``plain_versions()``,
CUDA kernels) are the plain versions and whose CUDA kernels launch K1 / K2
(``csrc/ops.cpp``), so the CPU runs the same autograd wiring as the card and
``torch.export`` records the operators.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fm3dgan_torch.ops import _build
from fm3dgan_torch.precision import acc, acc_dtype


def fused_leaky_relu_plain(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """In float32 (float64 for float64); the bias is first cast to x's dtype,
    as the JAX op adds it."""
    y = acc(x)
    if bias is not None:
        y = y + bias.to(x.dtype).to(y.dtype).reshape(1, -1, *([1] * (x.dim() - 2)))
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_bwd_plain(
    grad: torch.Tensor,
    out: torch.Tensor,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """dx from the saved output's sign, in float32 (float64 for float64;
    ``_bwd_kernel``)."""
    g = acc(grad)
    return torch.where(out >= 0, g * scale, g * (negative_slope * scale)).to(grad.dtype)


_fwd_op = _build.define_op(
    "fused_leaky_relu(Tensor x, Tensor? bias, float negative_slope, float scale) -> Tensor",
    fused_leaky_relu_plain, lambda x, bias, negative_slope, scale: torch.empty_like(x))
_bwd_op = _build.define_op(
    "fused_leaky_relu_bwd(Tensor grad, Tensor out, float negative_slope, float scale) -> Tensor",
    fused_leaky_relu_bwd_plain, lambda grad, out, negative_slope, scale: torch.empty_like(grad))


def _channel_sum(dx: torch.Tensor) -> torch.Tensor:
    """dbias: the sum over every dim but 1, accumulated in float32."""
    dims = [0] + list(range(2, dx.dim()))
    return dx.sum(dim=dims, dtype=acc_dtype(dx.dtype)).to(dx.dtype)


class _FusedLeakyReLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = _fwd_op(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        ctx.with_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        if ctx.with_bias:
            dx, dbias = _FusedLeakyReLUBackwardFn.apply(grad, out, *ctx.consts, True)
            return dx, dbias, None, None
        return _FusedLeakyReLUBackwardFn.apply(grad, out, *ctx.consts, False), None, None, None


class _FusedLeakyReLUBackwardFn(torch.autograd.Function):
    """(grad, out) -> dx [, dbias].  Linear in grad with a gain that is
    constant almost everywhere in out, so its own backward is the same map on
    the incoming gradients and ``out`` gets none."""

    @staticmethod
    def forward(ctx, grad, out, negative_slope, scale, with_dbias):
        dx = _bwd_op(grad.contiguous(), out, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        if with_dbias:
            return dx, _channel_sum(dx)
        return dx

    @staticmethod
    def backward(ctx, ggx, ggb=None):
        (out,) = ctx.saved_tensors
        gg = ggx
        if ggb is not None:
            gg = gg + ggb.reshape(1, -1, *([1] * (out.dim() - 2)))
        dgrad = None
        if ctx.needs_input_grad[0]:
            dgrad = _FusedLeakyReLUBackwardFn.apply(gg, out, *ctx.consts, False)
        return dgrad, None, None, None, None


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Replaces fm3dgan/ops/pallas/fused_act_kernel.py ``_call_fwd``; on a CUDA
    tensor it launches ``fm_fused_leaky_relu`` on [N, C, ...] input.  The bias
    is cast to x's dtype outside the Function, so its gradient flows back
    through the cast."""
    if bias is not None:
        bias = bias.to(x.dtype)
    return _FusedLeakyReLUFn.apply(x, bias, float(negative_slope), float(scale))


def fused_leaky_relu_bwd(
    grad: torch.Tensor,
    out: torch.Tensor,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Replaces ``_call_bwd``: dx from the upstream gradient and the saved
    output; on a CUDA tensor it launches ``fm_fused_leaky_relu_bwd``."""
    return _FusedLeakyReLUBackwardFn.apply(grad, out, float(negative_slope), float(scale), False)

