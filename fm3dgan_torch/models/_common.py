"""Conv / BatchNorm / PReLU applied in a compute dtype with float32 parameters.

The encoders keep torch modules for their parameters and the reference's
state-dict names, and run them through these helpers so that ``dtype``
(float32 or bfloat16) follows the JAX modules' casts: inputs and weights in
``dtype``, BatchNorm in float32 (float64 for float64) with its result cast
back.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fm3dgan_torch.precision import acc


def conv(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(
        x.to(dtype),
        m.weight.to(dtype),
        None if m.bias is None else m.bias.to(dtype),
        m.stride,
        m.padding,
    )


FLAX_MOMENTUM = 0.9


def bn(m: nn.BatchNorm2d, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """BatchNorm from the running statistics, or with ``train`` from the
    batch statistics, updating the running ones in place."""
    xf = acc(x)
    weight, bias = m.weight.to(xf.dtype), m.bias.to(xf.dtype)
    if not train:
        y = F.batch_norm(xf, m.running_mean.to(xf.dtype), m.running_var.to(xf.dtype), weight, bias,
                         False, 0.0, m.eps)
        return y.to(x.dtype)
    y = F.batch_norm(xf, None, None, weight, bias, True, 0.0, m.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        m.running_mean.mul_(FLAX_MOMENTUM).add_(mean, alpha=1.0 - FLAX_MOMENTUM)
        m.running_var.mul_(FLAX_MOMENTUM).add_(var, alpha=1.0 - FLAX_MOMENTUM)
    return y.to(x.dtype)


def prelu(m: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    return F.prelu(x, m.weight.to(x.dtype))


def lecun_normal_(module: nn.Module) -> None:
    """flax's default initialisation of every Conv2d and Linear in
    ``module``: weights from a normal truncated at two standard deviations
    with variance 1/fan_in (flax's ``lecun_normal``), biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = fan_in ** -0.5 / 0.87962566103423978  # the truncated normal's std, corrected
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
