"""Conv / BatchNorm / PReLU applied in a compute dtype with float32 parameters.

The encoders keep torch modules for their parameters and the reference's
state-dict names, and run them through these helpers so that ``dtype``
(float32 or bfloat16) follows the JAX modules' casts: inputs and weights in
``dtype``, BatchNorm in float32 with its result cast back.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(
        x.to(dtype),
        m.weight.to(dtype),
        None if m.bias is None else m.bias.to(dtype),
        m.stride,
        m.padding,
    )


def bn(m: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm from the running statistics."""
    y = F.batch_norm(
        x.float(), m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps
    )
    return y.to(x.dtype)


def prelu(m: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    return F.prelu(x, m.weight.to(x.dtype))
