"""Frozen copy of ``fm3dgan_torch/precision.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

The precision plain PyTorch code accumulates in.

The JAX modules normalise, reduce and take their losses in float32 whatever
the compute dtype (float32 or bfloat16); so does the port.  A float64 tensor
stays float64, so that a float64 run of the plain path has no float32 step:
the chip smoke test takes such a run as the exact reference its float32
gradients are measured against.  The CUDA kernels take float32 and bfloat16
only.
"""

from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 for float64, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 when it is float64."""
    return x.to(acc_dtype(x.dtype))
