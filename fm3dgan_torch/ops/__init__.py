"""Ops of the port: plain PyTorch versions and the CUDA kernel wrappers."""

from typing import Dict

import torch

from fm3dgan_torch.ops import _build
from fm3dgan_torch.ops._build import build_all, plain_active, plain_versions
from fm3dgan_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_bwd,
    fused_leaky_relu_bwd_plain,
    fused_leaky_relu_plain,
)
from fm3dgan_torch.ops.upfirdn2d import (
    blur,
    blur_plain,
    downsample2d,
    downsample2x,
    downsample2x_plain,
    make_kernel,
    upfirdn2d,
    upsample2d,
    upsample2x,
    upsample2x_plain,
)

KERNEL_WRAPPERS = {
    "blur": blur,
    "upsample2x": upsample2x,
    "fused_leaky_relu": fused_leaky_relu,
    "fused_leaky_relu_bwd": fused_leaky_relu_bwd,
    "downsample2x": downsample2x,
}


def reset_launches() -> None:
    if _build.loaded():
        torch.ops.fm3dgan_torch.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Kernel launches since :func:`reset_launches`, counted by the CUDA
    kernels of the operators (``csrc/ops.cpp``); 0 where never loaded."""
    if not _build.loaded():
        return dict.fromkeys(KERNEL_WRAPPERS, 0)
    return dict(zip(KERNEL_WRAPPERS, torch.ops.fm3dgan_torch.launch_counts()))


__all__ = [
    "KERNEL_WRAPPERS",
    "blur",
    "blur_plain",
    "build_all",
    "downsample2d",
    "downsample2x",
    "downsample2x_plain",
    "fused_leaky_relu",
    "fused_leaky_relu_bwd",
    "fused_leaky_relu_bwd_plain",
    "fused_leaky_relu_plain",
    "launch_counts",
    "make_kernel",
    "plain_active",
    "plain_versions",
    "reset_launches",
    "upfirdn2d",
    "upsample2d",
    "upsample2x",
    "upsample2x_plain",
]
