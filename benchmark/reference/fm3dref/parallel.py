"""The data-parallel helpers the model code calls, for one process: the
reference runs without a process group (``fm3dgan_torch/parallel/dist.py``
with no group active)."""

from __future__ import annotations

from typing import Optional

import torch


def active() -> bool:
    return False


def world_size() -> int:
    return 1


def local_rows(n: int, r: Optional[int] = None, w: Optional[int] = None) -> slice:
    return slice(0, n)


def randn_rows(shape, generator: Optional[torch.Generator] = None, device=None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    return x


def average_gradients(grads):
    return grads
