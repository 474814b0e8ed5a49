"""Synchronize and memory readings that are no-ops off the card, so that
the drivers also run on the CPU in the benchmark's tests."""

from __future__ import annotations

import torch


def sync(device: str) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    return torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0


def free(device: str) -> None:
    import gc

    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
