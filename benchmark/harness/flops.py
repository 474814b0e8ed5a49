"""Model operations counted by the benchmark itself: the reference runs on
the ``meta`` device (shapes, no values) under a dispatch mode that adds up
``torch.utils.flop_counter``'s formulas for every matrix product and
convolution, forward and backward, first and second order.  What the
program launches is never counted, so a later change that fuses or removes
a kernel meets the same yardstick."""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry


def _shape(t):
    return t.shape if isinstance(t, torch.Tensor) else t


class CountFlops(TorchDispatchMode):
    """Adds up the floating-point operations of the aten calls it sees."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += int(formula(*tree_map(_shape, args), **tree_map(_shape, kwargs),
                                      out_val=tree_map(_shape, out)))
        return out


def count(fn: Callable[[], object]) -> int:
    """The operations of ``fn()``."""
    with CountFlops() as counter:
        fn()
    return counter.total
