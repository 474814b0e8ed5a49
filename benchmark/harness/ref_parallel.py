"""The frozen reference run as one rank of a process group.

``reference/fm3dref`` is one process's code: its ``parallel.py`` helpers
say that no group is active.  ``installed()`` puts plain
``torch.distributed`` collectives in their place for as long as it is
entered, and the reference ``Trainer`` subclass ``RankTrainer``, which
draws the schedule's PPL subset over the global batch, takes its rows from
the ranks' gathered batches and averages the iteration's metrics over the
ranks.  Each rank then computes what one process computes on the global
batch of every rank's rows: train-mode BatchNorm and the minibatch stddev
on the gathered batch, noise drawn at the global shape (each rank keeps its
rows), the PPL mean over every rank and each optimizer step on the
gradients averaged over the ranks.

Nothing here imports the program (``fm3dgan_torch``); the reference's
files stay as they are.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

from reference.fm3dref import parallel as ref_parallel
from reference.fm3dref import trainer as ref_trainer

HELPERS = ("active", "world_size", "local_rows", "randn_rows", "all_reduce_sum",
           "all_gather_rows", "average_gradients")


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size()


def local_rows(n: int, r: Optional[int] = None, w: Optional[int] = None) -> slice:
    """Rank ``r``'s contiguous rows of ``n`` rows over ``w`` ranks."""
    r = dist.get_rank() if r is None else r
    w = dist.get_world_size() if w is None else w
    if n % w:
        raise ValueError(f"{n} rows do not divide over {w} ranks")
    return slice(r * (n // w), (r + 1) * (n // w))


def randn_rows(shape, generator: Optional[torch.Generator] = None, device=None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's rows of one draw at the global shape."""
    n = shape[0] * world_size()
    full = torch.randn((n, *shape[1:]), generator=generator, device=device, dtype=dtype)
    return full[local_rows(n)]


class _Sum(torch.autograd.Function):
    """The sum over the ranks; its adjoint is the sum over the ranks."""

    @staticmethod
    def forward(ctx, x):
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g)


class _Gather(torch.autograd.Function):
    """The ranks' rows stacked in rank order; the adjoint keeps this rank's
    rows of the gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, x):
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x)
        ctx.rows = local_rows(x.shape[0] * len(parts))
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g)[ctx.rows]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _Sum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    return _Gather.apply(x)


def average_gradients(grads: Dict[str, Dict[str, torch.Tensor]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every gradient averaged over the ranks, in one all-reduce."""
    flat = [g for part in grads.values() for g in part.values()]
    buf = torch.cat([g.detach().reshape(-1) for g in flat])
    dist.all_reduce(buf)
    buf /= world_size()
    views = iter(torch.split(buf, [g.numel() for g in flat]))
    return {k: {n: next(views).view_as(g) for n, g in part.items()} for k, part in grads.items()}


def mean_metrics(metrics: Dict) -> Dict:
    """The scalar floating tensors of ``metrics`` averaged over the ranks."""
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0 and v.is_floating_point()]
    if not keys:
        return metrics
    buf = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(buf)
    buf /= world_size()
    return {**metrics, **dict(zip(keys, buf.unbind()))}


class RankTrainer(ref_trainer.Trainer):
    """The reference 3-encoder trainer on this rank's rows of the global batch."""

    def schedule(self, iter_idx: int, batch: int):
        return super().schedule(iter_idx, batch * world_size())

    def _ppl_rows(self, photo, render, idx):
        photo, render = all_gather_rows(photo), all_gather_rows(render)
        return super()._ppl_rows(photo, render, idx[local_rows(len(idx))])

    def _finish_metrics(self, metrics, s, **flags):
        return super()._finish_metrics(mean_metrics(metrics), s, **flags)


@contextlib.contextmanager
def installed() -> Iterator[None]:
    """The reference's helpers and ``Trainer`` replaced by this module's
    inside the block (a process group must exist), put back after."""
    saved = {name: getattr(ref_parallel, name) for name in HELPERS}
    saved_trainer = ref_trainer.Trainer
    for name in HELPERS:
        setattr(ref_parallel, name, globals()[name])
    ref_trainer.Trainer = RankTrainer
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ref_parallel, name, fn)
        ref_trainer.Trainer = saved_trainer
