"""Data parallelism over ``torch.distributed``: the port's counterpart of
``fm3dgan/parallel/mesh.py``.

The JAX mesh runs the single-device program on the global batch (GSPMD), so
its data parallelism computes what one device computes on the whole batch.
The port keeps that meaning with one process per device, each holding the
contiguous rows ``[r * N / W, (r + 1) * N / W)`` of a global batch of N rows
over W processes (``local_rows``), and the replicated parameters:

* what couples the rows of a batch runs on the global batch: train-mode
  BatchNorm combines the ranks' per-channel statistics and
  ``minibatch_stddev`` groups the gathered batch (both ``gather_stats``), the
  PPL running mean is the global mean (``all_reduce_sum``);
* what is drawn at the batch's shape is drawn at the global shape from the
  same generator on every rank, which keeps its own rows (``randn_rows``);
* each optimizer step averages the gradients of the ranks' local mean losses
  (``average_gradients``: one flattened all-reduce), which is the gradient of
  the global mean loss, and the logged metrics are averaged
  (``mean_metrics``).

``all_reduce_sum`` and ``all_gather_rows`` are ``autograd.Function``s whose
backwards are built from the same Functions, so the double backwards of R1
and PPL differentiate through them: the adjoint of a sum over ranks is a
sum over ranks, that of a gather the sum over ranks of the gathered gradient,
of which each rank keeps its own rows.  Only ``all_reduce``, ``all_gather``,
``broadcast`` and ``barrier`` are used, which gloo and NCCL run alike.

The loop's host flags (``any_rank``, ``broadcast_flag``) go over a gloo
group of the same ranks, so that reading them back does not wait for the
card.  Every collective runs whenever a process group exists, a world of one
included; with no group nothing is communicated and single-process code is
unchanged.  ``local()`` suspends the collectives, process-wide, for work
that one rank does alone (evaluation and sample grids on rank 0).
"""

from __future__ import annotations

import datetime
import os
from contextlib import contextmanager
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from fm3dgan_torch.utils.spans import span

# Collectives run and the bytes they carried, by kind (read by chip_smoke.py).
STATS: Dict[str, Dict[str, int]] = {}
_local_depth = 0
# A gloo group over the same ranks for the loop's host flags (preemption,
# divergence, checksums): exchanging them over NCCL would wait for the card
# to finish the iteration before the host loads the next batch.
_host_group = None


def _count(kind: str, t: torch.Tensor) -> None:
    s = STATS.setdefault(kind, {"calls": 0, "bytes": 0})
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, device: str = "cuda",
                     timeout: Optional[datetime.timedelta] = None
                     ) -> Tuple[Tuple[int, int], torch.device]:
    """Join the job's process group; returns ``((rank, world_size), device)``.

    With ``coordinator_address`` (``host:port``) the group meets at
    ``tcp://coordinator_address`` with ``num_processes`` and ``process_id``;
    without it, at torchrun's ``MASTER_ADDR``/``MASTER_PORT`` with its
    ``RANK`` and ``WORLD_SIZE``.  The rank's device is ``cuda:LOCAL_RANK``
    (or the process's index among this host's cards) for ``device="cuda"``,
    which takes NCCL, and the CPU for ``device="cpu"``, which takes gloo.
    ``backend`` overrides that choice (the tests and the chip smoke test run
    gloo over CUDA tensors).  There is no fallback: a CUDA device without a
    card, or a group that cannot form, raises."""
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"data parallelism needs torchrun's {missing} in the environment, "
                               "or --coordinator_address, --num_processes and --process_id")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("data parallelism on cuda needs a card; pass --device cpu for gloo")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"timeout": timeout} if timeout is not None else {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)
    global _host_group
    _host_group = dist.new_group(backend="gloo", timeout=timeout)
    return (rank, world), dev


def shutdown(wait: bool = True) -> None:
    """Leave the process group, after a last barrier with ``wait`` (not
    after a failure, which the other ranks may never reach)."""
    global _host_group
    if dist.is_available() and dist.is_initialized():
        if wait:
            dist.barrier()
        dist.destroy_process_group()
    _host_group = None


def active() -> bool:
    """Whether collectives run: a process group exists and no ``local()``."""
    return _local_depth == 0 and dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0 of a group, or a process without one: the one that writes."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


@contextmanager
def local():
    """Suspend the collectives (process-wide, so autograd's backward thread
    sees it too) for work that this rank does alone."""
    global _local_depth
    _local_depth += 1
    try:
        yield
    finally:
        _local_depth -= 1


def local_rows(n: int, r: Optional[int] = None, w: Optional[int] = None) -> slice:
    """Rank ``r``'s contiguous rows of a global batch of ``n`` rows over
    ``w`` ranks (default: this rank of the group).  Raises when ``n`` does
    not divide, as the JAX ``device_put`` of a batch over a mesh does."""
    r = rank() if r is None else r
    w = world_size() if w is None else w
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not divide over {w} ranks")
    k = n // w
    return slice(r * k, (r + 1) * k)


def randn_rows(shape, generator: Optional[torch.Generator] = None, device=None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.randn(shape)`` for a local batch of ``shape[0]`` rows: the
    rank's rows of the draw at the global shape, so that the ranks' rows
    together are one process's draw of the global batch."""
    n, w = shape[0], world_size()
    full = torch.randn((n * w, *shape[1:]), generator=generator, device=device, dtype=dtype)
    return full[local_rows(n * w)]


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    _count("all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.detach().clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        _count("all_gather", x)
        dist.all_gather(parts, x)
        ctx.rows = local_rows(x.shape[0] * len(parts))
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)[ctx.rows]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (to any order)."""
    return _AllReduceSum.apply(x) if active() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` stacked on dim 0 in rank order: the global batch of
    local rows, differentiable (to any order)."""
    return _AllGatherRows.apply(x) if active() else x


def gather_stats(x: torch.Tensor) -> torch.Tensor:
    """``all_gather_rows`` of the statistics that make a layer's output the
    global batch's (the BatchNorm's moments, the minibatch stddev's rows),
    inside the span ``fm3d.parallel.stats``."""
    if not active():
        return x
    with span("fm3d.parallel.stats"):
        return _AllGatherRows.apply(x)


def average_gradients(grads: Dict[str, Dict[str, torch.Tensor]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{partition: {name: grad}}`` averaged over the ranks: one flattened
    all-reduce (the gradients share one dtype), divided by W."""
    if not active():
        return grads
    with span("fm3d.parallel.grads"):
        flat = [g for part in grads.values() for g in part.values()]
        buf = _all_reduce(torch.cat([g.detach().reshape(-1) for g in flat])).div_(world_size())
        views = iter(torch.split(buf, [g.numel() for g in flat]))
        return {k: {n: next(views).view_as(g) for n, g in part.items()}
                for k, part in grads.items()}


def mean_metrics(metrics: Dict) -> Dict:
    """The scalar floating tensors of ``metrics`` averaged over the ranks
    (one all-reduce); other values pass through."""
    if not active():
        return metrics
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0 and v.is_floating_point()]
    if not keys:
        return metrics
    dtype = torch.float64 if any(metrics[k].dtype == torch.float64 for k in keys) else torch.float32
    buf = _all_reduce(torch.stack([metrics[k].detach().to(dtype) for k in keys]))
    buf.div_(world_size())
    return {**metrics, **{k: v for k, v in zip(keys, buf.unbind())}}


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on any rank (every rank gets the answer),
    exchanged over the host group: it waits for the other ranks' hosts, not
    for the card."""
    if not active():
        return flag
    return bool(_all_reduce(torch.tensor([int(flag)]), dist.ReduceOp.MAX, _host_group).item())


def broadcast_flag(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank, over the host group."""
    if not active():
        return flag
    t = torch.tensor([int(flag)])
    _count("broadcast", t)
    dist.broadcast(t, 0, group=_host_group)
    return bool(t.item())


def barrier() -> None:
    if active():
        STATS.setdefault("barrier", {"calls": 0, "bytes": 0})["calls"] += 1
        dist.barrier()


def check_replicas_equal(tensors: Iterable[torch.Tensor], what: str = "parameters") -> None:
    """Raise unless ``tensors`` hold the same values on every rank: one
    all-reduce (max) of a float64 checksum and its negation."""
    if not active():
        return
    s = torch.zeros(2, dtype=torch.float64)
    for t in tensors:
        t = t.detach().double()
        s += torch.stack([t.sum(), t.square().sum()]).cpu()
    both = _all_reduce(torch.cat([s, -s]), dist.ReduceOp.MAX, _host_group)
    if not torch.equal(both[:2], -both[2:]):
        raise RuntimeError(f"the {what} differ between the ranks (checksums "
                           f"{both[:2].tolist()} vs {(-both[2:]).tolist()}); every rank must "
                           "start from the same seed or checkpoint")
