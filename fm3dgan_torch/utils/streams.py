"""Independent sub-networks as parallel branches of a CUDA graph.

``fork(branches, trunk)`` calls each of ``branches`` (callables without
arguments), then ``trunk``, and returns ``(trunk's result, [each branch's
result])``.  While the current stream captures a CUDA graph, each branch
runs on a side stream of its own: the side stream first waits on the
capturing stream (the fork), the trunk runs on the capturing stream
meanwhile, and the capturing stream waits on every side stream before
``fork`` returns (the join).  The graph then holds each branch as a path of
its own beside the trunk, and its replay runs them concurrently on the card.
Otherwise ``fork`` makes the calls in order on the current stream: the same
launches as calling them one after another.  Whether a capture is under way
is the only condition; eager calls (training, batches above the graph limit,
the CPU) never branch.

Memory: a branch reads what its callable holds (its arguments, its module's
tensors) and allocates on its side stream.  ``fork`` holds the callables
until the join, so no block a branch reads returns to the capturing
stream's pool while the branch may still run.  A block a branch allocates
returns to its side stream's pool, and the next use of that side stream
starts with a fork, after everything the capturing stream ran before it,
readers of the branch's results included.

The side streams of a device are made at their first fork and kept; forks
nested in a branch or a trunk take streams that no fork under way holds.
``forked`` counts the branches forked so far;
``pipeline.STATS["branches"]`` counts those of the pipeline's captures.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# Branches forked onto side streams, in every capture so far.
forked = 0
# The side streams of each device, and how many of them the forks under way hold.
_SIDE: Dict[torch.device, List[Any]] = {}
_HELD: Dict[torch.device, int] = {}


def _capturing() -> bool:
    """Whether the current stream captures a CUDA graph (never under a
    compiler's or an exporter's trace, nor before CUDA is initialised)."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return False
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def fork(branches: Sequence[Callable[[], Any]],
         trunk: Optional[Callable[[], Any]] = None) -> Tuple[Any, List[Any]]:
    """(``trunk()`` or None, [``b()`` for b in ``branches``]), the branches
    called first; while capturing, each branch on a side stream forked from
    the current stream and joined back into it before the return."""
    if not branches or not _capturing():
        results = [b() for b in branches]
        return (None if trunk is None else trunk()), results
    global forked
    current = torch.cuda.current_stream()
    device = current.device
    first = _HELD.get(device, 0)
    pool = _SIDE.setdefault(device, [])
    while len(pool) < first + len(branches):
        pool.append(torch.cuda.Stream(device))
    sides = pool[first:first + len(branches)]
    _HELD[device] = first + len(branches)
    results, started = [], []
    try:
        for branch, side in zip(branches, sides):
            side.wait_stream(current)
            started.append(side)
            forked += 1
            with torch.cuda.stream(side):
                results.append(branch())
        out = None if trunk is None else trunk()
    finally:
        # Only forked streams are joined: a capture cannot wait on work outside it.
        for side in started:
            current.wait_stream(side)
        _HELD[device] = first
    return out, results
