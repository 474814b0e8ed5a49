"""The edit forwards' transfers between the host and the card, through
pinned staging buffers owned by the bundle.

``forward_3_encoder`` and ``forward_2_encoder`` return their image on the
device their inputs came from.  A call with both inputs on the host and its
bundle on a card (outside ``torch.compile`` and ``torch.export``) goes
through the bundle's :class:`Staging`:

* copy in: each input is copied into a pinned buffer and sent to the card
  with ``non_blocking``; an input that is already pinned is sent as it is.  An
  event after the sends tells the next call when the buffer is free;
* copy out: the image (and the latent) comes back in chunks of
  ``CHUNK_BYTES`` through two pinned buffers.  The first two chunks are
  issued right behind the forward, and while the card still runs it the
  host allocates the results and faults their pages in with a parallel
  write.  Then each chunk is waited for and copied into its slice of the
  result, and its buffer takes the chunk after next.  A replayed graph's
  outputs are copied straight from its static outputs;
* the results are ordinary host tensors: contiguous, not pinned, outside
  inference mode, and aliasing no buffer;
* the host's copies and its fault-in run on torch's intra-op threads from
  ``PARALLEL_BYTES`` up, and below it on the calling thread.

The pageable copies this replaces were staged by CUDA through a buffer of
its own, and the new pages filled by one host thread, a page fault at each
first touch.  Pinned memory stays bounded whatever the batch: two chunk
buffers and one copy of the largest inputs seen.  A lock makes threads that
share a bundle take turns.  ``STATS["staged"]`` counts the staged calls and
``STATS["staged_bytes"]`` the bytes they moved both ways.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fm3dgan_torch.pipeline.graphs import STATS
from fm3dgan_torch.utils.spans import span

# Bytes of one chunk of the copy out (an H100's sweep over 8, 16 and 32 MiB
# at 1024 px, batch 16: PERF.md).
CHUNK_BYTES = 16 << 20
# Host copies and fills of fewer bytes run on the calling thread: on a small
# one a parallel region saves less than a late worker can cost (PERF.md).
PARALLEL_BYTES = 1 << 20
# Offset of each input in the pinned input buffer: a multiple of every
# element size.
_ALIGN = 64


def engaged(models, photo: torch.Tensor, render: torch.Tensor) -> bool:
    """Whether a call of ``models`` on ``photo`` and ``render`` is staged:
    both inputs on the host, the bundle on a card, and no tracer running."""
    if models.device.type != "cuda" or photo.device.type != "cpu" or render.device.type != "cpu":
        return False
    return not (torch.compiler.is_compiling() or torch.compiler.is_exporting())


def chunks(nbytes: int, size: int) -> List[Tuple[int, int]]:
    """The [lo, hi) byte ranges, each at most ``size`` long, that cover
    ``nbytes`` in order."""
    return [(lo, min(lo + size, nbytes)) for lo in range(0, nbytes, size)]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _host_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:] = src`` for flat host byte tensors of one length."""
    if dst.numel() >= PARALLEL_BYTES:
        dst.copy_(src)
    else:
        np.copyto(dst.numpy(), src.numpy())


def _host_zero(dst: torch.Tensor) -> None:
    """Zero a flat host byte tensor, touching each of its pages."""
    if dst.numel() >= PARALLEL_BYTES:
        dst.zero_()
    else:
        dst.numpy().fill(0)


def copy_chunked(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor],
                 buffers: Sequence[torch.Tensor], size: int, record: Callable[[], object],
                 before: Callable[[], None]) -> None:
    """Copy each flat byte tensor of ``srcs`` into the one of ``dsts`` at its
    place, in chunks of at most ``size`` bytes through the two ``buffers``.

    Chunks 0 and 1 are sent first, each followed by ``record()``, whose
    result (an event, or None) is waited on with ``synchronize()`` before the
    chunk is read; ``before()`` runs while they travel.  Chunk i is then
    copied out of buffer i % 2, and chunk i + 2 sent into it."""
    plan = [(src, dst, lo, hi) for src, dst in zip(srcs, dsts) for lo, hi in chunks(src.numel(), size)]
    sent = []

    def send(i):
        src, _, lo, hi = plan[i]
        buffers[i % 2][:hi - lo].copy_(src[lo:hi], non_blocking=True)
        sent.append(record())

    for i in range(min(2, len(plan))):
        send(i)
    before()
    for i, (_, dst, lo, hi) in enumerate(plan):
        if sent[i] is not None:
            sent[i].synchronize()
        _host_copy(dst[lo:hi], buffers[i % 2][:hi - lo])
        if i + 2 < len(plan):
            send(i + 2)


def _pinned(nbytes: int) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class Staging:
    """A bundle's pinned buffers for its edits' host transfers: one for the
    inputs, two for the chunks of the copy out."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inputs: Optional[torch.Tensor] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        # Recorded after the last sends from ``inputs``.
        self.sent: Optional[torch.cuda.Event] = None

    # A copy of the bundle starts with buffers of its own.
    def __deepcopy__(self, memo) -> "Staging":
        return Staging()

    @property
    def pinned_bytes(self) -> int:
        """Bytes requested for the pinned buffers held now."""
        held = [*([] if self.inputs is None else [self.inputs]), *self.outputs]
        return sum(b.numel() for b in held)

    def to_device(self, device: torch.device, photo: torch.Tensor,
                  render: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``photo`` and ``render`` from the host on ``device``, sent from
        pinned memory without blocking; counts the call as staged."""
        with span("fm3d.edit.to_device"):
            offsets, total = [], 0
            for x in (photo, render):
                pinned = x.is_pinned()
                offsets.append(None if pinned else total)
                total += 0 if pinned else -(-x.nbytes // _ALIGN) * _ALIGN
            if self.sent is not None:
                self.sent.synchronize()
            if total and (self.inputs is None or self.inputs.numel() < total):
                self.inputs = _pinned(total)
            out = []
            for x, at in zip((photo, render), offsets):
                if at is not None:
                    buf = self.inputs[at:at + x.nbytes]
                    _host_copy(buf, _bytes(x.contiguous()))
                    x = buf.view(x.dtype).view(x.shape)
                out.append(x.to(device, non_blocking=True))
            self.sent = torch.cuda.Event()
            self.sent.record(torch.cuda.current_stream(device))
            STATS["staged"] += 1
            STATS["staged_bytes"] += photo.nbytes + render.nbytes
            return out[0], out[1]

    def to_host(self, image: torch.Tensor,
                latent: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Host copies of the card's ``image`` and ``latent`` (None stays
        None), through the chunk buffers."""
        with span("fm3d.edit.to_host"):
            present = [t.contiguous() for t in (image, latent) if t is not None]
            with torch.inference_mode(False):
                outs = [torch.empty(t.shape, dtype=t.dtype) for t in present]
            srcs, dsts = [_bytes(t) for t in present], [_bytes(o) for o in outs]
            size = min(CHUNK_BYTES, max(s.numel() for s in srcs))
            if size and (not self.outputs or self.outputs[0].numel() < size):
                self.outputs = (_pinned(size), _pinned(size))
            stream = torch.cuda.current_stream(image.device)

            def record():
                event = torch.cuda.Event()
                event.record(stream)
                return event

            def fault_in():
                for d in dsts:
                    _host_zero(d)

            copy_chunked(srcs, dsts, self.outputs, CHUNK_BYTES, record, fault_in)
            STATS["staged_bytes"] += sum(s.numel() for s in srcs)
            return outs[0], (outs[1] if latent is not None else None)
