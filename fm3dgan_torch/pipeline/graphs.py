"""CUDA graphs of the 3-encoder edit forward, one per input signature.

At batch 1 the host takes longer to issue ``forward_3_encoder``'s ~850
operators than the card takes to run them.  :class:`EditGraphs`, held on a
``FaceManipulator`` as ``graphs``, captures the batch forward, from the
NHWC inputs on the device to the NHWC image and the latent, and replays it:

* the first call with a signature runs eagerly (it chooses cuDNN's plans
  and fills the allocator); the second warms up on a side stream, captures
  into a private memory pool and replays; later calls replay;
* the capture holds the forward's independent sub-networks as parallel
  branches (``utils/streams.py``): E_Tsr and E_W beside E_W+, and each of
  pSp's style blocks beside the rest of pSp, all joined before G; the same
  kernels as the eager forward, which runs them one after another;
* a replay copies the caller's photo and render into the graph's static
  inputs, replays, and returns clones of the static outputs, so the next
  request never overwrites a caller's tensor;
* a graph is valid while every parameter and buffer of the bundle sits at
  the address it had at capture.  A move (``.to()``,
  ``load_state_dict(assign=True)``, ``torch.func.functional_call``) drops
  the bundle's graphs and its sightings; an update in place
  (``load_variables``, an optimizer's step) keeps the addresses, and a
  replay reads the new values;
* at most ``MAX_GRAPHS`` graphs are kept, the least recently used dropped
  first; a lock makes threads that share a bundle take turns;
* only batches of at most ``MAX_BATCH`` pairs are graphed.  Up to there the
  host takes as long to issue the eager forward as the card takes to run it
  (an H100 at full width: 29.7 against 21.4 ms at batch 1, 35.7 against
  35.5 at batch 4); above it the card sets the pace, a replay saves 4-7%,
  and an eager call keeps each kernel joined to its launching operator in a
  profiler's trace.

A call that cannot replay runs eagerly and is counted in ``STATS["eager"]``
by reason: the bundle's device type when it is not ``cuda`` (``cpu``),
``noise`` (a ``noise_generator``), ``compile`` (under ``torch.compile`` or
``torch.export``), ``capturing`` (a capture is underway on the stream),
``grad`` (an input requires grad), ``plain`` (inside
``ops.plain_versions()``), ``batch`` (more than ``MAX_BATCH`` pairs),
``train`` (a module in training mode), ``first`` (the first sighting of a
signature).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from fm3dgan_torch.ops import plain_active
from fm3dgan_torch.utils import streams
from fm3dgan_torch.utils.spans import span

MAX_GRAPHS = 4
MAX_BATCH = 4
# Calls on a side stream before a capture, as torch's CUDA-graph notes ask:
# they set up what lazy initialisation the capture stream would otherwise do.
WARMUP_CALLS = 2

# Calls by route, and the side branches forked while capturing (16 a
# 3-encoder signature), read by the tests and chip_smoke.py.
STATS: Dict[str, Any] = {"eager": {}, "captures": 0, "replays": 0, "invalidations": 0,
                         "branches": 0}

Region = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def count_eager(reason: str) -> None:
    STATS["eager"][reason] = STATS["eager"].get(reason, 0) + 1


def eager_reason(models, photo: torch.Tensor, render: torch.Tensor,
                 noise_generator: Optional[torch.Generator]) -> Optional[str]:
    """Why this call cannot replay a graph, or None (training mode is
    :meth:`EditGraphs.run`'s to judge, with the modules at hand)."""
    kind = models.device.type
    if kind != "cuda":
        return kind
    if noise_generator is not None:
        return "noise"
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return "compile"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    if photo.requires_grad or render.requires_grad:
        return "grad"
    if plain_active():
        return "plain"
    if max(photo.shape[0], render.shape[0]) > MAX_BATCH:
        return "batch"
    return None


def signature(photo: torch.Tensor, render: torch.Tensor, tsr_encode: str,
              sliced_layer: Optional[Sequence[int]], use_tanh: bool,
              return_latent: bool) -> Tuple:
    """A graph's key: each input's shape and dtype, the forward's options,
    and the backend flags that choose the convolutions' and matmuls'
    kernels, which a replay would otherwise keep.  (The kernels' plain
    versions are never graphed: :func:`eager_reason`.)"""
    return (tuple(photo.shape), photo.dtype, tuple(render.shape), render.dtype, tsr_encode,
            None if sliced_layer is None else tuple(sliced_layer), use_tanh, return_latent,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)


class Layout:
    """Where a bundle's tensors live: its submodules, the slot of each
    parameter and buffer, and each child.  The bundle itself is left out, so
    that a layout held on the bundle makes no reference cycle."""

    def __init__(self, models: torch.nn.Module):
        self.root = models._modules
        self.modules = list(models.modules())[1:]
        self.slots = [(d, k) for m in [models, *self.modules]
                      for d in (m._parameters, m._buffers) for k, t in d.items() if t is not None]
        self.children = [(m._modules, k, c) for m in [models, *self.modules]
                         for k, c in m._modules.items()]

    def current(self, models: torch.nn.Module) -> bool:
        """Whether no submodule was replaced since."""
        return models._modules is self.root and all(d.get(k) is c for d, k, c in self.children)

    def training(self) -> bool:
        return any(m.training for m in self.modules)

    def addresses(self) -> Tuple[int, ...]:
        """The fingerprint: every parameter's and buffer's ``data_ptr``."""
        return tuple(0 if (t := d.get(k)) is None else t.data_ptr() for d, k in self.slots)


class Graph:
    """One captured forward: its static inputs and outputs, and an event
    after its last replay's clones."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.done = torch.cuda.Event()

    def replay(self, photo: torch.Tensor, render: torch.Tensor,
               return_latent: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        stream = torch.cuda.current_stream()
        # A replay from another stream waits until the last one's clones are made.
        stream.wait_event(self.done)
        self.inputs[0].copy_(photo)
        self.inputs[1].copy_(render)
        self.graph.replay()
        image, latent = self.outputs
        out = (image.clone(), latent.clone() if return_latent else None)
        self.done.record(stream)
        return out


def capture(device: torch.device, photo: torch.Tensor, render: torch.Tensor,
            region: Region) -> Graph:
    """Warm ``region`` up on a side stream, then capture it on static copies
    of ``photo`` and ``render`` into a private memory pool."""
    inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
                   for x in (photo, render))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            region(*inputs)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    forked = streams.forked
    with torch.cuda.graph(graph):
        outputs = region(*inputs)
    STATS["branches"] += streams.forked - forked
    return Graph(graph, inputs, outputs)


class EditGraphs:
    """The graphs of one bundle, by signature, with the signatures seen once."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs: "collections.OrderedDict[Tuple, Graph]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[Tuple, None]" = collections.OrderedDict()
        self.layout: Optional[Layout] = None
        self.addresses: Optional[Tuple[int, ...]] = None

    # A copy of the bundle (a training state's snapshot) starts with no
    # graphs: neither a lock nor a captured graph can be copied.
    def __deepcopy__(self, memo) -> "EditGraphs":
        return EditGraphs()

    def run(self, models: torch.nn.Module, photo: torch.Tensor, render: torch.Tensor,
            key: Tuple, return_latent: bool,
            region: Region) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """(image, latent or None) from the graph of ``key``, captured on
        this call if it is the signature's second; None where the call is to
        run eagerly (counted)."""
        with self.lock:
            if self.layout is None or not self.layout.current(models):
                self.layout = Layout(models)
            if models.training or self.layout.training():
                count_eager("train")
                return None
            addresses = self.layout.addresses()
            if addresses != self.addresses:
                if self.graphs:
                    STATS["invalidations"] += 1
                self.graphs.clear()
                self.seen.clear()
                self.addresses = addresses
            graph = self.graphs.get(key)
            if graph is None:
                if key not in self.seen:
                    self.seen[key] = None
                    if len(self.seen) > MAX_GRAPHS:
                        self.seen.popitem(last=False)
                    count_eager("first")
                    return None
                del self.seen[key]
                with span("fm3d.edit.capture"):
                    graph = capture(models.device, photo, render, region)
                STATS["captures"] += 1
                self.graphs[key] = graph
                if len(self.graphs) > MAX_GRAPHS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
            with span("fm3d.edit.replay"):
                out = graph.replay(photo, render, return_latent)
            STATS["replays"] += 1
            return out


def replayed(models, photo: torch.Tensor, render: torch.Tensor, region: Region, *,
             noise_generator: Optional[torch.Generator], tsr_encode: str,
             sliced_layer: Optional[Sequence[int]], use_tanh: bool,
             return_latent: bool) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """``region(photo, render)``'s (image, latent or None) from a replay, or
    None where the call is to run ``region`` eagerly (counted by reason)."""
    reason = eager_reason(models, photo, render, noise_generator)
    if reason is not None:
        count_eager(reason)
        return None
    key = signature(photo, render, tsr_encode, sliced_layer, use_tanh, return_latent)
    return models.graphs.run(models, photo, render, key, return_latent, region)
