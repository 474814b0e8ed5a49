"""A traced window and its reduction to device busy time, categories and
the port's kernel launches.

``traced(build_dir)`` runs ``torch.profiler`` (host and device, with
shapes) around a block marked ``bench_window``, writes the Chrome trace
into ``build_dir``, reads it back and deletes it.  The reduction then works
on the trace's events alone:

- busy time is the union of the device intervals (kernels, copies, sets)
  inside the window: copies on a side stream overlap compute, so a sum of
  event times could count a microsecond twice;
- a device event is joined to the host operator that launched it through
  its ``External id``, or through the runtime call that shares its
  ``correlation``, and gets a category from its name and that operator's:
  ``category``, ``CATEGORIES`` and ``KERNEL_NAMES`` are frozen copies of
  ``fm3dgan_torch/tools/analyze_trace.py``'s, and so is the join.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "bench_window"

# The ``__global__`` names of each hand-written kernel, keyed as
# ``fm3dgan_torch.ops.launch_counts()``.
KERNEL_NAMES = {
    "blur": ("blur_tile_kernel", "blur_2d_kernel"),
    "upsample2x": ("upsample2x_kernel",),
    "fused_leaky_relu": ("fused_lrelu_scalar", "fused_lrelu_vec"),
    "fused_leaky_relu_bwd": ("fused_lrelu_bwd_scalar", "fused_lrelu_bwd_vec"),
    "downsample2x": ("downsample2x_kernel",),
}
# Name substrings (lower case) of each category, the first match wins.
CATEGORIES = (
    ("port kernel", tuple(p.lower() for names in KERNEL_NAMES.values() for p in names)
     + ("fm3dgan_torch::",)),
    ("layout transpose", ("nchwtonhwc", "nhwctonchw")),
    ("copy", ("memcpy", "memset", "copy")),
    ("convolution", ("conv", "implicit_gemm", "wgrad", "dgrad", "fprop", "cudnn")),
    ("gemm", ("gemm", "gemv")),
)


def category(name: str, op: str = "") -> str:
    """The category of an event by its name, ``CATEGORIES``' first match;
    a gemm or an unnamed kernel that a convolution op launched (cuDNN's FFT
    and gemm-based algorithms) is a convolution."""
    low = name.lower()
    cat = next((c for c, patterns in CATEGORIES if any(p in low for p in patterns)), "other")
    if cat in ("gemm", "other") and "conv" in op.lower():
        return "convolution"
    return cat


class Trace:
    """The events of one traced window."""

    def __init__(self, events: List[dict]):
        marks = [ev for ev in events if ev.get("name") == WINDOW_MARK and ev.get("ph") == "X"]
        if not marks:
            raise ValueError(f"the trace has no {WINDOW_MARK!r} span")
        mark = max(marks, key=lambda ev: float(ev["dur"]))
        self.start_us = float(mark["ts"])
        self.end_us = self.start_us + float(mark["dur"])
        self.host_tid = (mark.get("pid"), mark.get("tid"))
        ops, runtime = {}, {}
        self.host_ops: List[dict] = []
        for ev in events:
            args = ev.get("args") or {}
            if ev.get("cat") == "cpu_op":
                self.host_ops.append(ev)
                if "External id" in args:
                    ops[args["External id"]] = ev
            elif ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                runtime[args["correlation"]] = args.get("External id")
        self.device: List[dict] = []
        for ev in events:
            if ev.get("cat") not in DEVICE_CATS or ev.get("ph") != "X":
                continue
            ts, dur = float(ev["ts"]), float(ev["dur"])
            if ts + dur <= self.start_us or ts >= self.end_us:
                continue
            args = ev.get("args") or {}
            ext = args.get("External id")
            if ext not in ops:
                ext = runtime.get(args.get("correlation"))
            op = ops.get(ext) or {}
            self.device.append(dict(name=ev["name"], cat=ev["cat"], ts=ts, dur=dur,
                                    op=op.get("name", ""), op_args=op.get("args") or {}))

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> np.ndarray:
        """The union of the device intervals inside the window, [k, 2] in µs."""
        if not self.device:
            return np.zeros((0, 2))
        iv = np.array([(max(e["ts"], self.start_us), min(e["ts"] + e["dur"], self.end_us))
                       for e in self.device])
        iv = iv[np.argsort(iv[:, 0])]
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.array(merged)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum() / 1e6) if len(iv) else 0.0

    def category_s(self, name: str) -> float:
        """Summed device seconds of the events of one category."""
        return sum(e["dur"] for e in self.device if category(e["name"], e["op"]) == name) / 1e6

    def kernels(self) -> List[dict]:
        """The device kernels (not copies or sets)."""
        return [e for e in self.device if e["cat"] == "kernel"]

    def port_launches(self) -> Iterator[Tuple[str, dict]]:
        """(operator, event) for each kernel launched by one of the port's
        ``fm3dgan_torch::`` operators."""
        for e in self.kernels():
            if e["op"].startswith("fm3dgan_torch::"):
                yield e["op"].split("::", 1)[1], e

    def top_device_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, float] = {}
        for e in self.device:
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[k[:160], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 200) -> List[list]:
        """Idle device time by what the host was doing: the ``longest`` gaps
        between busy intervals, each named by the innermost host operator
        running at its middle on the window's thread, summed by name."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.start_us], iv.ravel(), [self.end_us]]).reshape(-1, 2)
        gaps = [(s, e) for s, e in edges if e > s]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [ev for ev in self.host_ops if (ev.get("pid"), ev.get("tid")) == self.host_tid]
        ts = np.array([float(ev["ts"]) for ev in host]) if host else np.zeros(0)
        end = ts + np.array([float(ev["dur"]) for ev in host]) if host else np.zeros(0)
        totals: Dict[str, float] = {}
        for s, e in gaps[:longest]:
            mid = 0.5 * (s + e)
            inside = np.nonzero((ts <= mid) & (end >= mid))[0]
            name = (host[int(inside[np.argmin(end[inside] - ts[inside])])]["name"]
                    if len(inside) else "host outside any operator")
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        return [[k[:160], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def traced(build_dir: str, device: str = "cuda") -> Iterator[dict]:
    """Profile the block (host and, on a card, device, with shapes) inside a
    ``bench_window`` span that ends after a synchronize; on exit the yielded
    dict holds ``trace``, the reduced :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.device import sync

    out: dict = {}
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(WINDOW_MARK):
            yield out
            sync(device)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    out["trace"] = Trace(data["traceEvents"] if isinstance(data, dict) else data)
