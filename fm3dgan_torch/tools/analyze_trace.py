"""Chrome-trace analyzer: top ops by self time, with the launching op's
input shapes, the counterpart of ``tools/analyze_trace.py``.

Reads the newest ``torch.profiler`` trace (``*.json``, or ``*.json.gz``)
under ``trace_dir``, as ``fm3dgan_torch.tools.profile_train`` writes it, with
the standard library only.  ``--plane gpu`` (the default) takes the events
that ran on the device (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``),
``--plane cpu`` the host's ``cpu_op`` events by self time (a CPU-only trace
has only this plane).  A device event carries no shapes: it is joined to the
``cpu_op`` that launched it through its ``External id``, or through the
runtime call that shares its ``correlation``.

``--plane spans`` takes the port's ``fm3d.`` spans (``fm3dgan_torch/utils/
spans.py``): per span name its count, host ms, the device ms it launched
(a device event belongs to every span whose interval holds the start of
its launching op, whatever thread that op ran on, so a backward that
autograd's thread launches counts toward the step waiting for it) and its
Python-idle ms (an idle gap between the device's busy intervals, over the
extent of the trace's events, belongs to every span open at its middle when
no other ``cpu_op`` is open there on any thread).

    python -m fm3dgan_torch.tools.analyze_trace /tmp/fm3dgan_trace [--top 30] \\
        [--match blur] [--plane gpu|cpu|spans] [--json]

On stderr: the trace's path, the time and count by category (the port's
kernels, layout transposes, copies, convolutions, gemms, other; by each
event's name, and a gemm or other kernel that a convolution op launched is
a convolution), and the plane's count of ops and total event ms; on stdout
one line per op name, most time first: total ms, count, category and the
most frequent launching ops and input shapes (``--json``: the same as JSON
lines; for spans, one line per span name, most host time first).  Exits 1
when no event of the plane is in the trace, listing the categories it has.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

PLANES = {"gpu": ("kernel", "gpu_memcpy", "gpu_memset"), "cpu": ("cpu_op",)}
SPAN_PREFIX = "fm3d."
# The ``__global__`` names of each hand-written kernel (``fm3dgan_torch/ops/
# csrc``), keyed as ``fm3dgan_torch.ops.launch_counts()``; a trace prints them
# demangled with their template arguments, so they match as substrings.
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
SHAPES_KEPT = 3


def load_trace(trace_dir: str) -> Tuple[List[dict], str]:
    """The events of the newest trace file under ``trace_dir`` and its path."""
    paths = glob.glob(os.path.join(trace_dir, "*.json")) + glob.glob(
        os.path.join(trace_dir, "*.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        trace = json.load(f)
    return (trace["traceEvents"] if isinstance(trace, dict) else trace), path


def category(name: str, op: str = "") -> str:
    """The category of an event by its name, ``CATEGORIES``' first match;
    a gemm or an unnamed kernel that a convolution op launched (cuDNN's FFT
    and gemm-based algorithms) is a convolution."""
    low = name.lower()
    cat = next((c for c, patterns in CATEGORIES if any(p in low for p in patterns)), "other")
    if cat in ("gemm", "other") and "conv" in op.lower():
        return "convolution"
    return cat


def _self_times(events: List[dict]) -> List[float]:
    """Each event's duration less its direct children's, nesting by time
    within each (pid, tid)."""
    self_us = [float(ev["dur"]) for ev in events]
    threads: Dict[tuple, List[int]] = {}
    for i, ev in enumerate(events):
        threads.setdefault((ev.get("pid"), ev.get("tid")), []).append(i)
    for idx in threads.values():
        idx.sort(key=lambda i: (events[i]["ts"], -events[i]["dur"]))
        stack: List[Tuple[float, int]] = []  # (end, index) of the open events
        for i in idx:
            ts = events[i]["ts"]
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                self_us[stack[-1][1]] -= events[i]["dur"]
            stack.append((ts + events[i]["dur"], i))
    return self_us


def _launching_ops(events: List[dict]) -> Tuple[Dict, Dict]:
    """(``cpu_op`` by its ``External id``, a runtime call's ``External id``
    by its ``correlation``)."""
    ops, runtime = {}, {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") == "cpu_op" and "External id" in args:
            ops[args["External id"]] = ev
        elif ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            runtime[args["correlation"]] = args.get("External id")
    return ops, runtime


def _launching_op(ev: dict, ops: Dict, runtime: Dict) -> dict:
    """The ``cpu_op`` that launched device event ``ev``, or {}."""
    args = ev.get("args") or {}
    ext = args.get("External id")
    if ext not in ops:
        ext = runtime.get(args.get("correlation"))
    return ops.get(ext) or {}


def aggregate(events: List[dict], plane: str) -> Dict[str, dict]:
    """name -> {"us": total (self) microseconds, "count", "shapes": Counter of
    "launching op [input dims]", "cats": category -> [us, count]} over the
    plane's complete events, each event's category from its name and its
    launching op."""
    ops, runtime = _launching_ops(events)
    cats = PLANES.get(plane, ())
    selected = [ev for ev in events if ev.get("cat") in cats and ev.get("ph") == "X"]
    durations = _self_times(selected) if plane == "cpu" else [float(ev["dur"]) for ev in selected]
    table: Dict[str, dict] = {}
    for ev, dur in zip(selected, durations):
        rec = table.setdefault(ev["name"], {"us": 0.0, "count": 0, "shapes": Counter(),
                                            "cats": {}})
        rec["us"] += dur
        rec["count"] += 1
        op = ev if ev["cat"] == "cpu_op" else _launching_op(ev, ops, runtime)
        acc = rec["cats"].setdefault(category(ev["name"], op.get("name", "")), [0.0, 0])
        acc[0] += dur
        acc[1] += 1
        dims = (op.get("args") or {}).get("Input Dims")
        if dims:
            rec["shapes"][f"{op['name']} {json.dumps(dims)}"] += 1
    return table


class _Union:
    """The union of intervals, as sorted disjoint intervals, asked whether
    it holds a point."""

    def __init__(self, intervals):
        self.starts: List[float] = []
        self.ends: List[float] = []
        for s, e in sorted(intervals):
            if self.ends and s <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], e)
            else:
                self.starts.append(s)
                self.ends.append(e)

    def holds(self, x: float) -> bool:
        k = bisect.bisect_right(self.starts, x) - 1
        return k >= 0 and x <= self.ends[k]

    def total(self) -> float:
        return sum(e - s for s, e in zip(self.starts, self.ends))


def _interval(ev: dict) -> Tuple[float, float]:
    return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])


def span_table(events: List[dict]) -> Dict[str, dict]:
    """span name -> {"count", "host_ms", "device_ms", "python_idle_ms"} over
    the ``fm3d.`` spans, by the rules of the module's docstring (a CPU-only
    trace: no device ms and no idle)."""
    complete = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev]
    host = [ev for ev in complete if ev.get("cat") == "cpu_op"]
    spans = [ev for ev in host if ev["name"].startswith(SPAN_PREFIX)]
    device = [ev for ev in complete if ev.get("cat") in PLANES["gpu"]]
    by_name: Dict[str, List[dict]] = {}
    for ev in spans:
        by_name.setdefault(ev["name"], []).append(ev)
    unions = {name: _Union(_interval(ev) for ev in evs) for name, evs in by_name.items()}
    table = {name: dict(count=len(evs), host_ms=unions[name].total() / 1e3, device_ms=0.0,
                        python_idle_ms=0.0) for name, evs in by_name.items()}
    ops, runtime = _launching_ops(events)
    for ev in device:
        op = _launching_op(ev, ops, runtime)
        if op:
            for name, union in unions.items():
                if union.holds(float(op["ts"])):
                    table[name]["device_ms"] += float(ev["dur"]) / 1e3
    if device:
        busy = _Union(_interval(ev) for ev in device)
        start = min(_interval(ev)[0] for ev in host + device)
        end = max(_interval(ev)[1] for ev in host + device)
        others = _Union(_interval(ev) for ev in host if not ev["name"].startswith(SPAN_PREFIX))
        edges = [start] + [x for se in zip(busy.starts, busy.ends) for x in se] + [end]
        for s, e in zip(edges[::2], edges[1::2]):
            mid = 0.5 * (s + e)
            if e <= s or others.holds(mid):
                continue
            for name, union in unions.items():
                if union.holds(mid):
                    table[name]["python_idle_ms"] += (e - s) / 1e3
    return table


def rollup(table: Dict[str, dict]) -> Dict[str, List[float]]:
    """category -> [ms, count], most time first."""
    by_cat: Dict[str, List[float]] = {}
    for rec in table.values():
        for cat, (us, n) in rec["cats"].items():
            acc = by_cat.setdefault(cat, [0.0, 0])
            acc[0] += us / 1e3
            acc[1] += n
    return dict(sorted(by_cat.items(), key=lambda kv: -kv[1][0]))


def kernel_sums(table: Dict[str, dict], field: str = "count") -> Dict[str, float]:
    """Each hand-written kernel's events (``field`` "count") or microseconds
    ("us"), by its ``KERNEL_NAMES``."""
    return {k: sum(rec[field] for name, rec in table.items() if any(p in name for p in names))
            for k, names in KERNEL_NAMES.items()}


def top_rows(table: Dict[str, dict], top: int, match: Optional[str] = None) -> List[dict]:
    """The ``top`` names with the most time (those containing ``match``)."""
    names = sorted(table, key=lambda n: -table[n]["us"])
    if match:
        names = [n for n in names if match.lower() in n.lower()]
    return [dict(op=n, ms=round(table[n]["us"] / 1e3, 3), count=table[n]["count"],
                 category=max(table[n]["cats"], key=lambda c: table[n]["cats"][c][0]),
                 shapes=[s for s, _ in table[n]["shapes"].most_common(SHAPES_KEPT)])
            for n in names[:top]]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--match", default=None, help="only ops whose name contains this substring")
    p.add_argument("--plane", default="gpu",
                   help="gpu: the device's kernels, copies and sets (default); cpu: host ops; "
                        "spans: the port's fm3d. spans")
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    events, path = load_trace(args.trace_dir)
    print(f"# {path}", file=sys.stderr)
    if args.plane == "spans":
        return _print_spans(events, args)
    table = aggregate(events, args.plane)
    if not table:
        print("# categories in the trace:", sorted({str(ev.get("cat")) for ev in events}),
              file=sys.stderr)
        return 1
    print("## by category (ms, count):", file=sys.stderr)
    for cat, (ms, cnt) in rollup(table).items():
        print(f"  {ms:9.2f} ms x{cnt:<5d} {cat}", file=sys.stderr)
    total_ms = sum(rec["us"] for rec in table.values()) / 1e3
    print(f"## plane {args.plane}: {len(table)} ops, {total_ms:.1f} ms total event time",
          file=sys.stderr)
    for row in top_rows(table, args.top, args.match):
        if args.json:
            print(json.dumps(row))
        else:
            print(f"{row['ms']:9.3f} ms x{row['count']:<5d} {row['op']}  "
                  f"{row['shapes'] if row['shapes'] else ''}")
    return 0


def _print_spans(events: List[dict], args) -> int:
    table = span_table(events)
    if not table:
        print("# no fm3d. span in the trace; categories:",
              sorted({str(ev.get("cat")) for ev in events}), file=sys.stderr)
        return 1
    print(f"## spans: {len(table)} names (ms: host, device launched inside, python idle)",
          file=sys.stderr)
    names = sorted(table, key=lambda n: -table[n]["host_ms"])
    if args.match:
        names = [n for n in names if args.match.lower() in n.lower()]
    for name in names[:args.top]:
        rec = table[name]
        if args.json:
            print(json.dumps(dict(span=name, **{k: round(v, 3) if isinstance(v, float) else v
                                               for k, v in rec.items()})))
        else:
            print(f"{rec['host_ms']:10.3f} {rec['device_ms']:10.3f} {rec['python_idle_ms']:9.3f} "
                  f"x{rec['count']:<5d} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
