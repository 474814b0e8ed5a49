"""The port's ``fm3d.`` spans in a traced window, reduced for the per-layer
metrics that read them.

A span is a host event (``cat`` ``cpu_op``) whose name starts with
``fm3d.``, which the program records at its layer boundaries while the
profiler runs.  From the trace's events alone (``harness/trace.py``):

- a device event belongs to every span on the window's thread whose
  interval holds the start of the host operator that launched it, found by
  its ``External id`` among the host operators of every thread: the
  backward that autograd's thread launches while a step waits for it
  counts toward that step;
- an idle gap between busy intervals is the port's own Python when, at its
  middle, a span is open on the window's thread and no other host operator
  is open on any thread.

Each reader returns None where the trace holds none of the spans it reads,
as a program without them gives.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from harness.trace import WINDOW_MARK

PREFIX = "fm3d."


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of intervals [k, 2] as sorted disjoint intervals."""
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])
    return np.stack([iv[first, 0], reach[np.r_[first[1:] - 1, len(iv) - 1]]], axis=1)


def _inside(points: np.ndarray, merged: np.ndarray) -> np.ndarray:
    """Whether each point lies in one of the sorted disjoint intervals."""
    if not len(merged) or not len(points):
        return np.zeros(len(points), dtype=bool)
    k = np.searchsorted(merged[:, 0], points, side="right") - 1
    return (k >= 0) & (points <= merged[np.maximum(k, 0), 1])


def _intervals(events) -> np.ndarray:
    return np.array([(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])) for ev in events]
                    ).reshape(-1, 2)


def _spans(t, names: Optional[Iterable[str]] = None) -> np.ndarray:
    """The intervals of the spans on the window's thread (those named in
    ``names``, else all), clipped to the window."""
    wanted = None if names is None else set(names)
    iv = _intervals(ev for ev in t.host_ops
                    if (ev.get("pid"), ev.get("tid")) == t.host_tid
                    and ev["name"].startswith(PREFIX) and (wanted is None or ev["name"] in wanted))
    iv = np.clip(iv, t.start_us, t.end_us)
    return iv[iv[:, 1] > iv[:, 0]]


def _per_unit_ms(records, us: float) -> Optional[float]:
    units = records.get("units")
    return us / 1e3 / units if units else None


def device_ms(records, names: Iterable[str]) -> Optional[float]:
    """Device ms per traced unit in the events launched inside the spans
    ``names`` (each event once, however many of them hold it)."""
    t = records.get("trace")
    if t is None:
        return None
    spans = _spans(t, names)
    if not len(spans):
        return None
    starts = {ev["args"]["External id"]: float(ev["ts"]) for ev in t.host_ops
              if "External id" in (ev.get("args") or {})}
    launched = [(starts[e["op_args"]["External id"]], e["dur"]) for e in t.device
                if e["op_args"].get("External id") in starts]
    if not launched:
        return _per_unit_ms(records, 0.0)
    at, dur = np.array(launched).T
    return _per_unit_ms(records, float(dur[_inside(at, _merge(spans))].sum()))


def host_ms(records, names: Iterable[str]) -> Optional[float]:
    """Host ms per traced unit inside the spans ``names`` (their union)."""
    t = records.get("trace")
    if t is None:
        return None
    spans = _merge(_spans(t, names))
    if not len(spans):
        return None
    return _per_unit_ms(records, float((spans[:, 1] - spans[:, 0]).sum()))


def python_idle_ms(records) -> Optional[float]:
    """Device-idle ms per traced unit with the host in the port's own
    Python: gaps whose middle lies in a span on the window's thread and in
    no other host operator on any thread."""
    t = records.get("trace")
    if t is None:
        return None
    spans = _spans(t)
    if not len(spans):
        return None
    busy = t.busy_intervals()
    edges = np.concatenate([[t.start_us], busy.ravel(), [t.end_us]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mid = gaps.mean(axis=1)
    others = _merge(_intervals(ev for ev in t.host_ops if not ev["name"].startswith(PREFIX)
                               and ev["name"] != WINDOW_MARK))
    python = _inside(mid, _merge(spans)) & ~_inside(mid, others)
    return _per_unit_ms(records, float((gaps[python, 1] - gaps[python, 0]).sum()))
