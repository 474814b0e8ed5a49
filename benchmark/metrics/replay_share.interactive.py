"""Percent of the traced interactive edit requests replayed from a CUDA
graph: the ``fm3d.edit.forward`` spans on the window's thread that hold the
start of a ``fm3d.edit.replay`` span.  0 for a program that records the
forward's span and replays nothing; None without a trace or forward spans."""

import numpy as np

FORWARD, REPLAY = "fm3d.edit.forward", "fm3d.edit.replay"


def _intervals(t, name):
    """[k, 2] µs intervals of the spans ``name`` on the window's thread
    that start inside the window."""
    return np.array([(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])) for ev in t.host_ops
                     if ev["name"] == name and (ev.get("pid"), ev.get("tid")) == t.host_tid
                     and t.start_us <= float(ev["ts"]) < t.end_us]).reshape(-1, 2)


def read(records):
    t = records.get("trace")
    if t is None:
        return None
    forwards = _intervals(t, FORWARD)
    if not len(forwards):
        return None
    starts = _intervals(t, REPLAY)[:, 0]
    held = ((starts[None, :] >= forwards[:, :1]) & (starts[None, :] <= forwards[:, 1:])).any(axis=1)
    return 100.0 * float(held.mean())
