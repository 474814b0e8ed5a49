"""``replay_share.interactive`` on synthetic traces: every forward replayed,
none (a program without the replay span), half, and no trace."""

import pytest

from harness import spec, trace

MAIN, OTHER = 1, 2
NAME = "replay_share.interactive"


def _host(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "args": {}}


def _trace(replayed, tid=MAIN):
    """A window [0, 1000] with four forwards of 200 µs; the forwards in
    ``replayed`` hold a replay span, the rest the eager encoders' span; one
    kernel so that the device ran."""
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": 0,
               "dur": 1000, "pid": 1, "tid": MAIN},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 10, "pid": 0, "tid": 7,
               "args": {}}]
    for i in range(4):
        ts = 10 + 240 * i
        events.append(_host("fm3d.edit.forward", ts, 200))
        inner = "fm3d.edit.replay" if i in replayed else "fm3d.model.e_w_plus"
        events.append(_host(inner, ts + 20, 150, tid=tid))
    return {"trace": trace.Trace(events), "units": 4}


def _read(records):
    return spec.load_module(spec.metric_path(NAME), NAME).read(records)


@pytest.mark.parametrize("replayed,share", [((0, 1, 2, 3), 100.0), ((), 0.0), ((1, 3), 50.0)])
def test_share_of_forwards_holding_a_replay(replayed, share):
    assert _read(_trace(replayed)) == pytest.approx(share)


def test_replays_on_another_thread_do_not_count():
    assert _read(_trace((0, 1, 2, 3), tid=OTHER)) == 0.0


def test_nothing_to_read():
    assert _read({}) is None
    events = [ev for ev in _trace(())["trace"].host_ops if ev["name"] != "fm3d.edit.forward"]
    window = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": 0,
              "dur": 1000, "pid": 1, "tid": MAIN}
    assert _read({"trace": trace.Trace([window, *events])}) is None
