"""The four readers of the 1024 px edit cell and the data-parallel cell on a
synthetic trace: device ms per traced unit launched inside their spans
(``fm3d.model.g_level.512`` and ``.1024``; ``fm3d.model.psp_styles``;
``fm3d.parallel.grads``; ``fm3d.parallel.stats``), and nothing read where
the trace holds none of them, as the parent's program gives."""

import pytest

from harness import spec, trace

UNITS = 2


def _host(name, ts, dur, ext):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": {"External id": ext}}


def _dev(name, ts, dur, ext):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"External id": ext}}


def _records(with_spans: bool):
    """A window [0, 2000]: G's 256 / 512 / 1024 levels and pSp's two spans,
    then an Adam update holding the gradient all-reduce and a BatchNorm
    holding its statistics' gather, each launching one kernel."""
    spans = [
        _host("fm3d.model.psp_body", 10, 90, 1), _host("aten::conv2d", 20, 5, 2),
        _host("fm3d.model.psp_styles", 100, 100, 3), _host("aten::conv2d", 110, 5, 4),
        _host("fm3d.model.g_level.256", 300, 100, 5), _host("aten::conv2d", 310, 5, 6),
        _host("fm3d.model.g_level.512", 400, 100, 7), _host("aten::conv2d", 410, 5, 8),
        _host("fm3d.model.g_level.1024", 500, 400, 9), _host("aten::conv2d", 510, 5, 10),
        _host("fm3d.train.apply", 1000, 200, 11),
        _host("fm3d.parallel.grads", 1010, 100, 12), _host("c10d::allreduce_", 1020, 5, 13),
        _host("fm3d.parallel.stats", 1300, 100, 14), _host("c10d::allgather_", 1310, 5, 15),
    ]
    kernels = [_dev("psp_body_conv", 30, 40, 2), _dev("psp_styles_conv", 120, 60, 4),
               _dev("g256", 320, 50, 6), _dev("g512", 420, 70, 8), _dev("g1024", 520, 300, 10),
               _dev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1030, 80, 13),
               _dev("ncclDevKernel_AllGather_RING_LL", 1320, 30, 15)]
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": 0,
               "dur": 2000, "pid": 1, "tid": 1}] + kernels
    if with_spans:
        events += spans
    else:  # the same operators, no spans
        events += [e for e in spans if not e["name"].startswith("fm3d.")]
    return {"trace": trace.Trace(events), "units": UNITS}


def _read(name, records):
    return spec.load_module(spec.metric_path(name), name).read(records)


@pytest.mark.parametrize("name, us", [("hires_ms.edit1024", 70 + 300),
                                      ("styles_ms.edit1024", 60),
                                      ("grad_sync_ms.dp4", 80),
                                      ("stat_sync_ms.dp4", 30)])
def test_reads_device_ms_per_unit_inside_its_spans(name, us):
    assert _read(name, _records(True)) == pytest.approx(us / 1e3 / UNITS)
    assert _read(name, _records(False)) is None
    assert _read(name, {}) is None
