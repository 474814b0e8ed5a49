"""The spans' reduction on a synthetic trace: device time by the span that
holds its launching operator (on any thread), host time in spans, the
device-idle time with the host in the port's Python, and the eight metric
files reading nothing from a trace without spans."""

import pytest

from harness import spans, spec, trace

MAIN, AUTOGRAD = 1, 2
SPAN_METRICS = ("d_ms.train", "g_ms.train", "reg_ms.train", "ffhq_ms.train", "opt_ms.train",
                "py_idle_ms.train", "enc_host_ms.interactive", "g_host_ms.interactive")


def _host(name, ts, dur, ext, tid=MAIN):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "args": {"External id": ext}}


def _dev(name, ts, dur, ext):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"External id": ext}}


def synthetic():
    """A window [0, 1000] on the main thread: a D step [10, 300] holding an
    Adam update [250, 257]; a G step [400, 900] whose backward runs on
    autograd's thread [500, 700] while the main thread waits; an encoder
    span [410, 480] inside the G step.  Device busy [20, 120], [255, 260],
    [300, 350] (launched inside the D step, stray), [420, 470] and [520,
    560], [600, 690]; idle gaps in between."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": 0, "dur": 1000,
         "pid": 1, "tid": MAIN},
        _host("fm3d.train.d_step", 10, 290, 1),
        _host("aten::cudnn_convolution", 15, 10, 2),
        _host("fm3d.train.apply", 250, 7, 3),
        _host("aten::_foreach_add_", 252, 3, 4),
        _host("aten::copy_", 258, 40, 5),
        _host("fm3d.train.g_step", 400, 500, 6),
        _host("fm3d.model.e_tsr", 410, 70, 7),
        _host("aten::cudnn_convolution", 412, 5, 8),
        _host("autograd::engine::evaluate_function: ConvolutionBackward0", 500, 200, 9,
              tid=AUTOGRAD),
        _host("aten::convolution_backward", 505, 10, 10, tid=AUTOGRAD),
        _host("aten::convolution_backward", 590, 8, 11, tid=AUTOGRAD),
        _dev("sm90_xmma_fprop_implicit_gemm", 20, 100, 2),
        _dev("multi_tensor_apply_kernel", 255, 5, 4),
        _dev("Memcpy DtoD", 300, 50, 5),           # launched at 258, in the D step
        _dev("sm90_xmma_fprop_implicit_gemm", 420, 50, 8),
        _dev("sm90_xmma_dgrad", 520, 40, 10),      # launched on autograd's thread
        _dev("sm90_xmma_wgrad", 600, 90, 11),
    ]


def _records(events=None, units=2):
    return {"trace": trace.Trace(events or synthetic()), "units": units}


def test_kernels_from_autograds_thread_count_toward_the_waiting_step():
    r = _records()
    assert spans.device_ms(r, ("fm3d.train.d_step",)) == pytest.approx((100 + 5 + 50) / 1e3 / 2)
    assert spans.device_ms(r, ("fm3d.train.g_step",)) == pytest.approx((50 + 40 + 90) / 1e3 / 2)
    assert spans.device_ms(r, ("fm3d.train.apply",)) == pytest.approx(5 / 1e3 / 2)
    # Each event once over spans that nest.
    assert spans.device_ms(r, ("fm3d.train.g_step", "fm3d.model.e_tsr")) == pytest.approx(
        spans.device_ms(r, ("fm3d.train.g_step",)))
    assert spans.device_ms(r, ("fm3d.train.g_reg_step",)) is None


def test_host_time_inside_spans():
    r = _records()
    assert spans.host_ms(r, ("fm3d.model.e_tsr",)) == pytest.approx(70 / 1e3 / 2)
    assert spans.host_ms(r, ("fm3d.train.g_step", "fm3d.model.e_tsr")) == pytest.approx(
        500 / 1e3 / 2)
    assert spans.host_ms(r, ("fm3d.model.generator",)) is None


def test_python_idle_gaps():
    """Gaps, each judged at its middle: [0, 20] (10: the D step alone,
    Python); [120, 255] (the D step alone, Python); [260, 300] (280: in
    aten::copy_, not Python); [350, 420] (385: between the steps, no span);
    [470, 520] (495: the G step alone, Python); [560, 600] (580: autograd's
    engine open on its thread, not Python); [690, 1000] (845: the G step
    alone, Python)."""
    r = _records()
    assert spans.python_idle_ms(r) == pytest.approx((20 + 135 + 50 + 310) / 1e3 / 2)


def test_gap_under_autograd_is_not_python():
    events = synthetic()
    events.append(_host("autograd::engine::evaluate_function: AddBackward0", 690, 310, 12,
                        tid=AUTOGRAD))
    assert spans.python_idle_ms(_records(events)) == pytest.approx((20 + 135 + 50) / 1e3 / 2)


def test_gap_with_only_a_span_open_is_python():
    events = [ev for ev in synthetic() if ev["tid"] != AUTOGRAD]
    # [560, 600] now has the G step alone open, as [470, 520] and [690, 1000].
    assert spans.python_idle_ms(_records(events)) == pytest.approx(
        (20 + 135 + 50 + 40 + 310) / 1e3 / 2)


def test_no_spans_read_nothing():
    events = [ev for ev in synthetic() if not ev["name"].startswith(spans.PREFIX)]
    r = _records(events)
    for name in SPAN_METRICS:
        assert spec.load_module(spec.metric_path(name), name).read(r) is None, name
    assert all(spec.load_module(spec.metric_path(n), n).read({}) is None for n in SPAN_METRICS)


def test_metric_files_read_their_spans():
    r = _records()
    read = {n: spec.load_module(spec.metric_path(n), n).read(r) for n in SPAN_METRICS}
    assert read["d_ms.train"] == pytest.approx(0.0775)
    assert read["g_ms.train"] == pytest.approx(0.09)
    assert read["opt_ms.train"] == pytest.approx(0.0025)
    assert read["enc_host_ms.interactive"] == pytest.approx(0.035)
    assert read["py_idle_ms.train"] == pytest.approx(0.2575)
    assert read["reg_ms.train"] is read["ffhq_ms.train"] is read["g_host_ms.interactive"] is None
