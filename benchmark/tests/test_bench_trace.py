"""The trace's reduction on a synthetic trace: busy time as a union of
intervals, categories, the join of kernels to their launching operators,
and the kernels' bytes."""

import json

import pytest

from harness import kernel_bytes, readers, trace


def _op(name, ts, dur, ext, dims, types, concrete):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": {"External id": ext, "Input Dims": dims, "Input type": types,
                     "Concrete Inputs": concrete}}


def _dev(name, ts, dur, ext=None, corr=None, cat="kernel", tid=7):
    args = {}
    if ext is not None:
        args["External id"] = ext
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args}


TAPS = json.dumps([1 / 64] * 16)


def synthetic():
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK, "ts": 0, "dur": 1000,
         "pid": 1, "tid": 1},
        _op("fm3dgan_torch::blur", 10, 5, 1, [[2, 4, 9, 9], [], [], [], [], []],
            ["float", "ScalarList", "Scalar", "Scalar", "Scalar", "Scalar"],
            ["", TAPS, "4", "4", "1", "1"]),
        _op("aten::cudnn_convolution", 20, 5, 2, [[2, 4, 8, 8]], ["float"], [""]),
        _op("fm3dgan_torch::fused_leaky_relu", 30, 5, 3, [[2, 4, 8, 8], [4], [], []],
            ["float", "float", "Scalar", "Scalar"], ["", "", "0.2", "1.414"]),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 31, "dur": 1,
         "pid": 1, "tid": 1, "args": {"correlation": 99, "External id": 3}},
        _dev("blur_tile_kernel<float>", 100, 100, ext=1),
        _dev("sm90_xmma_fprop_implicit_gemm", 150, 200, ext=2),   # overlaps the blur
        _dev("fused_lrelu_vec<float>", 600, 50, corr=99),         # joined by correlation
        _dev("Memcpy HtoD", 900, 50, cat="gpu_memcpy", tid=8),
        _dev("kernel_before_the_window", -50, 20, ext=2),
    ]


def test_busy_is_a_union_of_intervals():
    t = trace.Trace(synthetic())
    assert t.window_s == pytest.approx(1e-3)
    # [100, 350] + [600, 650] + [900, 950]; the overlap counted once
    assert t.busy_s() == pytest.approx(350e-6)
    assert sum(e["dur"] for e in t.device) / 1e6 > t.busy_s()
    assert readers.idle_share({"trace": t}) == pytest.approx(65.0)


def test_categories_and_join():
    t = trace.Trace(synthetic())
    ops = {e["name"]: e["op"] for e in t.device}
    assert ops["fused_lrelu_vec<float>"] == "fm3dgan_torch::fused_leaky_relu"
    assert t.category_s("convolution") == pytest.approx(200e-6)
    assert trace.category("cutlass_gemm", "aten::cudnn_convolution") == "convolution"
    assert trace.category("cutlass_gemm", "aten::mm") == "gemm"
    assert readers.conv_ms_per_unit({"trace": t, "units": 2}) == pytest.approx(0.1)
    assert readers.launches_per_unit({"trace": t, "units": 1}) == 3


def test_kernel_bytes_and_roofline():
    args = synthetic()[1]["args"]
    # blur 4x4, pads (1, 1): 9x9 -> 8x8
    assert kernel_bytes.launch_cost("blur", args) == ((2 * 4 * 81 + 2 * 4 * 64) * 4,
                                                      2 * 4 * 64 * 32)
    act = synthetic()[3]["args"]
    assert kernel_bytes.launch_cost("fused_leaky_relu", act)[0] == (2 * 2 * 4 * 64 + 4) * 4
    t = trace.Trace(synthetic())
    bound = (kernel_bytes.bound_s(*kernel_bytes.launch_cost("blur", args))
             + kernel_bytes.bound_s(*kernel_bytes.launch_cost("fused_leaky_relu", act)))
    assert readers.kernel_roofline({"trace": t}) == pytest.approx(bound / 150e-6 * 100)


def test_missing_shapes_read_nothing():
    events = synthetic()
    events[1]["args"].pop("Concrete Inputs")
    assert readers.kernel_roofline({"trace": trace.Trace(events)}) is None


def test_down_and_up_bytes():
    down = {"Input Dims": [[1, 3, 8, 8], [], [], []], "Input type": ["float"],
            "Concrete Inputs": ["", json.dumps([0.25, 0.75, 0.75, 0.25]), "1", "1"]}
    assert kernel_bytes.launch_cost("downsample2x", down)[0] == (3 * 64 + 3 * 16) * 4
    up = {"Input Dims": [[1, 3, 4, 4], [], [], []], "Input type": ["c10::BFloat16"]}
    assert kernel_bytes.launch_cost("upsample2x", up)[0] == (48 + 4 * 48) * 2


def test_idle_gaps_named_by_host_op():
    gaps = dict(trace.Trace(synthetic()).idle_gaps())
    assert sum(gaps.values()) == pytest.approx(650e-6)
