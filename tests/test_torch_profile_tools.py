"""The port's profiling and precision tools on the CPU, against the JAX tools:

* ``calc_inception --size`` is accepted and changes nothing;
* ``profile_train`` at small width writes a trace and the step seconds, with
  the JAX tool's config, arrays, step flags and traced iterations (the JAX
  ``main`` run against a stand-in ``Trainer``, no JAX compile);
* ``analyze_trace`` on that CPU trace and on a hand-built Chrome trace;
* ``validate_bf16``'s report equal to the JAX tool's on fixed histories, its
  data stream and config equal to JAX's ``run``, and a short CPU run;
* without ``--device`` both training tools refuse to run where no card is."""

import contextlib
import dataclasses
import functools
import gzip
import importlib.util
import inspect
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import fm3dgan.train as jax_train
from fm3dgan.train.config import TrainConfig as JaxTrainConfig
from fm3dgan_torch.eval.fid import load_stats
from fm3dgan_torch.tools import analyze_trace, calc_inception, profile_train, validate_bf16
from fm3dgan_torch.train import TrainConfig, steps
from test_torch_train_loop import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {k: v for k, v in TINY.items() if k != "size"}  # widths; the size comes from --size
STEP_NAMES = ("d_step", "d_reg_step", "g_step", "g_reg_step")
# The JAX steps' positional arguments (fm3dgan/train/steps.py _d_impl :170,
# _d_reg_impl :186, _g_impl :327, _g_reg_impl :385).
JAX_STEP_ARGS = {
    "d_step": ("state", "photo", "render", "ref", "rng", "use_edit"),
    "d_reg_step": ("state", "ref", "use_edit"),
    "g_step": ("state", "photo", "render", "ref", "rng", "frozen", "use_edit", "ds_flag",
               "extreme_ds_flag", "apply_hmap", "apply_ema"),
    "g_reg_step": ("state", "photo", "render", "rng", "apply_ema"),
}
FLAGS = ("use_edit", "ds_flag", "extreme_ds_flag", "apply_hmap", "apply_ema")
PROFILE_ARGS = ["--batch", "2", "--size", "128", "--iters", "1", "--no_frozen",
                "--dtype", "float32"]


def _jax_tool(name):
    """``tools/{name}.py`` as a module, the JAX compilation-cache settings it
    sets while imported put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


def _assert_config_matches_jax(cfg, jcfg):
    """Every field of the port's TrainConfig equals the JAX config's."""
    for f in dataclasses.fields(cfg):
        assert getattr(jcfg, f.name) == getattr(cfg, f.name), f.name


def _flags(names, values):
    return {k: bool(v) for k, v in zip(names, values) if k in FLAGS}


def test_calc_inception_accepts_size_and_ignores_it(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (32, 32, 3), np.uint8)).save(img_dir / f"x{i}.png")
    outs = []
    for extra in ([], ["--size", "256"]):
        out = str(tmp_path / f"stats{len(outs)}.pkl")
        rc, _ = _stdout(calc_inception.main, ["--img_dir", str(img_dir), "--out", out,
                                              "--batch", "2", "--device", "cpu", *extra])
        assert rc == 0
        outs.append(load_stats(out))
    assert calc_inception.build_arg_parser().parse_args(["--img_dir", "d", "--out", "o"]).size == 256
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_profile(tmp_path_factory):
    """The JAX ``tools/profile_train.py`` ``main`` at PROFILE_ARGS against a
    stand-in ``Trainer`` that records its config, its iterations' arrays and
    the step calls (and a no-op ``jax.profiler.trace``)."""
    tool = _jax_tool("profile_train")
    rec = {"iters": [], "arrays": [], "steps": []}

    def step(name, *args):
        rec["steps"].append((name, args))
        return types.SimpleNamespace(params={"w": jnp.zeros(1)}), {}

    class StandIn:
        def __init__(self, cfg, **kw):
            rec["config"], rec["kwargs"] = cfg, kw
            self.state = types.SimpleNamespace(params={"w": jnp.zeros(1)})
            self.frozen = {}
            self.steps = {n: functools.partial(step, n) for n in STEP_NAMES}

        def train_iteration(self, i, photo, render, ref, fused=False):
            rec["iters"].append(i)
            rec["arrays"].append(tuple(np.asarray(a) for a in (photo, render, ref)))

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_train, "Trainer", StandIn)
        mp.setattr(jax_train, "TrainConfig", functools.partial(JaxTrainConfig, **SMALL))
        mp.setattr(jax.profiler, "trace", lambda d: contextlib.nullcontext())
        mp.setattr(sys, "argv", ["profile_train.py", *PROFILE_ARGS, "--out_dir",
                                 str(tmp_path_factory.mktemp("jax_trace"))])
        _stdout(tool.main)
    finally:
        mp.undo()
    return rec


@pytest.fixture(scope="module")
def port_profile(tmp_path_factory):
    """The port's ``profile_train.main`` at PROFILE_ARGS on the CPU, at the
    TINY widths, recording the config, the iterations' arrays and the flags
    and rows of the step calls outside ``train_iteration``."""
    out_dir = str(tmp_path_factory.mktemp("trace"))
    rec = {"iters": [], "arrays": [], "steps": [], "inside": False}

    class Recording(profile_train.Trainer):
        def __init__(self, cfg, **kw):
            rec["config"], rec["kwargs"] = cfg, kw
            super().__init__(cfg, **kw)

        def train_iteration(self, i, photo, render, ref):
            rec["iters"].append(i)
            rec["arrays"].append((photo, render, ref))
            rec["inside"] = True
            try:
                return super().train_iteration(i, photo, render, ref)
            finally:
                rec["inside"] = False

    def recorded(name, fn):
        sig = inspect.signature(fn)

        def wrapper(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            args = bound.arguments
            if not rec["inside"]:
                rows = (args["photo"] if "photo" in args else args["ref"]).shape[0]
                rec["steps"].append((name, {k: args[k] for k in FLAGS if k in args}, rows))
            return fn(*a, **kw)
        return wrapper

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(profile_train, "Trainer", Recording)
        mp.setattr(profile_train, "TrainConfig", functools.partial(TrainConfig, **SMALL))
        for name in STEP_NAMES:
            mp.setattr(steps, name, recorded(name, getattr(steps, name)))
        rc, out = _stdout(profile_train.main, [*PROFILE_ARGS, "--out_dir", out_dir,
                                               "--device", "cpu"])
    finally:
        mp.undo()
    assert rc == 0
    rec["result"] = json.loads(out.strip().splitlines()[-1])
    rec["out_dir"] = out_dir
    return rec


def test_profile_train_writes_trace_and_step_seconds(port_profile):
    res = port_profile["result"]
    assert set(res) == {"step_seconds", "trace_dir"}  # no device numbers from a CPU run
    assert res["trace_dir"] == port_profile["out_dir"]
    assert sorted(res["step_seconds"]) == sorted(STEP_NAMES)
    assert all(v > 0 for v in res["step_seconds"].values()), res
    traces = [f for f in os.listdir(port_profile["out_dir"]) if f.endswith(".json")]
    assert len(traces) == 1
    with open(os.path.join(port_profile["out_dir"], traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("cat") == "cpu_op" for ev in events)


def test_profile_train_matches_jax_tool(port_profile, jax_profile):
    """Config field by field, Trainer arguments, the arrays of every
    iteration, the traced iteration indices, and each step's flags and rows."""
    _assert_config_matches_jax(port_profile["config"], jax_profile["config"])
    kw = dict(port_profile["kwargs"])
    assert kw.pop("device").type == "cpu"
    jkw = dict(jax_profile["kwargs"])
    assert jkw.pop("fast_init") is True  # JAX's init-time knob, none in eager PyTorch
    assert kw == jkw
    assert port_profile["iters"] == jax_profile["iters"] == [0, 1, 16]
    for got, want in zip(port_profile["arrays"], jax_profile["arrays"], strict=True):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    want_steps = []
    for name, args in jax_profile["steps"]:
        named = dict(zip(JAX_STEP_ARGS[name], args, strict=True))
        rows = (named["photo"] if "photo" in named else named["ref"]).shape[0]
        want_steps.append((name, _flags(JAX_STEP_ARGS[name], args), rows))
    assert port_profile["steps"] == want_steps
    g = dict(use_edit=False, ds_flag=False, extreme_ds_flag=False, apply_hmap=False,
             apply_ema=True)
    assert want_steps == [("d_step", {"use_edit": False}, 2)] * 2 + [
        ("d_reg_step", {"use_edit": False}, 2)] * 2 + [("g_step", g, 2)] * 2 + [
        ("g_reg_step", {"apply_ema": True}, 1)] * 2


def test_analyze_trace_cpu_plane_of_profile_train(port_profile):
    d = port_profile["out_dir"]
    rc, out = _stdout(analyze_trace.main, [d, "--plane", "cpu", "--top", "20"])
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 20 and any("aten::" in line for line in lines)
    rc, out = _stdout(analyze_trace.main, [d, "--plane", "cpu", "--json", "--match", "aten::"])
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert rc == 0 and rows and all("aten::" in r["op"] and r["count"] > 0 for r in rows)
    assert any(r["shapes"] for r in rows)  # record_shapes
    # A CPU trace has no device plane.
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert analyze_trace.main([d]) == 1
    assert "cpu_op" in err.getvalue()


BLUR = "void blur_tile_kernel<float, 4>(float const*, float*, BlurTaps, int)"
TRANSPOSE = "void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true>"
K1 = "void (anonymous namespace)::fused_lrelu_vec<float, 4>(uint4 const*)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8"


def _hand_trace():
    """A Chrome trace of two nested convolution ops, a blur operator, a
    convolution backward and a matmul on one host thread, runtime calls and
    device events: the conv kernel and a layout transpose linked by External
    id, one blur kernel by External id and one by its runtime call's
    correlation only, K1's and K2's kernels without a launching op, one gemm
    kernel launched by the convolution backward (a convolution) and by the
    matmul (a gemm), a copy."""
    op = lambda name, ts, dur, ext, dims: dict(  # noqa: E731
        ph="X", cat="cpu_op", name=name, pid=1, tid=1, ts=ts, dur=dur,
        args={"External id": ext, "Input Dims": dims})
    dev = lambda name, ts, dur, cat="kernel", **args: dict(  # noqa: E731
        ph="X", cat=cat, name=name, pid=0, tid=7, ts=ts, dur=dur, args=args)
    return [
        op("aten::conv2d", 0, 100, 1, [[2, 3, 8, 8], [4, 3, 3, 3]]),
        op("aten::cudnn_convolution", 10, 50, 2, [[2, 3, 8, 8], [4, 3, 3, 3]]),
        op("fm3dgan_torch::blur", 200, 30, 3, [[2, 4, 8, 8], [16]]),
        op("aten::convolution_backward", 240, 20, 4, [[2, 4, 8, 8]]),
        op("aten::mm", 270, 10, 5, [[4, 8], [8, 4]]),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=1, ts=20, dur=5,
             args={"External id": 2, "correlation": 11}),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=1, ts=210, dur=5,
             args={"External id": 3, "correlation": 12}),
        dev("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs", 300, 40,
            **{"External id": 2, "correlation": 11}),
        dev(TRANSPOSE, 350, 4,
            **{"External id": 2}),
        dev(BLUR, 400, 7, correlation=12),
        dev(BLUR, 410, 9, **{"External id": 3}),
        dev(K1, 420, 5),
        dev(GEMM, 440, 6, **{"External id": 4}),
        dev(GEMM, 450, 1, **{"External id": 5}),
        dev("void (anonymous namespace)::fused_lrelu_bwd_vec<float, 4>(uint4 const*)", 430, 3),
        dev("Memcpy HtoD (Pageable -> Device)", 500, 2, cat="gpu_memcpy"),
        dict(ph="s", cat="ac2g", name="ac2g", pid=1, tid=1, ts=20, id=11),
    ]


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = analyze_trace.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_analyze_trace_hand_built_trace(tmp_path):
    # An older, plain trace and the newest, gzipped one: the newest is read.
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"traceEvents": []}))
    os.utime(old, (1, 1))
    with gzip.open(tmp_path / "new.json.gz", "wt") as f:
        json.dump({"traceEvents": _hand_trace()}, f)
    d = str(tmp_path)

    rc, out, err = _run([d, "--json"])
    assert rc == 0 and "new.json.gz" in err
    rows = {r["op"]: r for r in map(json.loads, out.strip().splitlines())}
    blur = rows[BLUR]
    assert (blur["ms"], blur["count"], blur["category"]) == (0.016, 2, "port kernel")
    assert blur["shapes"] == ["fm3dgan_torch::blur [[2, 4, 8, 8], [16]]"]
    conv = rows["sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs"]
    assert (conv["ms"], conv["count"], conv["category"]) == (0.04, 1, "convolution")
    assert conv["shapes"] == ["aten::cudnn_convolution [[2, 3, 8, 8], [4, 3, 3, 3]]"]
    assert rows[TRANSPOSE]["category"] == "layout transpose"
    assert rows["Memcpy HtoD (Pageable -> Device)"]["category"] == "copy"
    assert rows[K1]["shapes"] == [] and rows[K1]["category"] == "port kernel"
    assert (rows[GEMM]["ms"], rows[GEMM]["count"], rows[GEMM]["category"]) == (
        0.007, 2, "convolution")
    assert rows[GEMM]["shapes"] == ["aten::convolution_backward [[2, 4, 8, 8]]",
                                    "aten::mm [[4, 8], [8, 4]]"]
    assert list(rows) == sorted(rows, key=lambda n: -rows[n]["ms"]) and len(rows) == 7
    assert "## plane gpu: 7 ops, 0.1 ms total event time" in err
    assert "      0.02 ms x4     port kernel\n" in err

    table = analyze_trace.aggregate(_hand_trace(), "gpu")
    assert analyze_trace.kernel_sums(table) == dict(
        blur=2, upsample2x=0, fused_leaky_relu=1, fused_leaky_relu_bwd=1, downsample2x=0)
    assert analyze_trace.kernel_sums(table, "us") == dict(
        blur=16.0, upsample2x=0, fused_leaky_relu=5.0, fused_leaky_relu_bwd=3.0, downsample2x=0)
    assert analyze_trace.rollup(table) == {"convolution": [0.046, 2], "port kernel": [0.024, 4],
                                           "layout transpose": [0.004, 1], "copy": [0.002, 1],
                                           "gemm": [0.001, 1]}

    rc, out, _ = _run([d, "--top", "2"])
    assert rc == 0 and len(out.strip().splitlines()) == 2
    assert out.splitlines()[0].startswith("    0.040 ms x1     sm90_xmma_fprop")
    rc, out, _ = _run([d, "--match", "BLUR"])
    assert rc == 0 and len(out.strip().splitlines()) == 1 and "x2 " in out

    # The host plane by self time: conv2d 100 - 50 us of its child.
    rc, out, err = _run([d, "--plane", "cpu", "--json"])
    cpu = {r["op"]: (r["ms"], r["count"]) for r in map(json.loads, out.strip().splitlines())}
    assert rc == 0 and cpu == {"aten::conv2d": (0.05, 1), "aten::cudnn_convolution": (0.05, 1),
                               "fm3dgan_torch::blur": (0.03, 1),
                               "aten::convolution_backward": (0.02, 1), "aten::mm": (0.01, 1)}
    assert "## plane cpu: 5 ops, 0.2 ms total event time" in err

    rc, out, err = _run([d, "--plane", "tpu"])
    assert rc == 1 and out == "" and "'kernel'" in err and "'cpu_op'" in err


def test_analyze_trace_span_plane_of_profile_train(port_profile):
    """Iteration 16 (R1 and PPL) traced on the CPU: each step once inside
    the iteration, Adam four times, EMA once, each model once per step,
    no loss network (``--no_frozen``), and no device time or idle."""
    rc, out = _stdout(analyze_trace.main, [port_profile["out_dir"], "--plane", "spans", "--json"])
    assert rc == 0
    rows = {r["span"]: r for r in map(json.loads, out.strip().splitlines())}
    models = ("e_tsr", "e_w", "e_w_plus", "generator")
    assert {k: r["count"] for k, r in rows.items()} == {
        "fm3d.train.iteration": 1, **{f"fm3d.train.{s}": 1 for s in STEP_NAMES},
        "fm3d.train.apply": 4, "fm3d.train.ema": 1, **{f"fm3d.model.{m}": 3 for m in models}}
    steps_ms = sum(rows[f"fm3d.train.{s}"]["host_ms"] for s in STEP_NAMES)
    assert 0 < steps_ms <= rows["fm3d.train.iteration"]["host_ms"]
    assert all(r["device_ms"] == 0 and r["python_idle_ms"] == 0 for r in rows.values())
    assert list(rows) == sorted(rows, key=lambda n: -rows[n]["host_ms"])


def test_analyze_trace_span_plane_hand_built(tmp_path):
    """``_hand_trace`` under two spans on its thread, a D step [0, 235] and
    a G step [235, 420], and autograd's thread running [350, 410] with a
    matmul at 360 whose gemm runs at [460, 462].  Device time by the span
    holding the launching op's start, whatever its thread: the D step's
    conv, transpose and both blurs (60 us), the G step's gemms (9 us).
    Python idle: gaps whose middle lies in a span with no other op open:
    [0, 300] (middle 150, the D step), [340, 350] and [419, 420] (the G
    step); [354, 400] and [407, 410] lie under autograd's op."""
    def span(name, ts, dur):
        return dict(ph="X", cat="cpu_op", name=name, pid=1, tid=1, ts=ts, dur=dur,
                    args={"External id": 100 + ts})

    def autograd_op(name, ts, dur, ext):
        return dict(ph="X", cat="cpu_op", name=name, pid=1, tid=2, ts=ts, dur=dur,
                    args={"External id": ext})

    events = _hand_trace() + [
        span("fm3d.train.d_step", 0, 235), span("fm3d.train.g_step", 235, 185),
        autograd_op("autograd::engine::evaluate_function: MmBackward0", 350, 60, 6),
        autograd_op("aten::mm", 360, 5, 7),
        dict(ph="X", cat="kernel", name=GEMM, pid=0, tid=7, ts=460, dur=2,
             args={"External id": 7})]
    table = analyze_trace.span_table(events)
    assert table == {
        "fm3d.train.d_step": dict(count=1, host_ms=pytest.approx(0.235),
                                  device_ms=pytest.approx(0.06), python_idle_ms=pytest.approx(0.3)),
        "fm3d.train.g_step": dict(count=1, host_ms=pytest.approx(0.185),
                                  device_ms=pytest.approx(0.009),
                                  python_idle_ms=pytest.approx(0.011))}
    with gzip.open(tmp_path / "t.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    rc, out, err = _run([str(tmp_path), "--plane", "spans", "--top", "1"])
    assert rc == 0 and "## spans: 2 names" in err
    assert out.split() == ["0.235", "0.060", "0.300", "x1", "fm3d.train.d_step"]
    with gzip.open(tmp_path / "t.json.gz", "wt") as f:
        json.dump({"traceEvents": _hand_trace()}, f)
    rc, out, err = _run([str(tmp_path), "--plane", "spans"])
    assert rc == 1 and out == "" and "no fm3d. span" in err


def test_profile_summary_counts_overlapping_device_events_once():
    """Busy time is the union of the device events' intervals: a copy on a
    side stream [100, 160] under a kernel [120, 220] is 120 us, not 160."""
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, key, device_type, start=0.0, end=0.0, self_us=0.0):
            self.key, self.device_type, self.count = key, device_type, 1
            self.time_range = types.SimpleNamespace(start=start, end=end)
            self.self_device_time_total = self_us if device_type != DeviceType.CPU else 0.0
            self.self_cpu_time_total = self_us if device_type == DeviceType.CPU else 0.0

    events = [Ev("Memcpy HtoD (Pinned -> Device)", DeviceType.CUDA, 100, 160, 60),
              Ev("sm90_xmma_fprop_implicit_gemm", DeviceType.CUDA, 120, 220, 100),
              Ev("aten::cudnn_convolution", DeviceType.CPU, 90, 130, 40)]
    prof = types.SimpleNamespace(key_averages=lambda: events, events=lambda: events)
    got = profile_train.profile_summary(prof, wall_s=400e-6, iterations=2)
    assert got["device_busy_ms_per_iteration"] == pytest.approx(0.06)
    assert got["device_idle_share"] == pytest.approx(0.7)
    assert [r["name"] for r in got["top_device"]] == ["sm90_xmma_fprop_implicit_gemm",
                                                      "Memcpy HtoD (Pinned -> Device)"]
    assert profile_train.busy_us([(0, 10), (5, 8), (20, 30), (25, 40)]) == 30


FIXED_HISTORIES = {
    "float32": {"d": [1.0, 1.2, 0.9, 1.1, 1.0, 0.8, 1.3, 1.05, 0.95], "g": [0.5, 0.0, 0.001] * 3,
                "l1": [0.3, 0.2], "r1": [0.01] * 9, "g_reg": [], "lpips": [2.0] * 9,
                "face_id": [10.0, 9.0, 8.0, 7.0]},
    "bfloat16": {"d": [1.0, 1.25, 0.85, 1.1, 1.0, 0.9, 1.2, 1.0, 0.9], "g": [0.5, 0.002, 0.0] * 3,
                 "l1": [0.31, 0.2, 0.25], "r1": [0.01] * 8 + [float("nan")], "g_reg": [],
                 "lpips": [2.0] * 9, "face_id": [10.0, 9.5, 8.0, 6.0]},
}


def test_validate_bf16_report_equals_jax_tool(monkeypatch):
    """Both ``main``s with their ``run`` returning fixed histories (unequal
    lengths, a metric never reported, a non-finite bf16 value): the same
    printed report."""
    tool = _jax_tool("validate_bf16")
    fixed = lambda dtype, args: FIXED_HISTORIES[dtype]  # noqa: E731
    monkeypatch.setattr(tool, "run", fixed)
    monkeypatch.setattr(sys, "argv", ["validate_bf16.py"])
    _, want = _stdout(tool.main)
    monkeypatch.setattr(validate_bf16, "run", fixed)
    rc, got = _stdout(validate_bf16.main, [])
    assert rc == 0 and got == want
    report = json.loads(got.replace("NaN", "null"))
    assert report["all_bf16_finite"] is False and "g_reg" not in report


def test_validate_bf16_run_matches_jax_data_and_config(monkeypatch):
    """JAX's ``run`` against a stand-in ``fm3dgan.train.Trainer``, the port's
    against a stand-in ``Trainer``, both returning the same fixed metrics:
    the same config, Trainer arguments, per-iteration arrays and history."""
    tool = _jax_tool("validate_bf16")
    args = validate_bf16.build_arg_parser().parse_args(["--iters", "3", "--device", "cpu"])

    def stand_in(rec):
        class StandIn:
            def __init__(self, cfg, **kw):
                rec["config"], rec["kwargs"], rec["arrays"] = cfg, kw, []

            def train_iteration(self, i, photo, render, ref):
                rec["arrays"].append((i, *(np.asarray(a) for a in (photo, render, ref))))
                return {"d": 1.0 + i, "g": 2.0 * i, "l1": 0.5, "lpips": -1.0, "extra": 3.0}
        return StandIn

    jax_rec, port_rec = {}, {}
    monkeypatch.setattr(jax_train, "Trainer", stand_in(jax_rec))
    monkeypatch.setattr(validate_bf16, "Trainer", stand_in(port_rec))
    for dtype in ("float32", "bfloat16"):
        want, got = tool.run(dtype, args), validate_bf16.run(dtype, args)
        assert got == want and got["d"] == [1.0, 2.0, 3.0] and got["r1"] == []
        _assert_config_matches_jax(port_rec["config"], jax_rec["config"])
        assert port_rec["config"].compute_dtype == dtype
        kw = dict(port_rec["kwargs"])
        assert kw.pop("device") == "cpu" and kw == jax_rec["kwargs"]
        for a, b in zip(port_rec["arrays"], jax_rec["arrays"], strict=True):
            assert a[0] == b[0] and a[1].shape == (4, 128, 128, 3) and a[3].shape == (4, 64, 64, 3)
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)


def test_validate_bf16_small_cpu_run(monkeypatch):
    """4 iterations at the TINY widths (LPIPS and ArcFace on, R1 and PPL at
    iteration 0) in float32 and bfloat16: every tracked metric reported each
    iteration and finite."""
    monkeypatch.setattr(validate_bf16, "TrainConfig", functools.partial(TrainConfig, **SMALL))
    args = validate_bf16.build_arg_parser().parse_args(
        ["--iters", "4", "--size", "16", "--batch", "2", "--device", "cpu"])
    hist = {dtype: validate_bf16.run(dtype, args) for dtype in ("float32", "bfloat16")}
    for h in hist.values():
        for k in validate_bf16.TRACKED:
            assert len(h[k]) == 4 and np.isfinite(h[k]).all(), (k, h[k])
    report = validate_bf16.report(hist["float32"], hist["bfloat16"])
    assert report["all_bf16_finite"] is True
    assert set(report) == {*validate_bf16.TRACKED, "all_bf16_finite"}


@pytest.mark.parametrize("tool", ["profile_train", "validate_bf16"])
def test_training_tools_need_a_card_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"profile_train": profile_train, "validate_bf16": validate_bf16}[tool]
    monkeypatch.setattr(module, "TrainConfig", functools.partial(TrainConfig, **SMALL))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        module.main(["--size", "16", "--batch", "2", "--iters", "1"])
