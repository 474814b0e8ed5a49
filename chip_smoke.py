"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Builds the hand-written CUDA kernels of ``fm3dgan_torch`` from
``fm3dgan_torch/ops/csrc`` and then, in order (TF32 off throughout):

1. kernel phase: each kernel at every shape the 256 px inference forward
   gives it (batch 8) and at every shape a training iteration gives it
   (batch 16), float32 and bfloat16, against its plain PyTorch version on
   the card, with its time, the plain version's time, one PyTorch library
   call's time where one computes the same function, and its memory/compute
   bound; the kernel and the library call are also timed apart on the
   device (``device_ms``, a CUDA-graph replay) and on the host
   (``host_us``);
2. path phase: ``FaceManipulator.create(size=256, input_size=256)`` with
   seeded random weights runs ``forward_3_encoder`` at batch 8 in float32
   through the kernels and through the plain versions, checks the output
   and the launch counts, repeats in bfloat16, checks a small configuration
   on the card against the CPU, and times batch 32;
3. gradient phase: on a full-width 256 px ``Trainer(TrainConfig())`` state
   (with its frozen LPIPS and ArcFace), the gradients of one G step (GAN +
   LPIPS + L1 + face-ID + face-regional, fixed noise) and of one R1 step at
   batch 16, through the kernels, under ``plain_versions()`` (which must
   launch nothing and reproduce itself to the bit) and, as the exact
   reference, under ``plain_versions()`` in float64; each parameter tensor
   held to :func:`hold_gradient` (the 1e-4 bar, widened only where the
   float64 run shows the plain float32 path itself further off);
4. training phase: that ``Trainer`` runs iterations 0-5 on seeded uint8
   batches of 16 in float32 (reconstruction, DS with D_edit, extreme DS,
   R1, PPL), printing flags, losses, ms and launches per iteration, and
   checks that the losses are finite, every partition, g_ema and the
   BatchNorm statistics moved, the PPL mean is positive, all five kernels
   ran and each iteration without regulariser launched them as often as
   the kernel phase's per-shape weights say; times the loss networks'
   forward and input gradient at the G step's shapes; then 2 iterations in
   bfloat16 and 2 with ``share_dg_noise`` (one G forward fewer each);
5. heatmap phases, on ``TrainConfig(hmap_loss_lambda=1, hmap_iter_thres=0)``
   with its FAN (256 px input): FAN's forward and forward plus input
   gradient at the G step's shapes (16 + 16 images) in float32 and
   bfloat16, and against float64; 2 float32 iterations, which must launch
   each kernel as the iterations without FAN do; one G step with the
   heatmap term held as in the gradient phase;
6. eval phase: ``QuantEvalHook`` on that trainer with LPIPS, ArcFace, a
   seeded InceptionV3 and FAN, 64 reconstruction and 16 x 4 edit images:
   seconds per pass, the EMA forward's img/s, its launches (forward kernels
   only), and the scores and a sample grid through the kernels against the
   plain versions;
7. CLI phase: ``python -m fm3dgan_torch.tools.train_3_encoder`` (its
   ``main``) on fake data, 6 iterations at 256 px with the heatmap loss, a
   sample grid every 2 iterations and a checkpoint with its eval line (FID
   against statistics the script writes) after iteration 3, then resumed
   from it: iteration 4's D and G losses must agree with the uninterrupted
   run's;
8. 2-encoder path phase: ``TwoEncoderModels.create(size=256)`` with seeded
   random weights runs ``forward_2_encoder`` at batch 8 in float32 in its
   five configurations (no co-modulation with the render or the photo as
   the modulation input, Multiplication, Concatenation, Tensor Transform)
   through the kernels and through the plain versions: within 1e-4, K1, K3
   and K4 launching on the kernel path and nothing on the plain path; then
   the Tensor Transform forward's img/s at batch 32;
9. 2-encoder gradient phase: on a full-width 256 px
   ``Trainer2(TrainConfig(), co_modulation="Tensor Transform",
   ds_dataset_type="FFHQ")`` state, the gradients of a G step, of the FFHQ
   step's G update and of a PPL step at batch ``TWO_GRAD_BATCH``, held as in
   phase 3;
10. 2-encoder training phase: that trainer runs iterations 0-5 at batch 16
    (reconstruction with R1 and PPL, FFHQ dual supervision, PPL), printing
    ms, losses and launches per iteration; every loss finite, every kernel
    launched, and the iterations without regulariser launch each kernel as
    often as the kernel phase's weights say (an FFHQ iteration twice as
    often: it runs G, D_ffhq and their backward once more);
11. 2-encoder CLI phase: ``python -m fm3dgan_torch.tools.train_2_encoder``
    (its ``main``) with fake data, Tensor Transform and FFHQ dual
    supervision, 6 iterations at 256 px with a checkpoint after iteration 3,
    then resumed from it: iteration 4's losses must equal the uninterrupted
    run's to the bit (cuDNN's deterministic algorithms in both).

Prints one JSON line per measurement and per phase's seconds, the card's
name and power limit, a ``{"kernels": [...]}`` summary, and last
``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device, when a kernel
does not build or launch, or when any check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BATCH = 8
TIMED_BATCH = 32
TRAIN_BATCH = 16
GRAD_BATCH = 16
TRAIN_ITERS = 6
BF16_ITERS = 2
SHARED_ITERS = (1, 2)  # DS and reconstruction, no regulariser
CLI_ITERS, CLI_SAVE, CLI_CHECK = 6, 3, 4  # run, checkpoint after, iteration compared on resume
CLI_SAMPLE = 2  # the CLI's val_sample_freq: grids after iterations 2 and 4
# The heatmap loss from the first iteration on; its gradient phase's batch.
HMAP_CONFIG = dict(hmap_loss_lambda=1.0, hmap_iter_thres=0)
HMAP_GRAD_BATCH = 8
FAN_BATCH = 16  # fakes (and as many renders) per G step
FAN_FLOAT64_BATCH = 2
EDIT_PHOTOS = 16  # photos per edit batch, each with 4 renders
# The 2-encoder forward's configurations: (co-modulation mode, modulation input).
TWO_ENC_CONFIGS = [(None, "Render Image"), (None, "Photo Image"), ("Multiplication", "Render Image"),
                   ("Concatenation", "Render Image"), ("Tensor Transform", "Render Image")]
TWO_ENC_MODE = "Tensor Transform"  # the 2-encoder trainer's mode
TWO_GRAD_BATCH = 8
TWO_TRAIN_ITERS = 6

# (C, R): blur input [N, C, 2R+1, 2R+1] after each upsampling transposed conv.
BLUR_SHAPES = [(512, 4), (512, 8), (512, 16), (512, 32), (256, 64), (128, 128)]
# R: ToRGB skip [N, 3, R, R] -> [N, 3, 2R, 2R].
UP2_SHAPES = [4, 8, 16, 32, 64, 128]
# (C, R, launches per forward): every StyledConv's output [N, C, R, R].
ACT_SHAPES = [(512, 4, 1), (512, 8, 2), (512, 16, 2), (512, 32, 2), (512, 64, 2),
              (256, 128, 2), (128, 256, 2)]
# (C, R, launches per D pass): every activation output of D at 256 px
# (from-RGB, each ResBlock's conv1 [C_in, R] and conv2 [C_out, R/2],
# final_conv, and final_linear.0 [N, 512], written R = 0).
D_ACT_SHAPES = [(128, 256, 2), (256, 128, 2), (512, 64, 2), (512, 32, 2), (512, 16, 2),
                (512, 8, 2), (512, 4, 2), (512, 0, 1)]
# D's downsampling blurs: ResBlock input [C_in, R], pads (2, 2) before the
# 3x3 conv and (1, 1) before the 1x1 skip.
D_BLUR_SHAPES = [(128, 256), (256, 128), (512, 64), (512, 32), (512, 16), (512, 8)]
# Passes in one training iteration without regulariser (reconstruction or
# DS): G runs forward in the D step and in the G step and backward once; D
# runs forward on the fake and the real batch in the D step and on the fake
# in the G step, and backward through each of the three.
G_FWD, G_BWD, D_FWD, D_BWD = 2, 1, 3, 3

KERNEL_INFO = {
    "blur": dict(
        route="cuda", source="fm3dgan_torch/ops/csrc/upfirdn2d.cu",
        replaces="fm3dgan/ops/pallas/upfirdn2d_kernel.py:183"),
    "upsample2x": dict(
        route="cuda", source="fm3dgan_torch/ops/csrc/upfirdn2d.cu",
        replaces="fm3dgan/ops/pallas/upfirdn2d_kernel.py:477"),
    "fused_leaky_relu": dict(
        route="cuda", source="fm3dgan_torch/ops/csrc/fused_act.cu",
        replaces="fm3dgan/ops/pallas/fused_act_kernel.py:48"),
    "fused_leaky_relu_bwd": dict(
        route="cuda", source="fm3dgan_torch/ops/csrc/fused_act.cu",
        replaces="fm3dgan/ops/pallas/fused_act_kernel.py:67"),
    "downsample2x": dict(
        route="cuda", source="fm3dgan_torch/ops/csrc/upfirdn2d.cu",
        replaces="fm3dgan/ops/pallas/upfirdn2d_kernel.py:477 (mode down2)"),
}
EXPECTED_LAUNCHES = {"blur": 6, "upsample2x": 6, "fused_leaky_relu": 13,
                     "fused_leaky_relu_bwd": 0, "downsample2x": 0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 30, warmup: int = 3):
    """(ms, host_us) per call: CUDA events around ``iters`` back-to-back
    eager calls, and the host's perf_counter over the same calls without a
    synchronize.  Where a call's host work is longer than its device work,
    the events time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host / iters * 1e6


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device ms per call: the same ``iters`` calls captured once in a CUDA
    graph, its replay timed with events (mean of ``replays`` after a warm
    replay), over ``iters``.  No host work is left in the replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def time_calls(kernel_fn, plain_fn, lib_fn, iters: int) -> dict:
    """kernel_ms, plain_ms and library_ms as events around eager calls (the
    measurement of every earlier run), with device_ms and host_us for the
    kernel and the library call (None where no library call exists)."""
    rec = {}
    rec["kernel_ms"], rec["host_us"] = cuda_ms(kernel_fn, iters=iters)
    rec["device_ms"] = graph_ms(kernel_fn, iters=iters)
    rec["plain_ms"] = cuda_ms(plain_fn, iters=iters)[0]
    if lib_fn is None:
        rec.update(library_ms=None, library_host_us=None, library_device_ms=None)
    else:
        rec["library_ms"], rec["library_host_us"] = cuda_ms(lib_fn, iters=iters)
        rec["library_device_ms"] = graph_ms(lib_fn, iters=iters)
    return rec


def bound(in_bytes: int, out_bytes: int, flops: int):
    t_mem = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def compare(got, ref32, dtype) -> dict:
    """fp32: atol 1e-5*max|ref|.  bf16: within rtol 8e-3 (one bf16 ulp, 2^-7,
    is 7.8e-3 at worst) of the fp32-accumulated reference, same atol."""
    diff = (got.float() - ref32).abs()
    scale = float(ref32.abs().max())
    atol = 1e-5 * scale
    rtol = 0.0 if dtype == torch.float32 else 8e-3
    ok = bool((diff <= atol + rtol * ref32.abs()).all())
    return dict(max_abs_diff=float(diff.max()), max_abs_ref=scale, atol=atol, rtol=rtol, ok=ok)


def kernel_phase(ops):
    """One record per (kernel, shape, dtype); raises on a mismatch."""
    records = []
    k2d = ops.make_kernel([1, 3, 3, 1]) * 4.0
    k1d = [0.25, 0.75, 0.75, 0.25]  # [1,3,3,1] / 8 * 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for c, r in BLUR_SHAPES:
            x = torch.randn(BATCH, c, 2 * r + 1, 2 * r + 1, device="cuda", generator=gen).to(dtype)
            got = ops.blur(x, k2d, (1, 1))
            ref32 = ops.blur_plain(x.float(), k2d, (1, 1))
            wlib = torch.flip(torch.as_tensor(k2d, device="cuda"), (0, 1)).expand(c, 1, 4, 4).to(dtype)
            lib = lambda: F.conv2d(x, wlib, padding=1, groups=c)  # noqa: E731
            rec = dict(kernel="blur", shape=list(x.shape), dtype=str(dtype).split(".")[1],
                       launches_per_forward=1, **compare(got, ref32, dtype))
            rec["library_max_abs_diff"] = float((lib().float() - ref32).abs().max())
            rec.update(time_calls(lambda: ops.blur(x, k2d, (1, 1)),
                                  lambda: ops.blur_plain(x, k2d, (1, 1)), lib, iters=30))
            rec["bound_ms"], rec["bound_by"] = bound(x.numel() * esize, got.numel() * esize,
                                                     got.numel() * 16 * 2)
            records.append(rec)
            emit(rec)
            require(rec["ok"], f"blur {rec['shape']} {dtype}: {rec['max_abs_diff']}")
        for r in UP2_SHAPES:
            x = torch.randn(BATCH, 3, r, r, device="cuda", generator=gen).to(dtype)
            got = ops.upsample2x(x, k1d, (2, 1))
            ref32 = ops.upsample2x_plain(x.float(), k1d, (2, 1))
            wlib = torch.outer(torch.tensor(k1d), torch.tensor(k1d)).to("cuda", dtype).expand(3, 1, 4, 4)
            lib = lambda: F.conv_transpose2d(x, wlib, stride=2, padding=1, groups=3)  # noqa: E731
            rec = dict(kernel="upsample2x", shape=list(x.shape), dtype=str(dtype).split(".")[1],
                       launches_per_forward=1, **compare(got, ref32, dtype))
            rec["library_max_abs_diff"] = float((lib().float() - ref32).abs().max())
            rec.update(time_calls(lambda: ops.upsample2x(x, k1d, (2, 1)),
                                  lambda: ops.upsample2x_plain(x, k1d, (2, 1)), lib, iters=30))
            rec["bound_ms"], rec["bound_by"] = bound(x.numel() * esize, got.numel() * esize,
                                                     got.numel() * 4 * 2)
            records.append(rec)
            emit(rec)
            require(rec["ok"], f"upsample2x {rec['shape']} {dtype}: {rec['max_abs_diff']}")
        for c, r, n_launch in ACT_SHAPES:
            x = torch.randn(BATCH, c, r, r, device="cuda", generator=gen).to(dtype)
            b = torch.randn(c, device="cuda", generator=gen)
            got = ops.fused_leaky_relu(x, b)
            ref32 = ops.fused_leaky_relu_plain(x.float(), b.to(dtype).float())
            rec = dict(kernel="fused_leaky_relu", shape=list(x.shape), dtype=str(dtype).split(".")[1],
                       launches_per_forward=n_launch, **compare(got, ref32, dtype))
            rec.update(time_calls(lambda: ops.fused_leaky_relu(x, b),
                                  lambda: ops.fused_leaky_relu_plain(x, b), None, iters=30))
            rec["bound_ms"], rec["bound_by"] = bound(x.numel() * esize + c * esize,
                                                     got.numel() * esize, got.numel() * 4)
            records.append(rec)
            emit(rec)
            require(rec["ok"], f"fused_leaky_relu {rec['shape']} {dtype}: {rec['max_abs_diff']}")
    return records


def _dtname(dtype) -> str:
    return str(dtype).split(".")[1]


def _training_record(kernel, x, dtype, weight, got, ref32, fns, in_bytes, out_bytes, flops):
    """Check one training-shape launch against its plain version and time
    the kernel, the plain version and the library call (None: no single
    PyTorch call computes the function).  ``weight``: the launches of this
    case in one training iteration without regulariser."""
    kernel_fn, plain_fn, lib_fn = fns
    rec = dict(kernel=kernel, what="training", shape=list(x.shape), dtype=_dtname(dtype),
               launches_per_iteration=weight, **compare(got, ref32, dtype))
    rec.update(time_calls(kernel_fn, plain_fn, lib_fn, iters=20))
    rec["bound_ms"], rec["bound_by"] = bound(in_bytes, out_bytes, flops)
    emit(rec)
    require(rec["ok"], f"{kernel} {rec['shape']} {dtype}: {rec['max_abs_diff']}")
    return rec


def training_kernel_phase(ops):
    """Every kernel at every shape one training iteration without
    regulariser gives it, batch 16: K1 and K2 at G's and D's activation
    shapes, K3 at G's up-blur, D's blurs and every blur adjoint, K4 at the
    ToRGB skip and K5 at its adjoint."""
    records = []
    k2d = ops.make_kernel([1, 3, 3, 1])
    k1d = [0.25, 0.75, 0.75, 0.25]
    kflip = k1d[::-1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    b = TRAIN_BATCH
    per_g = {(c, r): n for c, r, n in ACT_SHAPES}
    per_d = {(c, r): n for c, r, n in D_ACT_SHAPES}
    act_shapes = sorted(set(per_g) | set(per_d), key=lambda s: (-s[1], s[0]))
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for c, r in act_shapes:
            shape = (b, c, r, r) if r else (b, c)
            g, x = rnd(*shape).to(dtype), rnd(*shape).to(dtype)
            bias = rnd(c)
            out = ops.fused_leaky_relu(x, bias)
            n = g.numel()
            n_g, n_d = per_g.get((c, r), 0), per_d.get((c, r), 0)
            records.append(_training_record(
                "fused_leaky_relu", x, dtype, G_FWD * n_g + D_FWD * n_d, out,
                ops.fused_leaky_relu_plain(x.float(), bias.to(dtype).float()),
                (lambda: ops.fused_leaky_relu(x, bias),
                 lambda: ops.fused_leaky_relu_plain(x, bias), None),
                n * esize + c * esize, n * esize, 4 * n))
            records.append(_training_record(
                "fused_leaky_relu_bwd", g, dtype, G_BWD * n_g + D_BWD * n_d,
                ops.fused_leaky_relu_bwd(g, out), ops.fused_leaky_relu_bwd_plain(g.float(), out),
                (lambda: ops.fused_leaky_relu_bwd(g, out),
                 lambda: ops.fused_leaky_relu_bwd_plain(g, out), None),
                2 * n * esize, n * esize, n))
        for r in UP2_SHAPES:
            x = rnd(b, 3, r, r).to(dtype)  # the ToRGB skip: [b, 3, R, R] -> 2R
            got = ops.upsample2x(x, k1d, (2, 1))
            wlib = torch.outer(torch.tensor(k1d), torch.tensor(k1d)).to("cuda", dtype).expand(3, 1, 4, 4)
            records.append(_training_record(
                "upsample2x", x, dtype, G_FWD, got, ops.upsample2x_plain(x.float(), k1d, (2, 1)),
                (lambda: ops.upsample2x(x, k1d, (2, 1)),
                 lambda: ops.upsample2x_plain(x, k1d, (2, 1)),
                 lambda: F.conv_transpose2d(x, wlib, stride=2, padding=1, groups=3)),
                x.numel() * esize, got.numel() * esize, got.numel() * 4 * 2))
            x = rnd(b, 3, 2 * r, 2 * r).to(dtype)  # its adjoint: [b, 3, 2R, 2R] -> R
            got = ops.downsample2x(x, kflip, (1, 1))
            wlib = torch.flip(torch.outer(torch.tensor(kflip), torch.tensor(kflip)), (0, 1))
            wlib = wlib.to("cuda", dtype).expand(3, 1, 4, 4)
            records.append(_training_record(
                "downsample2x", x, dtype, G_BWD, got,
                ops.downsample2x_plain(x.float(), kflip, (1, 1)),
                (lambda: ops.downsample2x(x, kflip, (1, 1)),
                 lambda: ops.downsample2x_plain(x, kflip, (1, 1)),
                 lambda: F.conv2d(x, wlib, stride=2, padding=1, groups=3)),
                x.numel() * esize, got.numel() * esize, got.numel() * 16 * 2))
        blur_cases = []
        for c, r in D_BLUR_SHAPES:
            blur_cases += [((c, r), k2d, 2, D_FWD), ((c, r), k2d, 1, D_FWD),  # 3x3 conv, 1x1 skip
                           ((c, r + 1), k2d, 1, D_BWD), ((c, r - 1), k2d, 2, D_BWD)]  # adjoints
        for c, r in BLUR_SHAPES:
            blur_cases += [((c, 2 * r + 1), k2d * 4.0, 1, G_FWD),  # G's up-blur
                           ((c, 2 * r), k2d * 4.0, 2, G_BWD)]  # and its adjoint
        for (c, r), k, p, weight in blur_cases:
            x = rnd(b, c, r, r).to(dtype)
            got = ops.blur(x, k, (p, p))
            wlib = torch.flip(torch.as_tensor(k, device="cuda"), (0, 1)).expand(c, 1, 4, 4).to(dtype)
            records.append(_training_record(
                "blur", x, dtype, weight, got, ops.blur_plain(x.float(), k, (p, p)),
                (lambda: ops.blur(x, k, (p, p)), lambda: ops.blur_plain(x, k, (p, p)),
                 lambda: F.conv2d(x, wlib, padding=p, groups=c)),
                x.numel() * esize, got.numel() * esize, got.numel() * 16 * 2))
            records[-1]["pad"] = [p, p]
        del x, g, out
        torch.cuda.empty_cache()
    return records


def launches_per_iteration(records):
    """Per kernel, the launches one training iteration without regulariser
    makes by the weights above; the training phase checks them against its
    counts."""
    return {name: sum(r["launches_per_iteration"] for r in records
                      if r["kernel"] == name and r["dtype"] == "float32"
                      and "launches_per_iteration" in r)
            for name in KERNEL_INFO}


def _inputs(batch, size, seed):
    g = torch.Generator().manual_seed(seed)
    photo = torch.rand(batch, size, size, 3, generator=g) * 2 - 1
    render = torch.rand(batch, size, size, 3, generator=g) * 2 - 1
    return photo.cuda(), render.cuda()


def path_phase(ops, pipeline):
    FaceManipulator, forward_3_encoder = pipeline.FaceManipulator, pipeline.forward_3_encoder
    out = {}
    photo, render = _inputs(BATCH, 256, seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        models = FaceManipulator.create(size=256, input_size=256, dtype=dtype, device="cuda", seed=0)
        ops.reset_launches()
        image = forward_3_encoder(models, photo, render)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ops.reset_launches()
        with ops.plain_versions():
            ref = forward_3_encoder(models, photo, render)
        torch.cuda.synchronize()
        plain_counts = ops.launch_counts()
        require(not any(plain_counts.values()), f"{name} plain path launched {plain_counts}")
        diff = float((image.float() - ref.float()).abs().max())
        rec = dict(phase="path", dtype=name, batch=BATCH, shape=list(image.shape),
                   finite=bool(torch.isfinite(image).all()), launches=counts,
                   max_abs_diff_vs_plain=diff, max_abs_image=float(image.float().abs().max()))
        emit(rec)
        require(rec["finite"], f"{name} output is not finite")
        require(tuple(image.shape) == (BATCH, 256, 256, 3), f"{name} shape {tuple(image.shape)}")
        require(counts == EXPECTED_LAUNCHES, f"{name} launches {counts} != {EXPECTED_LAUNCHES}")
        if dtype == torch.float32:
            require(diff <= 1e-4, f"fp32 kernel path vs plain path: {diff}")
            out["launches"] = counts
            out["fp32_image"] = image
        else:
            rec_drift = float((image.float() - out["fp32_image"]).abs().max())
            emit(dict(phase="path", what="bf16 vs fp32 image", max_abs_diff=rec_drift))
        del models, image, ref
        torch.cuda.empty_cache()

    # A small configuration on the card against the plain path on the CPU.
    small = dict(size=16, input_size=128, width_mult=1 / 16, style_dim=32, seed=3)
    m_gpu = FaceManipulator.create(**small, device="cuda")
    m_cpu = FaceManipulator.create(**small, device="cpu")
    sp, sr = _inputs(2, 128, seed=2)
    got = forward_3_encoder(m_gpu, sp, sr).cpu()
    want = forward_3_encoder(m_cpu, sp.cpu(), sr.cpu())
    diff = float((got - want).abs().max())
    emit(dict(phase="small_config_cuda_vs_cpu", max_abs_diff=diff, tol=1e-4))
    require(diff <= 1e-4, f"small config cuda vs cpu: {diff}")

    # Throughput at batch 32 (host clock around synchronize, warmed up), the
    # kernel path and the plain path in turns: kernel, plain, plain, kernel.
    photo, render = _inputs(TIMED_BATCH, 256, seed=4)
    iters = 5

    def timed(models):
        t0 = time.perf_counter()
        for _ in range(iters):
            forward_3_encoder(models, photo, render)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    for dtype in (torch.float32, torch.bfloat16):
        models = FaceManipulator.create(size=256, input_size=256, dtype=dtype, device="cuda", seed=0)
        for _ in range(2):
            forward_3_encoder(models, photo, render)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            if which == "plain":
                with ops.plain_versions():
                    times[which].append(timed(models))
            else:
                times[which].append(timed(models))
        dt = sum(times["kernel"]) / 2
        dt_plain = sum(times["plain"]) / 2
        emit(dict(phase="timed_forward", dtype=str(dtype).split(".")[1], batch=TIMED_BATCH,
                  ms_per_forward=dt * 1e3, img_per_s=TIMED_BATCH / dt,
                  plain_ms_per_forward=dt_plain * 1e3, plain_img_per_s=TIMED_BATCH / dt_plain,
                  runs_ms={k: [t * 1e3 for t in v] for k, v in times.items()},
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated()))
        del models
        torch.cuda.empty_cache()
    return out


def _train_inputs(batch, seed, ds_flag=False):
    """Seeded uint8 NHWC batches at 256 px, paired as the JAX data path pairs
    them: the reference is the photo itself for reconstruction, the other
    photo of each pair for dual supervision.  The top quarter of each render
    is background (0 -> -1) so the face-regional mask has both values."""
    g = torch.Generator().manual_seed(seed)
    photo, render = (torch.randint(0, 256, (batch, 256, 256, 3), generator=g, dtype=torch.uint8)
                     for _ in range(2))
    render[:, :64] = 0
    swap = torch.arange(batch).reshape(-1, 2).flip(1).reshape(-1)
    return photo, render, photo[swap] if ds_flag else photo


def _max_rel(a, b, scale):
    return float((a - b).abs().max()) / scale


def hold_gradient(k, p, e, part_max):
    """The bar of one parameter tensor.  k, p: its float32 gradients through
    the kernels and through the plain versions; e: the exact (float64 plain)
    gradient; part_max: the largest exact gradient of its partition.

    A gradient that is zero in exact arithmetic (max|e| <= 1e-12 part_max)
    may only be float32 residue on both paths (<= 1e-6 part_max).  Else,
    with eps_p = max|p - e| / max|e| the plain path's own float32 error, the
    kernel path is within max(1e-4, eps_p) of the plain path and within
    eps_p + 1e-4 of the exact gradient, relative to max|e|: the 1e-4 bar,
    where the plain path itself is exact to 1e-4, and no two float32
    evaluations can be asked to agree better than each agrees with the
    exact value.  Returns (passes, relative differences)."""
    scale = float(e.abs().max())
    if scale <= 1e-12 * part_max:
        residue = max(float(k.abs().max()), float(p.abs().max())) / part_max
        return residue <= 1e-6, dict(residue=residue)
    rel = dict(kernel_vs_plain=_max_rel(k, p, scale), kernel_vs_exact=_max_rel(k, e, scale),
               plain_vs_exact=_max_rel(p, e, scale))
    eps_p = rel["plain_vs_exact"]
    ok = rel["kernel_vs_plain"] <= max(1e-4, eps_p) and rel["kernel_vs_exact"] <= eps_p + 1e-4
    return ok, rel


def gradient_phase(ops, train, trainer):
    """One G step (GAN + LPIPS + L1 + face-ID + face-regional, DS branch with
    D_edit) and one R1 step on the same state with fixed noise and cuDNN's
    deterministic algorithms, through the kernels and through the plain
    versions, forward and backward; the plain runs must launch no kernel.
    The plain run is made twice (the repeat must give the same gradients to
    the bit) and once more in float64 (``Trainer.float64_state``), the exact
    reference, whose losses must agree with the float32 ones within 1e-4.
    Every parameter tensor must pass :func:`hold_gradient`.  With LPIPS and
    ArcFace in the loss, G's noise-weight gradients are sums whose terms
    are up to 264 times larger than they are (PERF.md): float32
    rounding anywhere upstream moves them by up to 8.4e-3, so there only
    kernels that round as their plain versions do pass the bar."""
    steps, st, cfg = train.steps, trainer.state, trainer.config
    photo, render, ref = (steps.prepare_batch(a, "cuda")
                          for a in _train_inputs(GRAD_BATCH, 11, ds_flag=True))

    def run(state, photo, render, ref):
        g, g_losses = steps.g_step_grads(state, cfg, photo, render, ref, use_edit=True,
                                         ds_flag=True, extreme_ds_flag=False)
        r1, r1_losses = steps.d_reg_step_grads(state, cfg, ref, use_edit=False)
        losses = {k: float(v) for k, v in {**g_losses, **r1_losses}.items()}
        return {"g_step": g, "r1": r1}, losses

    rec = _hold_gradients(ops, trainer, run, (photo, render, ref), "gradients", GRAD_BATCH)
    require(rec["losses"]["lpips"] > 0 and rec["losses"]["face_id"] > 0,
            f"the G step ran without its loss networks: {rec['losses']}")
    return rec


def _hold_gradients(ops, trainer, run, inputs, phase, batch):
    """``run(state, *inputs) -> ({step: {part: {name: grad}}}, losses)``
    with cuDNN's deterministic algorithms through the kernels, then under
    ``plain_versions()`` twice and once in float64 (``trainer.float64_state``):
    the plain runs launch no kernel, the plain repeat equals the plain run to
    the bit, the float64 losses agree with the float32 ones within 1e-4 and
    every parameter tensor passes :func:`hold_gradient`."""
    st = trainer.state
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    got, got_losses = run(st, *inputs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ops.reset_launches()
    with ops.plain_versions():
        want, _ = run(st, *inputs)
        again, _ = run(st, *inputs)
        state64 = trainer.float64_state()
        exact, exact_losses = run(state64, *(x.double() for x in inputs))
    torch.cuda.synchronize()
    plain_counts = ops.launch_counts()
    del state64
    torch.backends.cudnn.deterministic = False
    require(not any(plain_counts.values()), f"{phase} plain runs launched {plain_counts}")
    # The float64 run computes the same function: its losses agree with the
    # float32 ones to float32 rounding.
    loss_rel = {k: abs(got_losses[k] - v) / max(abs(v), 1e-30) for k, v in exact_losses.items()
                if v != 0.0}
    require(all(v <= 1e-4 for v in loss_rel.values()), f"float64 losses differ: {loss_rel}")
    keys = ("kernel_vs_plain", "kernel_vs_exact", "plain_vs_exact")
    worst = {k: {g: (0.0, "") for g in ("g_and_d", "encoders")} for k in keys}
    n, zero, plain_off, repeat_differs, over, fails = 0, 0, 0, [], [], []
    for step, parts in exact.items():
        for part, tensors in parts.items():
            group = "g_and_d" if part in ("g", "d", "d_edit", "d_ffhq") else "encoders"
            part_max = max(float(e.abs().max()) for e in tensors.values())
            for name, e in tensors.items():
                n += 1
                what = f"{step} {part}.{name}"
                k, p = got[step][part][name], want[step][part][name]
                if not torch.equal(again[step][part][name], p):
                    repeat_differs.append(what)
                ok, rel = hold_gradient(k, p, e, part_max)
                if not ok:
                    fails.append((what, rel))
                if "residue" in rel:
                    zero += 1
                    continue
                for key in keys:
                    if rel[key] > worst[key][group][0]:
                        worst[key][group] = (rel[key], what)
                plain_off += rel["plain_vs_exact"] > 1e-4
                if rel["kernel_vs_plain"] > 1e-4:
                    over.append((what, rel))
    rec = dict(phase=phase, batch=batch, dtype="float32", tensors=n,
               zero_in_exact_arithmetic=zero, worst_rel_diff=worst,
               plain_over_1e4_from_exact=plain_off,
               kernel_vs_plain_over_1e4=over, plain_repeat_differs=repeat_differs,
               losses=got_losses, loss_rel_diff_vs_exact=loss_rel,
               launches=counts, plain_launches=plain_counts,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    emit(rec)
    require(not repeat_differs, f"the plain path does not reproduce itself: {repeat_differs}")
    require(not fails, f"gradients outside their bar: {fails}")
    require(all(v > 0 for v in counts.values()), f"{phase} launches {counts}")
    return rec


def hmap_gradient_phase(ops, train, trainer):
    """One G step with the FAN heatmap term (DS branch with D_edit, LPIPS,
    ArcFace, batch ``HMAP_GRAD_BATCH``), held as the gradient phase holds
    the G step (:func:`_hold_gradients`); the heatmap loss must be finite
    and positive."""
    steps, cfg = train.steps, trainer.config
    photo, render, ref = (steps.prepare_batch(a, "cuda")
                          for a in _train_inputs(HMAP_GRAD_BATCH, 12, ds_flag=True))

    def run(state, photo, render, ref):
        g, losses = steps.g_step_grads(state, cfg, photo, render, ref, use_edit=True,
                                       ds_flag=True, extreme_ds_flag=False, apply_hmap=True)
        return {"g_step": g}, {k: float(v) for k, v in losses.items()}

    rec = _hold_gradients(ops, trainer, run, (photo, render, ref), "hmap_gradients",
                          HMAP_GRAD_BATCH)
    require(math.isfinite(rec["losses"]["hmap"]) and rec["losses"]["hmap"] > 0,
            f"the heatmap term did not fire: {rec['losses']}")
    return rec


def _snapshot(st):
    mods = {"d": st.d, "d_edit": st.d_edit, "g": st.models.generator, "e_tsr": st.models.e_tsr,
            "e_w": st.models.e_w, "e_w_plus": st.models.e_w_plus, "g_ema": st.g_ema}
    snap = {k: {n: p.detach().clone() for n, p in m.named_parameters()} for k, m in mods.items()}
    snap["bn_stats"] = {f"{k}.{n}": b.detach().clone() for k in ("e_tsr", "e_w", "e_w_plus")
                        for n, b in mods[k].named_buffers() if n.endswith(("running_mean", "running_var"))}
    return snap


def _branch(trainer, i) -> str:
    cfg = trainer.config
    name = ("extreme_ds" if cfg.is_extreme_ds_iter(i) else "ds") if cfg.is_ds_iter(i) else "reconstruction"
    regs = [r for r, due in (("r1", i % cfg.d_reg_every == 0), ("ppl", i % cfg.g_reg_every == 0)) if due]
    return "+".join([name, *regs])


ALLOCATOR_COUNTS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _allocator_counts():
    """cudaMalloc and cudaFree calls of the caching allocator so far, and
    its retries after freeing its cache (each of which synchronizes)."""
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ALLOCATOR_COUNTS}


def training_phase(ops, train, trainer, iterations, dtype_name, per_iteration,
                   check_state=False):
    """``Trainer.train_iteration`` on ``iterations``; returns the launches of
    the whole run, the ms of each iteration and its losses.  Each iteration without
    regulariser must launch each kernel as often as ``per_iteration`` says;
    with ``check_state`` every partition, g_ema and the BatchNorm statistics
    must have moved, the PPL mean be positive and every kernel have run."""
    st = trainer.state
    before = _snapshot(st) if check_state else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ms_by_iteration, losses_by_iteration = {}, {}
    for i in iterations:
        photo, render, ref = _train_inputs(TRAIN_BATCH, 100 + i, trainer.config.is_ds_iter(i))
        before_i = ops.launch_counts()
        alloc_before = _allocator_counts()
        t0 = time.perf_counter()
        m = trainer.train_iteration(i, photo, render, ref)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        alloc = {k: v - alloc_before[k] for k, v in _allocator_counts().items()}
        counts = {k: v - before_i[k] for k, v in ops.launch_counts().items()}
        losses = {k: float(v) for k, v in m.items() if torch.is_tensor(v)}
        ms_by_iteration[i] = ms
        losses_by_iteration[i] = losses
        rec = dict(phase="train", dtype=dtype_name, iteration=i, batch=TRAIN_BATCH,
                   share_dg_noise=trainer.config.share_dg_noise, branch=_branch(trainer, i),
                   ds_flag=m["ds_flag"], extreme_ds_flag=m["extreme_ds_flag"],
                   use_edit=bool(m["ds_flag"] and trainer.config.use_separate_d),
                   r1_step=i % trainer.config.d_reg_every == 0,
                   ppl_step=i % trainer.config.g_reg_every == 0,
                   losses=losses, ms=ms, launches=counts, allocator=alloc)
        emit(rec)
        require(all(math.isfinite(v) for v in losses.values()), f"{dtype_name} iteration {i}: {losses}")
        if not (rec["r1_step"] or rec["ppl_step"]):
            require(counts == per_iteration, f"{dtype_name} iteration {i}: launches {counts} "
                                             f"!= {per_iteration} by the kernel phase's weights")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if before is not None:
        after = _snapshot(st)
        for part in before:
            moved = any(not torch.equal(before[part][n], after[part][n]) for n in before[part])
            require(moved, f"training did not change {part}")
        require(float(st.mean_path_length) > 0, f"mean_path_length {float(st.mean_path_length)}")
        require(all(v > 0 for v in launches.values()), f"training launches {launches}")
    emit(dict(phase="train_summary", dtype=dtype_name, share_dg_noise=trainer.config.share_dg_noise,
              iterations=list(iterations), batch=TRAIN_BATCH, launches=launches,
              ms_by_branch={_branch(trainer, i): ms for i, ms in ms_by_iteration.items()},
              max_memory_allocated_bytes=peak, mean_path_length=float(st.mean_path_length)))
    return launches, ms_by_iteration, losses_by_iteration


def loss_net_phase(trainer, iteration_ms):
    """Device ms of the frozen loss networks in one G step at its shapes
    (batch 16, 256 px, float32): the LPIPS distance of the generated batch
    to the reference and the face-ID loss against it, each forward alone
    (no graph) and forward plus the input gradient the G step takes; CUDA
    events around 5 calls after 2 warm-up calls.  ``iteration_ms``: the ms
    of the reconstruction and DS iterations without regulariser, for their
    share."""
    from fm3dgan_torch.losses import face_identity_loss

    st, cfg = trainer.state, trainer.config
    g = torch.Generator(device="cuda").manual_seed(21)
    fake = (torch.rand(TRAIN_BATCH, 3, 256, 256, device="cuda", generator=g) * 2 - 1).requires_grad_(True)
    ref = torch.rand(TRAIN_BATCH, 3, 256, 256, device="cuda", generator=g) * 2 - 1
    fns = {
        "lpips": lambda: st.lpips(fake, ref).mean(),
        "arcface": lambda: face_identity_loss(fake, ref, st.arcface, cfg.face_id_loss_type),
    }
    rec = dict(phase="loss_nets", batch=TRAIN_BATCH, dtype=cfg.compute_dtype)
    for name, fn in fns.items():
        with torch.no_grad():
            rec[f"{name}_forward_ms"] = cuda_ms(fn, iters=5, warmup=2)[0]
        rec[f"{name}_forward_and_input_grad_ms"] = cuda_ms(
            lambda: torch.autograd.grad(fn(), fake), iters=5, warmup=2)[0]
    total = rec["lpips_forward_and_input_grad_ms"] + rec["arcface_forward_and_input_grad_ms"]
    mean_ms = sum(iteration_ms) / len(iteration_ms)
    rec.update(per_g_step_ms=total, iteration_ms_mean=mean_ms, share_of_iteration=total / mean_ms)
    emit(rec)
    require(all(math.isfinite(v) and v > 0 for v in rec.values() if isinstance(v, float)),
            f"loss network timing {rec}")
    return rec


def cli_phase(ops):
    """The training CLI as a user starts it (its ``main``): fake data, full
    width, 256 px, a checkpoint after iteration ``CLI_SAVE``; then a second
    run resumed from that checkpoint, whose iteration ``CLI_CHECK`` must give
    the D and G losses of the uninterrupted run within 1e-5 relative (only
    the PPL subset's host RNG is not checkpointed, as in the JAX CLI).
    Both runs take cuDNN's deterministic algorithms.  With the default ones
    the convolutions may add in another order from one run to the next:
    iteration ``CLI_CHECK``'s D loss moved by up to 5.5e-7 relative, and
    Adam, which divides each gradient by its root mean square, carried the
    rounding of that iteration's D update into its G loss by 1.25e-5.  That
    would hide what the comparison is for: whether the checkpoint holds the
    whole training state.  The runs also train with the heatmap loss, write
    a sample grid every ``CLI_SAMPLE`` iterations and score the EMA model
    at the checkpoint (FID against statistics written here), all of which
    the uninterrupted run must show."""

    import numpy as np

    from fm3dgan_torch.eval.fid import save_stats
    from fm3dgan_torch.tools import train_3_encoder as cli

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stats = os.path.join(root, "real_stats.pkl")
    save_stats(stats, np.zeros(2048), np.eye(2048))
    first, resumed = os.path.join(root, "run"), os.path.join(root, "resumed")
    args = ["--fake_data", "--training_iters", str(CLI_ITERS), "--model_save_freq", str(CLI_SAVE),
            "--log_every", "1", "--val_sample_freq", str(CLI_SAMPLE), "--fid_stats_path", stats,
            "--hmap_loss_lambda", str(HMAP_CONFIG["hmap_loss_lambda"]),
            "--hmap_iter_thres", str(HMAP_CONFIG["hmap_iter_thres"])]
    rec = dict(phase="cli", cudnn_deterministic=True)
    torch.backends.cudnn.deterministic = True
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(args + ["--exp_dir", first])
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
        rec["launches"] = ops.launch_counts()
        require(rc == 0, f"the CLI exited {rc}")
        ckpt = os.path.join(first, "ckpt")
        require(sorted(os.listdir(ckpt)) == [f"{CLI_SAVE:06d}.json", f"{CLI_SAVE:06d}.pt"],
                f"checkpoints {os.listdir(ckpt)}")
        rec["checkpoint_bytes"] = os.path.getsize(os.path.join(ckpt, f"{CLI_SAVE:06d}.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc = cli.main(args + ["--exp_dir", resumed, "--resume_dir", ckpt,
                              "--resume_step", str(CLI_SAVE)])
        torch.cuda.synchronize()
        rec["resumed_run_s"] = time.perf_counter() - t0
        require(rc == 0, f"the resumed CLI exited {rc}")
        logs, evals = {}, []
        for name, exp in (("run", first), ("resumed", resumed)):
            with open(os.path.join(exp, "training_log.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            logs[name] = {line["iter"]: line for line in lines if "iter" in line}
            evals += [line["eval"] for line in lines if name == "run" and "eval" in line]
        rec["samples"] = sorted(os.listdir(os.path.join(first, "sample")))
        rec["eval"] = evals
        rec["hmap"] = {i: line["hmap"] for i, line in logs["run"].items()}
        require(rec["samples"] == [f"{i:06d}.png" for i in range(CLI_SAMPLE, CLI_ITERS, CLI_SAMPLE)],
                f"sample grids {rec['samples']}")
        require(len(evals) == 1 and evals[0]["eval_step"] == CLI_SAVE
                and all(math.isfinite(v) for k, v in evals[0].items()
                        if k not in ("edit_hmap", "edit_landmark")),
                f"eval lines {evals}")
        # hmap_iter_thres 0: the term fires from iteration 1 on (strictly past it).
        require(rec["hmap"][0] == 0.0 and all(math.isfinite(h) and h > 0
                                              for i, h in rec["hmap"].items() if i > 0),
                f"heatmap loss {rec['hmap']}")
        require(sorted(logs["run"]) == list(range(CLI_ITERS)), f"iterations {sorted(logs['run'])}")
        require(sorted(logs["resumed"]) == list(range(CLI_SAVE + 1, CLI_ITERS)),
                f"resumed iterations {sorted(logs['resumed'])}")
        for line in logs["run"].values():
            require(all(math.isfinite(v) for v in line.values() if isinstance(v, float)),
                    f"CLI iteration {line}")
        a, b = logs["run"][CLI_CHECK], logs["resumed"][CLI_CHECK]
        rec["resume_rel_diff"] = {k: abs(a[k] - b[k]) / max(abs(a[k]), 1e-30) for k in ("d", "g")}
        rec["time_s"] = {i: line["time_s"] for i, line in logs["run"].items()}
        emit(rec)
        require(all(v > 0 for v in rec["launches"].values()), f"CLI launches {rec['launches']}")
        require(all(v <= 1e-5 for v in rec["resume_rel_diff"].values()),
                f"resumed iteration {CLI_CHECK} differs: {rec['resume_rel_diff']}")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    return rec


def fan_phase(train, trainer):
    """FAN at the G step's shapes (``FAN_BATCH`` fakes and as many renders,
    256 px, the trainer's FAN weights): the forward of both batches, and the
    heatmap loss's forward plus its input gradient, in float32 and bfloat16,
    ms by CUDA events around 5 calls after 2; peak memory of the float32
    gradient; the G step's gradients without and with the heatmap term; and
    the float32 heatmaps of ``FAN_FLOAT64_BATCH`` images against a float64
    run of the same weights, within 1e-4 of the largest (the module bar)."""
    from fm3dgan_torch.losses import heat_map_loss
    from fm3dgan_torch.models.fan_landmark import FAN, fan_heatmap_fn

    fan32, size = trainer.state.fan, trainer.fan_input_size
    g = torch.Generator(device="cuda").manual_seed(31)
    px = trainer.input_size
    fake = (torch.rand(FAN_BATCH, 3, px, px, device="cuda", generator=g) * 2 - 1).requires_grad_(True)
    render = torch.rand(FAN_BATCH, 3, px, px, device="cuda", generator=g) * 2 - 1
    both = torch.cat([fake.detach(), render])

    def copy_of(dtype):
        net = FAN(dtype=dtype)
        net.load_state_dict(fan32.state_dict())
        return net.requires_grad_(False).eval().cuda()

    rec = dict(phase="fan", batch=FAN_BATCH, input_size=size)
    for dtype, net in ((torch.float32, fan32), (torch.bfloat16, copy_of(torch.bfloat16))):
        name = _dtname(dtype)
        hf = fan_heatmap_fn(net, size)
        with torch.no_grad():
            rec[f"{name}_forward_ms"] = cuda_ms(lambda: hf(both), iters=5, warmup=2)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec[f"{name}_forward_and_input_grad_ms"] = cuda_ms(
            lambda: torch.autograd.grad(heat_map_loss(fake, render, hf), fake), iters=5, warmup=2)[0]
        rec[f"{name}_max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        del net, hf
    x = both[:FAN_FLOAT64_BATCH]
    with torch.no_grad():
        y32 = fan_heatmap_fn(fan32, size)(x)
        y64 = fan_heatmap_fn(copy_of(torch.float64), size)(x.double())
    # The G step (DS, D_edit, LPIPS, ArcFace) without and with the heatmap
    # term, in turns: what the term adds where the iteration runs it.
    steps, st, cfg = train.steps, trainer.state, trainer.config
    inputs = [steps.prepare_batch(a, "cuda") for a in _train_inputs(FAN_BATCH, 13, ds_flag=True)]
    runs = {False: [], True: []}
    for apply_hmap in (False, True, True, False):
        runs[apply_hmap].append(cuda_ms(lambda: steps.g_step_grads(
            st, cfg, *inputs, True, True, False, apply_hmap=apply_hmap), iters=2, warmup=1)[0])
    rec["g_step_ms"] = {"without_hmap": runs[False], "with_hmap": runs[True]}
    del inputs
    rec["float64_batch"] = FAN_FLOAT64_BATCH
    rec["max_rel_diff_vs_float64"] = float((y32.double() - y64).abs().max() / y64.abs().max())
    rec["max_abs_heatmap"] = float(y64.abs().max())
    rec["bar"] = 1e-4
    emit(rec)
    times = [v for k, v in rec.items() if k.endswith("_ms") and k != "g_step_ms"]
    times += rec["g_step_ms"]["without_hmap"] + rec["g_step_ms"]["with_hmap"]
    require(all(math.isfinite(v) and v > 0 for v in times), f"FAN timing {rec}")
    require(rec["max_rel_diff_vs_float64"] <= rec["bar"], f"FAN float32 vs float64: {rec}")
    return rec


def _numpy_batch(g, n, px, background=False):
    """[n, px, px, 3] float32 numpy in [-1, 1]; a render's top quarter is
    background (-1)."""
    x = torch.rand(n, px, px, 3, generator=g) * 2 - 1
    if background:
        x[:, :px // 4] = -1.0
    return x.numpy()


def eval_phase(ops, trainer):
    """``QuantEvalHook`` on a float32 trainer at 256 px with LPIPS, ArcFace,
    a seeded random InceptionV3 and the trainer's FAN as the heatmap scorer:
    one reconstruction batch of ``quant_eval_batch_size`` and one edit batch
    of ``EDIT_PHOTOS`` photos x 4 renders, FID against real statistics of
    mean 0 and identity covariance.  A timed pass with cuDNN's default
    algorithms (launches: only the forward kernels K1, K3 and K4), after the
    kernel path and the plain path under the deterministic ones: each score
    within 1e-4 of the plain path's, relative (FID 1e-3: the square root of
    a singular product), plus 1e-6.  Also the pass without FID (its host
    ``sqrtm``), the EMA forward's img/s, InceptionV3's ms on the edit batch,
    and a ``get_val_sample_grid`` grid from both paths, equal within 1 in
    uint8."""
    import numpy as np

    from fm3dgan_torch.eval.visual_eval import get_val_sample_grid
    from fm3dgan_torch.models.fan_landmark import fan_heatmap_landmark_fn
    from fm3dgan_torch.models.inception import InceptionV3Pool3
    from fm3dgan_torch.train.eval_hook import QuantEvalHook, ema_forward_fn

    cfg, px = trainer.config, trainer.input_size
    g = torch.Generator().manual_seed(41)
    n_rec = cfg.quant_eval_batch_size
    recon = [(_numpy_batch(g, n_rec, px), _numpy_batch(g, n_rec, px, background=True))]
    edit = [[_numpy_batch(g, EDIT_PHOTOS, px)] + [_numpy_batch(g, EDIT_PHOTOS, px, background=True)
                                                for _ in range(4)]]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        inception = InceptionV3Pool3().requires_grad_(False).eval().cuda()
    hook = QuantEvalHook(trainer, lambda: recon, lambda: edit, inception_fn=inception,
                         real_stats=(np.zeros(2048), np.eye(2048)),
                         heatmap_landmark_fn=fan_heatmap_landmark_fn(trainer.state.fan,
                                                                     trainer.fan_input_size))
    rec = dict(phase="eval", recon_images=n_rec, edit_images=4 * EDIT_PHOTOS, size=px)
    torch.backends.cudnn.deterministic = True
    try:
        kernel = hook(0)  # also the warm-up of the timed pass
        ops.reset_launches()
        with ops.plain_versions():
            plain = hook(0)
            rec["plain_launches"] = ops.launch_counts()
        val_sets = [_numpy_batch(g, 1, px) for _ in range(6)]
        grid = get_val_sample_grid(ema_forward_fn(trainer), val_sets)
        with ops.plain_versions():
            grid_plain = get_val_sample_grid(ema_forward_fn(trainer), val_sets)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rec["scores"] = hook(1)
    torch.cuda.synchronize()
    rec["pass_s"] = time.perf_counter() - t0
    rec["launches"] = ops.launch_counts()
    real_stats, hook.real_stats = hook.real_stats, None  # the same pass without FID
    t0 = time.perf_counter()
    hook(1)
    torch.cuda.synchronize()
    rec["pass_without_fid_s"] = time.perf_counter() - t0
    hook.real_stats = real_stats
    rec["kernel_scores"], rec["plain_scores"] = kernel, plain
    rec["score_rel_diff"] = {k: abs(v - plain[k]) / max(abs(plain[k]), 1e-30)
                             for k, v in kernel.items() if k != "eval_step"}
    bars = {k: (1e-3 if k == "edit_fid" else 1e-4) for k in rec["score_rel_diff"]}
    rec["grid_max_uint8_diff"] = int(np.abs(grid.astype(np.int16) - grid_plain).max())
    fwd = ema_forward_fn(trainer)
    photo, render = (torch.from_numpy(a).cuda() for a in recon[0])
    with torch.no_grad():
        ms = cuda_ms(lambda: fwd(photo, render), iters=3, warmup=1)[0]
        rec["ema_forward_img_per_s"] = n_rec / ms * 1e3
        x = torch.from_numpy(np.concatenate(edit[0][1:])).cuda().permute(0, 3, 1, 2)
        rec["inception_ms"] = cuda_ms(lambda: inception(x), iters=3, warmup=1)[0]
    emit(rec)
    counts = rec["launches"]
    require(all(math.isfinite(v) for k, v in rec["scores"].items()), f"eval scores {rec['scores']}")
    require(all(counts[k] > 0 for k in ("blur", "upsample2x", "fused_leaky_relu"))
            and counts["fused_leaky_relu_bwd"] == 0 and counts["downsample2x"] == 0,
            f"eval pass launches {counts}")
    require(not any(rec["plain_launches"].values()), f"plain eval launched {rec['plain_launches']}")
    require(all(abs(kernel[k] - plain[k]) <= bars[k] * abs(plain[k]) + 1e-6 for k in bars),
            f"eval scores, kernel vs plain path: {rec['score_rel_diff']}")
    require(rec["grid_max_uint8_diff"] <= 1, f"grid kernel vs plain: {rec['grid_max_uint8_diff']}")
    return rec


# ---------------- the 2-encoder scheme ----------------------------------------


def two_encoder_path_phase(ops, pipeline):
    """``forward_2_encoder`` at batch 8, 256 px, float32, full width, in each
    configuration through the kernels and through the plain versions, then
    the Tensor Transform forward's throughput at batch 32 (kernel, plain,
    plain, kernel)."""
    photo, render = _inputs(BATCH, 256, seed=51)
    out = {}
    models = None
    for co_mod, mod_encode in TWO_ENC_CONFIGS:
        if models is None or models.co_modulation != co_mod:
            del models
            torch.cuda.empty_cache()
            models = pipeline.TwoEncoderModels.create(size=256, co_modulation=co_mod, device="cuda",
                                                      seed=0)
        run = lambda: pipeline.forward_2_encoder(models, photo, render, mod_encode=mod_encode)  # noqa: E731
        ops.reset_launches()
        image = run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ops.reset_launches()
        with ops.plain_versions():
            ref = run()
        torch.cuda.synchronize()
        plain_counts = ops.launch_counts()
        name = f"{co_mod or 'none'} / {mod_encode}"
        diff = float((image - ref).abs().max())
        rec = dict(phase="two_encoder_path", config=name, batch=BATCH, shape=list(image.shape),
                   style_dim=models.generator.style_dim, finite=bool(torch.isfinite(image).all()),
                   launches=counts, plain_launches=plain_counts, max_abs_diff_vs_plain=diff,
                   max_abs_image=float(image.abs().max()), tol=1e-4)
        emit(rec)
        out[name] = rec
        require(rec["finite"], f"2-encoder {name}: output is not finite")
        require(tuple(image.shape) == (BATCH, 256, 256, 3), f"2-encoder {name}: shape {image.shape}")
        require(diff <= 1e-4, f"2-encoder {name}: kernel path vs plain path {diff}")
        require(counts == EXPECTED_LAUNCHES, f"2-encoder {name}: launches {counts}")
        require(not any(plain_counts.values()), f"2-encoder {name}: plain path launched {plain_counts}")
        del image, ref

    # models now holds the Tensor Transform configuration.
    photo, render = _inputs(TIMED_BATCH, 256, seed=52)
    iters = 5

    def timed():
        t0 = time.perf_counter()
        for _ in range(iters):
            pipeline.forward_2_encoder(models, photo, render)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    for _ in range(2):
        pipeline.forward_2_encoder(models, photo, render)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        if which == "plain":
            with ops.plain_versions():
                times[which].append(timed())
        else:
            times[which].append(timed())
    dt, dt_plain = sum(times["kernel"]) / 2, sum(times["plain"]) / 2
    emit(dict(phase="two_encoder_timed_forward", config=TWO_ENC_MODE, dtype="float32",
              batch=TIMED_BATCH, ms_per_forward=dt * 1e3, img_per_s=TIMED_BATCH / dt,
              plain_ms_per_forward=dt_plain * 1e3, plain_img_per_s=TIMED_BATCH / dt_plain,
              runs_ms={k: [t * 1e3 for t in v] for k, v in times.items()},
              max_memory_allocated_bytes=torch.cuda.max_memory_allocated()))
    del models
    torch.cuda.empty_cache()
    return out


def _two_encoder_inputs(batch, seed):
    """Seeded uint8 NHWC batches at 256 px: photos, renders (top quarter
    background) and FFHQ reals."""
    g = torch.Generator().manual_seed(seed)
    photo, render, ffhq = (torch.randint(0, 256, (batch, 256, 256, 3), generator=g, dtype=torch.uint8)
                           for _ in range(3))
    render[:, :64] = 0
    return photo, render, ffhq


def two_encoder_gradient_phase(ops, train, trainer):
    """The G step (DS branch: GAN, LPIPS, L1, face-ID, face-regional), the
    FFHQ step's G update (against D_ffhq, face-ID to the photo) and a PPL
    step (fixed PPL image, half the batch) on the Tensor Transform state,
    fixed noise, held as the gradient phase holds the 3-encoder steps
    (:func:`_hold_gradients`)."""
    steps, steps2, cfg = train.steps, train.steps_2encoder, trainer.config
    enc = trainer.mod_encode
    photo, render, ffhq = (steps.prepare_batch(a, "cuda")
                           for a in _two_encoder_inputs(TWO_GRAD_BATCH, 61))
    ref = photo.flip(0)  # another photo of the batch
    g = torch.Generator(device="cuda").manual_seed(62)
    half = TWO_GRAD_BATCH // 2
    ppl = torch.randn(half, 3, 256, 256, device="cuda", generator=g) / 256

    def run(state, photo, render, ref, ffhq, ppl):
        g_step, losses = steps2.g_step_grads(state, cfg, photo, render, ref, enc, ds_flag=True)
        g_ffhq, ffhq_losses, _ = steps2.g_ffhq_ds_step_grads(state, cfg, photo, render, photo, enc)
        g_reg, _, ppl_m = steps2.g_reg_step_grads(state, cfg, photo[:half], render[:half], enc,
                                                  ppl_noise=ppl)
        losses = {**losses, **ffhq_losses, "g_reg": ppl_m["g_reg"]}
        return ({"g_step": g_step, "g_ffhq_ds_step": g_ffhq, "g_reg_step": g_reg},
                {k: float(v) for k, v in losses.items()})

    rec = _hold_gradients(ops, trainer, run, (photo, render, ref, ffhq, ppl),
                          "two_encoder_gradients", TWO_GRAD_BATCH)
    require(all(rec["losses"][k] > 0 for k in ("lpips", "face_id", "face_reg", "face_id_ffhq")),
            f"the 2-encoder G steps ran without their loss terms: {rec['losses']}")
    return rec


def _two_encoder_branch(trainer, i) -> str:
    cfg = trainer.config
    name = ("ffhq_ds" if trainer.ds_dataset_type == "FFHQ" else "ds") if cfg.is_ds_iter(i) \
        else "reconstruction"
    regs = [r for r, due in (("r1", i % cfg.d_reg_every == 0), ("ppl", i % cfg.g_reg_every == 0))
            if due]
    return "+".join([name, *regs])


def two_encoder_train_phase(ops, trainer, per_iteration):
    """``Trainer2.train_iteration`` on iterations 0-5 at batch 16 (uint8,
    256 px; the reference is the photo, and on FFHQ iterations the FFHQ
    reals a third batch); ms, losses, launches and allocator counts per
    iteration.  Every loss finite; G, both encoders, D, D_ffhq and g_ema
    moved; every kernel launched; an iteration without regulariser launches
    ``per_iteration`` (the 3-encoder weights: G and D have the same layers),
    an FFHQ one twice that (the FFHQ steps run G forward twice, G backward
    once, D_ffhq forward three times and backward three times: another
    iteration's worth)."""
    st = trainer.state
    mods = {"g": st.models.generator, "tensor_encoder": st.models.tensor_encoder,
            "modulation_encoder": st.models.modulation_encoder, "d": st.d, "d_ffhq": st.d_ffhq,
            "g_ema": st.g_ema}
    before = {k: [p.detach().clone() for p in m.parameters()] for k, m in mods.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ms_by_branch, launches_by_branch = {}, {}
    for i in range(TWO_TRAIN_ITERS):
        photo, render, ffhq = _two_encoder_inputs(TRAIN_BATCH, 200 + i)
        before_i = ops.launch_counts()
        alloc_before = _allocator_counts()
        t0 = time.perf_counter()
        m = trainer.train_iteration(i, photo, render, photo, ffhq_ref=ffhq)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v - before_i[k] for k, v in ops.launch_counts().items()}
        losses = {k: float(v) for k, v in m.items() if torch.is_tensor(v)}
        branch = _two_encoder_branch(trainer, i)
        ms_by_branch[f"{i}:{branch}"] = ms
        launches_by_branch[f"{i}:{branch}"] = counts
        emit(dict(phase="two_encoder_train", iteration=i, batch=TRAIN_BATCH, branch=branch,
                  co_modulation=trainer.co_modulation, losses=losses, ms=ms, launches=counts,
                  allocator={k: v - alloc_before[k] for k, v in _allocator_counts().items()}))
        require(all(math.isfinite(v) for v in losses.values()), f"2-encoder iteration {i}: {losses}")
        if "+" not in branch:
            want = {k: v * (2 if branch == "ffhq_ds" else 1) for k, v in per_iteration.items()}
            require(counts == want, f"2-encoder iteration {i} ({branch}): launches {counts} != {want}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    rec = dict(phase="two_encoder_train_summary", iterations=TWO_TRAIN_ITERS, batch=TRAIN_BATCH,
               co_modulation=trainer.co_modulation, ds_dataset_type=trainer.ds_dataset_type,
               ms_by_branch=ms_by_branch, launches_by_branch=launches_by_branch,
               launches=launches, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               mean_path_length=float(st.mean_path_length))
    emit(rec)
    for k, m in mods.items():
        require(any(not torch.equal(a, b) for a, b in zip(before[k], m.parameters())),
                f"2-encoder training did not change {k}")
    require(all(v > 0 for v in launches.values()), f"2-encoder training launches {launches}")
    return rec


def two_encoder_cli_phase(ops):
    """The 2-encoder CLI as a user starts it (its ``main``): fake data,
    Tensor Transform, FFHQ dual supervision, full width, 256 px, a
    checkpoint after iteration ``CLI_SAVE``; then a run resumed from it,
    whose iterations must give the uninterrupted run's losses to the bit:
    ``CLI_CHECK`` (reconstruction, then PPL) and the FFHQ-DS iteration after
    it, which needs D_ffhq, its Adam and the G Adam's two updates back from
    the checkpoint.  PPL takes the whole batch (``--path_reg_batch_shrink 1``):
    the host RNG that draws its subset is not checkpointed, as in the JAX
    CLI, so a subset would differ after the resume and so would every loss
    after it.  Both runs take cuDNN's deterministic algorithms (see
    :func:`cli_phase`)."""
    from fm3dgan_torch.tools import train_2_encoder as cli

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli2")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    first, resumed = os.path.join(root, "run"), os.path.join(root, "resumed")
    args = ["--fake_data", "--co_mod", TWO_ENC_MODE, "--ds_dataset_type", "FFHQ",
            "--training_iters", str(CLI_ITERS), "--model_save_freq", str(CLI_SAVE), "--log_every", "1",
            "--path_reg_batch_shrink", "1"]
    rec = dict(phase="two_encoder_cli", cudnn_deterministic=True)
    torch.backends.cudnn.deterministic = True
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(args + ["--exp_dir", first])
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
        rec["launches"] = ops.launch_counts()
        require(rc == 0, f"the 2-encoder CLI exited {rc}")
        ckpt = os.path.join(first, "ckpt")
        require(sorted(os.listdir(ckpt)) == [f"{CLI_SAVE:06d}.json", f"{CLI_SAVE:06d}.pt"],
                f"checkpoints {os.listdir(ckpt)}")
        rec["checkpoint_bytes"] = os.path.getsize(os.path.join(ckpt, f"{CLI_SAVE:06d}.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc = cli.main(args + ["--exp_dir", resumed, "--resume_dir", ckpt,
                              "--resume_step", str(CLI_SAVE)])
        torch.cuda.synchronize()
        rec["resumed_run_s"] = time.perf_counter() - t0
        require(rc == 0, f"the resumed 2-encoder CLI exited {rc}")
        logs = {}
        for name, exp in (("run", first), ("resumed", resumed)):
            with open(os.path.join(exp, "training_log.jsonl")) as f:
                logs[name] = {line["iter"]: line for line in map(json.loads, f) if "iter" in line}
        require(sorted(logs["run"]) == list(range(CLI_ITERS)), f"iterations {sorted(logs['run'])}")
        require(sorted(logs["resumed"]) == list(range(CLI_SAVE + 1, CLI_ITERS)),
                f"resumed iterations {sorted(logs['resumed'])}")
        for line in logs["run"].values():
            require(all(math.isfinite(v) for v in line.values() if isinstance(v, float)),
                    f"2-encoder CLI iteration {line}")
        require(all("d_ffhq" in logs["run"][i] for i in range(1, CLI_ITERS, 2)),
                "the FFHQ branch did not run on the DS iterations")
        checked = (CLI_CHECK, CLI_CHECK + 1)
        require("g_reg" in logs["run"][CLI_CHECK] and "d_ffhq" in logs["run"][CLI_CHECK + 1],
                f"iterations {checked}: {[sorted(logs['run'][i]) for i in checked]}")
        rec["resume_diff"] = {}
        for i in checked:
            a, b = logs["run"][i], logs["resumed"][i]
            require(sorted(a) == sorted(b), f"iteration {i}: keys {sorted(a)} vs {sorted(b)}")
            # "r1" repeats the last R1 that ran (iteration 0's, not in the
            # resumed run), as the JAX trainer logs it.
            rec["resume_diff"][i] = {k: abs(a[k] - b[k]) for k in a
                                     if k not in ("iter", "time_s", "load_s", "r1")}
        rec["time_s"] = {i: line["time_s"] for i, line in logs["run"].items()}
        emit(rec)
        require(all(v > 0 for v in rec["launches"].values()), f"2-encoder CLI launches {rec['launches']}")
        require(all(v == 0.0 for d in rec["resume_diff"].values() for v in d.values()),
                f"resumed iterations {checked} differ: {rec['resume_diff']}")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    return rec


# Summary key -> record key, summed per iteration or per forward.
SUMMED = {"ms": "kernel_ms", "device_ms": "device_ms", "host_us": "host_us",
          "plain_ms": "plain_ms", "bound_ms": "bound_ms", "library_ms": "library_ms",
          "library_device_ms": "library_device_ms", "library_host_us": "library_host_us"}


def _weighted_sums(recs, weight_key):
    """The SUMMED keys over ``recs``, each record counted as often as
    ``weight_key`` says; None for the whole path when it does not run the
    kernel, and the library_* keys None where a record has no library
    call."""
    out = {}
    for key, rec_key in SUMMED.items():
        vals = [r[rec_key] for r in recs]
        out[key] = (None if not recs or any(v is None for v in vals)
                    else sum(v * r[weight_key] for v, r in zip(vals, recs)))
    return out


def summary(records, launches, inference_launches, two_encoder_launches):
    """One line per kernel.  The SUMMED keys are those of one float32
    training iteration without regulariser at batch 16 (the kernel-phase
    records of every training shape, each counted as often as the iteration
    launches it); the forward_* keys are those of one batch-8 inference
    forward.  ``launches`` counts the float32 training run,
    ``launches_inference`` one batch-8 forward, ``launches_two_encoder`` the
    2-encoder training run."""
    kernels = []
    for name, info in KERNEL_INFO.items():
        recs = [r for r in records if r["kernel"] == name and r["dtype"] == "float32"]
        bf16 = [r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16"]
        train_recs = [r for r in recs if "launches_per_iteration" in r]
        fwd_recs = [r for r in recs if "launches_per_forward" in r]
        fwd = _weighted_sums(fwd_recs, "launches_per_forward")
        kernels.append(dict(
            name=name, **info, launches=launches[name],
            launches_two_encoder=two_encoder_launches[name],
            launches_per_iteration=sum(r["launches_per_iteration"] for r in train_recs),
            launches_inference=inference_launches[name],
            max_abs_err=max(r["max_abs_diff"] for r in recs),
            max_abs_err_bf16=max(r["max_abs_diff"] for r in bf16),
            **_weighted_sums(train_recs, "launches_per_iteration"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in train_recs) else "operations",
            **{f"forward_{k}": v for k, v in fwd.items()},
            note=(f"ms, device_ms, host_us, plain_ms, bound_ms, library_*: one float32 training "
                  f"iteration without regulariser, batch {TRAIN_BATCH}; forward_*: one float32 "
                  f"inference forward, batch {BATCH}; ms: events around eager calls; device_ms: "
                  f"CUDA-graph replay; host_us: host time of the eager calls"),
        ))
    return {"kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write every record to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fm3dgan_torch import ops, pipeline, train

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = dict(name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
                  nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    emit(device)
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        emit(dict(phase_seconds=name, seconds=time.perf_counter() - t0))
        return out

    emit(dict(phase="build", seconds=ops.build_all()))
    records = phase("kernel", kernel_phase, ops) + phase("training_kernel", training_kernel_phase, ops)
    path = phase("path", path_phase, ops, pipeline)

    # The shipped 3-encoder configuration, 256 px, full width, LPIPS and ArcFace.
    config = train.TrainConfig()
    trainer = train.Trainer(config, seed=0, device="cuda")
    grads = phase("gradients", gradient_phase, ops, train, trainer)
    per_iteration = launches_per_iteration(records)
    launches, ms, _ = phase("train", training_phase, ops, train, trainer, range(TRAIN_ITERS),
                            "float32", per_iteration, check_state=True)
    phase("loss_nets", loss_net_phase, trainer, [ms[i] for i in SHARED_ITERS])
    del trainer
    torch.cuda.empty_cache()
    trainer = train.Trainer(dataclasses.replace(config, compute_dtype="bfloat16"), seed=0,
                            device="cuda")
    phase("train_bf16", training_phase, ops, train, trainer, range(BF16_ITERS), "bfloat16",
          per_iteration)
    del trainer
    torch.cuda.empty_cache()
    # The shared iteration runs G forward once: one inference forward's
    # launches fewer than the unshared iteration.
    trainer = train.Trainer(dataclasses.replace(config, share_dg_noise=True), seed=0, device="cuda")
    per_shared = {k: v - EXPECTED_LAUNCHES[k] for k, v in per_iteration.items()}
    _, shared_ms, _ = phase("shared", training_phase, ops, train, trainer, SHARED_ITERS, "float32",
                            per_shared)
    emit(dict(phase="shared_vs_unshared", iterations=list(SHARED_ITERS),
              shared_ms=[shared_ms[i] for i in SHARED_ITERS], unshared_ms=[ms[i] for i in SHARED_ITERS],
              launches_per_iteration=per_shared))
    del trainer
    torch.cuda.empty_cache()

    # The heatmap loss (FAN, 256 px input) from the first iteration on: FAN
    # alone, two iterations, whose kernels launch as the unshared ones do
    # (FAN runs none), the held G step, then the eval hook on this trainer.
    trainer = train.Trainer(dataclasses.replace(config, **HMAP_CONFIG), seed=0, device="cuda")
    phase("fan", fan_phase, train, trainer)
    torch.cuda.empty_cache()
    _, hmap_ms, hmap_losses = phase("hmap_train", training_phase, ops, train, trainer,
                                    SHARED_ITERS, "float32", per_iteration)
    emit(dict(phase="hmap_vs_unshared", iterations=list(SHARED_ITERS),
              hmap_ms=[hmap_ms[i] for i in SHARED_ITERS], unshared_ms=[ms[i] for i in SHARED_ITERS],
              hmap=[hmap_losses[i]["hmap"] for i in SHARED_ITERS],
              launches_per_iteration=per_iteration))
    require(all(math.isfinite(hmap_losses[i]["hmap"]) and hmap_losses[i]["hmap"] > 0
                for i in SHARED_ITERS), f"heatmap loss {hmap_losses}")
    torch.cuda.empty_cache()
    phase("hmap_gradients", hmap_gradient_phase, ops, train, trainer)
    torch.cuda.empty_cache()
    phase("eval", eval_phase, ops, trainer)
    del trainer
    torch.cuda.empty_cache()
    phase("cli", cli_phase, ops)

    # The 2-encoder scheme: the forward in its five configurations, then the
    # shipped configuration at 256 px with Tensor Transform and FFHQ dual
    # supervision: held gradients, training iterations and the CLI.
    phase("two_encoder_path", two_encoder_path_phase, ops, pipeline)
    trainer = train.Trainer2(config, seed=0, co_modulation=TWO_ENC_MODE, ds_dataset_type="FFHQ",
                             device="cuda")
    phase("two_encoder_gradients", two_encoder_gradient_phase, ops, train, trainer)
    torch.cuda.empty_cache()
    two_train = phase("two_encoder_train", two_encoder_train_phase, ops, trainer, per_iteration)
    del trainer
    torch.cuda.empty_cache()
    phase("two_encoder_cli", two_encoder_cli_phase, ops)

    result = summary(records, launches, path["launches"], two_train["launches"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, records=records, gradients=grads, summary=result), f,
                      indent=1)
    print(smi, flush=True)
    emit(result)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
