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
   (``host_us``); and, float32 only, at the shapes of one projector step
   (batch 1: G's forward and its backward);
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
    run's to the bit (cuDNN's deterministic algorithms in both);
12. edit CLI phase, on the checkpoint of phase 7: ``python -m
    fm3dgan_torch.tools.edit``'s ``main`` (1 photo x 32 renders, batches of
    16, grids) in float32 and in bfloat16 (launches per batch, one
    forward's); every PNG within 1 uint8 level of ``forward_3_encoder``
    under ``plain_versions()`` in the same dtype; seconds, img/s end to end
    and of the forward alone;
13. projector phase: that checkpoint's EMA G (256 px, full width, batch 1,
    seeded non-zero noise weights, LPIPS): the step-0 gradients to the
    latent and every noise map held by :func:`hold_gradient`, 60 Adam
    steps (LPIPS from step 30) and 10 L-BFGS steps kernel vs plain, PSNR
    rising, ms per step and launches per step (all five kernels, as the
    batch-1 kernel records' weights say);
14. eval tools phase: PPL (64 pairs, LPIPS) and ``get_generator_styles``
    kernel vs plain, then ``calc_inception`` on seeded PNGs and a 32-sample
    ``fid`` run against its statistics, each through its ``main``;
15. export phase: ``python -m fm3dgan_torch.tools.export_model``'s
    ``main`` with ``--verify`` on that checkpoint at batch 16 in float32
    and bfloat16 (the kernels as ``torch.ops.fm3dgan_torch`` operators in
    the program); the reloaded program's launches per batch (one
    forward's), none under ``plain_versions()`` and agreeing with the
    kernel run, a second seeded weight set through the same program, img/s
    of the program against the eager forward;
16. landmarks phase: ``extract_landmarks``'s ``main`` with
    ``--random_init`` on 32 seeded 256 px PNGs (5 and 68 points), seconds
    and images/s; S3FD's 12 maps at batch 8 against float64, and its ms;
17. IR backbone phase: ``IR_SE_50`` and ``IR_50`` at 112 px, batch 16,
    against float64, and their ms;
18. ddp phase: two processes of this script on the one card, a gloo world
    over CUDA tensors (NCCL refuses two ranks on one device), each with its
    8 rows of a global batch of 16: the full-width 256 px ``Trainer`` (LPIPS,
    ArcFace)'s D, R1, G and PPL gradients at the initial weights (fixed
    noise, cuDNN deterministic, averaged over the ranks), 6 training
    iterations (ms, launches and collectives per iteration; each rank
    launches every kernel, an iteration without regulariser as often as the
    kernel phase's weights say; after them every parameter and statistic
    equal on both ranks to the bit), the FFHQ-DS G, FFHQ G and PPL gradients
    of the Tensor Transform ``Trainer2``, and ``make_mesh_feature_fn``'s
    Inception features of 10 images.  Rank 0 then leaves the group and runs
    the same as one process on the global batch: the ranks' gradients held
    by :func:`hold_gradient` against its own and its float64 plain run,
    their losses within 1e-4, the 6 iterations' losses side by side (a bar on
    iteration 0's D, L1, LPIPS and face-ID losses, which no update precedes),
    the features within 1e-4;
19. ddp_cli phase: ``python -m torch.distributed.run --nproc_per_node 1``
    with ``train_3_encoder --data_parallel`` (an NCCL world of one, 256 px,
    fake data, 4 iterations, a checkpoint after iteration 2, a resumed run)
    against the same CLI as one process, all at lr 1e-7 under cuDNN's
    deterministic algorithms (``--run_module``): losses within 1e-5, the
    resumed iterations equal to the bit, ms per iteration with and without
    ``--data_parallel``, collectives and bytes all-reduced per iteration
    against the parameters' sizes; then ``train_2_encoder --data_parallel``
    (2 iterations) and ``fid --data_parallel`` against ``fid``;
20. profile phase: ``python -m fm3dgan_torch.tools.profile_train``'s
    ``main`` at batch 16 in float32 with LPIPS and ArcFace (the
    ``TrainConfig()`` shapes): the four steps' seconds, then iterations
    16-18 under ``torch.profiler`` (the device's busy ms per iteration and
    idle share); ``analyze_trace`` on the trace: device ms per iteration by
    category, the top device rows, and each kernel's device events equal to
    its launches over the window, no plain version taken;
21. bf16_parity phase: ``validate_bf16``'s float32, bfloat16 and again
    float32 runs at its defaults but 60 iterations a run (64 px, 128 px
    inputs, batch 4, LPIPS and ArcFace), every tracked value finite; its
    report, and the windowed deviation of the two float32 runs from each
    other.

Prints one JSON line per measurement and per phase's seconds, the card's
name and power limit, a ``{"kernels": [...]}`` summary, and last
``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device, when a kernel
does not build or launch, or when any check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
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
EDIT_RENDERS, EDIT_BATCH = 32, 16  # the edit CLI: 1 photo x 32 renders, batches of 16
PROJ_ADAM_STEPS, PROJ_LPIPS_START, PROJ_LBFGS_STEPS = 60, 30, 10
PPL_SAMPLES = 64
FID_SAMPLES = 32
EXPORT_BATCH = 16
LANDMARK_IMAGES, LANDMARK_BATCH = 32, 8
IR_BATCH = 16
# profile_train at TrainConfig()'s shapes (batch 16, 256 px, LPIPS and ArcFace)
# in float32; the top device rows kept.
PROFILE_BATCH, PROFILE_ITERS, PROFILE_TOP = 16, 3, 15
# validate_bf16's runs: 60 iterations each, not the JAX tool's 100: on an
# H100 80GB HBM3 (700 W) with a slow host, three runs of 100 took 86 s of
# the phase's 90 s budget and the whole script 1081 s of its 1200 s.
BF16_PARITY_ITERS = 60

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


# The path a kernel record's shapes come from -> the key of its launches per
# iteration or step of that path.
WEIGHT_KEYS = {"training": "launches_per_iteration", "projector": "launches_per_step"}


def _training_record(kernel, x, dtype, weight, got, ref32, fns, in_bytes, out_bytes, flops,
                     what="training"):
    """Check one training-shape launch against its plain version and time
    the kernel, the plain version and the library call (None: no single
    PyTorch call computes the function).  ``weight``: the launches of this
    case in one training iteration without regulariser, or in one step of
    another path (``what``), kept under ``WEIGHT_KEYS[what]``."""
    kernel_fn, plain_fn, lib_fn = fns
    rec = dict(kernel=kernel, what=what, shape=list(x.shape), dtype=_dtname(dtype),
               **{WEIGHT_KEYS[what]: weight}, **compare(got, ref32, dtype))
    rec.update(time_calls(kernel_fn, plain_fn, lib_fn, iters=20))
    rec["bound_ms"], rec["bound_by"] = bound(in_bytes, out_bytes, flops)
    emit(rec)
    require(rec["ok"], f"{kernel} {rec['shape']} {dtype}: {rec['max_abs_diff']}")
    return rec


def training_kernel_phase(ops, batch=TRAIN_BATCH, passes=(G_FWD, G_BWD, D_FWD, D_BWD),
                          dtypes=(torch.float32, torch.bfloat16), what="training"):
    """Every kernel at every shape one training iteration without
    regulariser gives it, batch 16: K1 and K2 at G's and D's activation
    shapes, K3 at G's up-blur, D's blurs and every blur adjoint, K4 at the
    ToRGB skip and K5 at its adjoint.  Another path's shapes: its ``batch``,
    its G and D forward and backward ``passes`` per step (the shapes of a
    network it does not run are left out), its ``dtypes``, the records
    marked ``what``."""
    G_FWD, G_BWD, D_FWD, D_BWD = passes  # noqa: N806
    record = lambda *a: _training_record(*a, what=what)  # noqa: E731
    records = []
    k2d = ops.make_kernel([1, 3, 3, 1])
    k1d = [0.25, 0.75, 0.75, 0.25]
    kflip = k1d[::-1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    b = batch
    per_g = {(c, r): n for c, r, n in ACT_SHAPES}
    per_d = {(c, r): n for c, r, n in D_ACT_SHAPES} if D_FWD else {}
    act_shapes = sorted(set(per_g) | set(per_d), key=lambda s: (-s[1], s[0]))
    for dtype in dtypes:
        esize = torch.finfo(dtype).bits // 8
        for c, r in act_shapes:
            shape = (b, c, r, r) if r else (b, c)
            g, x = rnd(*shape).to(dtype), rnd(*shape).to(dtype)
            bias = rnd(c)
            out = ops.fused_leaky_relu(x, bias)
            n = g.numel()
            n_g, n_d = per_g.get((c, r), 0), per_d.get((c, r), 0)
            records.append(record(
                "fused_leaky_relu", x, dtype, G_FWD * n_g + D_FWD * n_d, out,
                ops.fused_leaky_relu_plain(x.float(), bias.to(dtype).float()),
                (lambda: ops.fused_leaky_relu(x, bias),
                 lambda: ops.fused_leaky_relu_plain(x, bias), None),
                n * esize + c * esize, n * esize, 4 * n))
            records.append(record(
                "fused_leaky_relu_bwd", g, dtype, G_BWD * n_g + D_BWD * n_d,
                ops.fused_leaky_relu_bwd(g, out), ops.fused_leaky_relu_bwd_plain(g.float(), out),
                (lambda: ops.fused_leaky_relu_bwd(g, out),
                 lambda: ops.fused_leaky_relu_bwd_plain(g, out), None),
                2 * n * esize, n * esize, n))
        for r in UP2_SHAPES:
            x = rnd(b, 3, r, r).to(dtype)  # the ToRGB skip: [b, 3, R, R] -> 2R
            got = ops.upsample2x(x, k1d, (2, 1))
            wlib = torch.outer(torch.tensor(k1d), torch.tensor(k1d)).to("cuda", dtype).expand(3, 1, 4, 4)
            records.append(record(
                "upsample2x", x, dtype, G_FWD, got, ops.upsample2x_plain(x.float(), k1d, (2, 1)),
                (lambda: ops.upsample2x(x, k1d, (2, 1)),
                 lambda: ops.upsample2x_plain(x, k1d, (2, 1)),
                 lambda: F.conv_transpose2d(x, wlib, stride=2, padding=1, groups=3)),
                x.numel() * esize, got.numel() * esize, got.numel() * 4 * 2))
            x = rnd(b, 3, 2 * r, 2 * r).to(dtype)  # its adjoint: [b, 3, 2R, 2R] -> R
            got = ops.downsample2x(x, kflip, (1, 1))
            wlib = torch.flip(torch.outer(torch.tensor(kflip), torch.tensor(kflip)), (0, 1))
            wlib = wlib.to("cuda", dtype).expand(3, 1, 4, 4)
            records.append(record(
                "downsample2x", x, dtype, G_BWD, got,
                ops.downsample2x_plain(x.float(), kflip, (1, 1)),
                (lambda: ops.downsample2x(x, kflip, (1, 1)),
                 lambda: ops.downsample2x_plain(x, kflip, (1, 1)),
                 lambda: F.conv2d(x, wlib, stride=2, padding=1, groups=3)),
                x.numel() * esize, got.numel() * esize, got.numel() * 16 * 2))
        blur_cases = []
        for c, r in (D_BLUR_SHAPES if D_FWD else ()):
            blur_cases += [((c, r), k2d, 2, D_FWD), ((c, r), k2d, 1, D_FWD),  # 3x3 conv, 1x1 skip
                           ((c, r + 1), k2d, 1, D_BWD), ((c, r - 1), k2d, 2, D_BWD)]  # adjoints
        for c, r in BLUR_SHAPES:
            blur_cases += [((c, 2 * r + 1), k2d * 4.0, 1, G_FWD),  # G's up-blur
                           ((c, 2 * r), k2d * 4.0, 2, G_BWD)]  # and its adjoint
        for (c, r), k, p, weight in blur_cases:
            x = rnd(b, c, r, r).to(dtype)
            got = ops.blur(x, k, (p, p))
            wlib = torch.flip(torch.as_tensor(k, device="cuda"), (0, 1)).expand(c, 1, 4, 4).to(dtype)
            records.append(record(
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


def replay_check(ops, pipeline, models, photo, render):
    """The graph route at a batch of one pair: three calls with the same
    inputs (eager, capture and replay, replay), the third held against the
    plain path at the eager call's tolerance.  The capture holds 16 side
    branches (E_Tsr, E_W and pSp's 14 style blocks); the eager plain call
    forks none."""
    forward_3_encoder, stats = pipeline.forward_3_encoder, pipeline.STATS
    keys = ("captures", "replays", "branches")
    before = {k: stats[k] for k in keys}
    with ops.plain_versions():
        ref = forward_3_encoder(models, photo, render)
    require(stats["branches"] == before["branches"], "an eager call forked branches")
    for _ in range(3):
        image = forward_3_encoder(models, photo, render)
    torch.cuda.synchronize()
    routes = {k: stats[k] - before[k] for k in keys}
    rec = dict(phase="path", what="batch-1 replay vs plain", routes=routes,
               max_abs_diff_vs_plain=float((image.float() - ref.float()).abs().max()))
    emit(rec)
    require(routes == dict(captures=1, replays=2, branches=16), f"batch-1 routes {routes}")
    require(rec["max_abs_diff_vs_plain"] <= 1e-4,
            f"fp32 replay vs plain path: {rec['max_abs_diff_vs_plain']}")
    return rec


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
            out["replay"] = replay_check(ops, pipeline, models, photo[:1], render[:1])
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
        replays = pipeline.STATS["replays"]
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
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                  pipeline_routes=json.loads(json.dumps(pipeline.STATS))))
        # Batches above pipeline.graphs.MAX_BATCH run eagerly: both paths timed
        # here are the eager forward.
        require(pipeline.STATS["replays"] == replays, "a timed batch-32 forward replayed a graph")
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
    held, fails = _compare_held(got, want, exact, again)
    rec = dict(phase=phase, batch=batch, dtype="float32", **held,
               losses=got_losses, loss_rel_diff_vs_exact=loss_rel,
               launches=counts, plain_launches=plain_counts,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    emit(rec)
    require(not held["plain_repeat_differs"],
            f"the plain path does not reproduce itself: {held['plain_repeat_differs']}")
    require(not fails, f"gradients outside their bar: {fails}")
    require(all(v > 0 for v in counts.values()), f"{phase} launches {counts}")
    return rec


def _compare_held(got, want, exact, again=None):
    """Every tensor of ``exact`` ({step: {part: {name: grad}}}) through
    :func:`hold_gradient` with ``got`` as its k and ``want`` as its p (and
    ``again``, a repeat of ``want`` that must equal it to the bit): the
    record's counts and worst differences, and the tensors that fail."""
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
                if again is not None and not torch.equal(again[step][part][name], p):
                    repeat_differs.append(what)
                ok, rel = hold_gradient(k.to(e.device), p.to(e.device), e, part_max)
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
    held = dict(tensors=n, zero_in_exact_arithmetic=zero, worst_rel_diff=worst,
                plain_over_1e4_from_exact=plain_off, kernel_vs_plain_over_1e4=over,
                plain_repeat_differs=repeat_differs)
    return held, fails


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


def cli_phase(ops, root):
    """The training CLI as a user starts it (its ``main``), in ``root``,
    where it leaves its checkpoint (``run/ckpt``) for the tool phases: fake data, full
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
        shutil.rmtree(resumed, ignore_errors=True)
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
    mean 0 and identity covariance.  The kernel path, timed (launches: only
    the forward kernels K1, K3 and K4), and the plain path, both under
    cuDNN's deterministic algorithms: each score within 1e-4 of the plain
    path's, relative (FID 1e-3: the square root of a singular product),
    plus 1e-6.  Also a timed pass without FID (its host ``sqrtm``) with the
    default algorithms, the EMA forward's img/s, InceptionV3's ms on the
    edit batch, and a ``get_val_sample_grid`` grid from both paths, equal
    within 1 in uint8."""
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
        ops.reset_launches()
        t0 = time.perf_counter()
        kernel = hook(0)
        torch.cuda.synchronize()
        rec["pass_s"] = time.perf_counter() - t0
        rec["launches"] = ops.launch_counts()
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
    real_stats, hook.real_stats = hook.real_stats, None  # the same pass without FID
    torch.cuda.synchronize()
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
    require(all(math.isfinite(v) for v in kernel.values()), f"eval scores {kernel}")
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


# ---------------- the serving and checkpoint tools ----------------------------


def _write_pngs(d, prefix, n, seed, px=256):
    """``n`` seeded uint8 noise PNGs ``{prefix}{i}.png`` in ``d``."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    x = torch.randint(0, 256, (n, px, px, 3), generator=torch.Generator().manual_seed(seed),
                      dtype=torch.uint8).numpy()
    paths = [os.path.join(d, f"{prefix}{i}.png") for i in range(n)]
    for path, img in zip(paths, x):
        Image.fromarray(img).save(path)
    return paths


def _tool(module, *args):
    """A tool's ``main`` (what ``python -m fm3dgan_torch.tools.<name>``
    runs) on ``args`` in this process; (stdout, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(list(args))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(rc == 0, f"{module.__name__} exited {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue(), seconds


def edit_cli_phase(ops, root, ckpt_dir, step):
    """The serving CLI on the CLI phase's checkpoint (EMA G, full width,
    256 px): 1 photo x ``EDIT_RENDERS`` renders in batches of
    ``EDIT_BATCH`` with grids through its ``main``, in float32 and then in
    bfloat16 (launches per batch in each: one forward's, K3 6 / K4 6 / K1
    13).  Every PNG within 1 uint8 level of ``forward_3_encoder`` under
    ``plain_versions()`` in the same dtype.  Seconds end to end, img/s
    against the forward alone."""
    import numpy as np
    from PIL import Image

    from fm3dgan_torch.data.datasets import default_transform, load_image
    from fm3dgan_torch.eval.visual_eval import tensor_to_image
    from fm3dgan_torch.pipeline import forward_3_encoder
    from fm3dgan_torch.tools import edit
    from fm3dgan_torch.utils import build_manipulator_from_checkpoint

    d = os.path.join(root, "edit")
    photo = _write_pngs(d, "photo", 1, 51)
    renders = _write_pngs(d, "render", EDIT_RENDERS, 52)
    args = ["--ckpt_dir", ckpt_dir, "--step", str(step), "--photo", *photo, "--render", *renders,
            "--batch", str(EDIT_BATCH), "--grid"]
    outs = {name: os.path.join(d, name) for name in ("float32", "bfloat16")}
    n_batches = -(-EDIT_RENDERS // EDIT_BATCH)
    rec = dict(phase="edit_cli", pairs=EDIT_RENDERS, batch=EDIT_BATCH, size=256)
    counts = {}
    for name, out in outs.items():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        rc = edit.main(args + ["--out_dir", out, "--dtype", name])
        torch.cuda.synchronize()
        rec[f"{name}_main_s"] = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        require(rc == 0, f"the edit CLI ({name}) exited {rc}")
        torch.cuda.empty_cache()
    rec["launches"] = counts
    rec["launches_per_batch"] = {k: v // n_batches for k, v in counts["float32"].items()}
    tf = default_transform(256)
    p = np.stack([load_image(photo[0], tf)] * EDIT_BATCH)
    r = np.stack([load_image(x, tf) for x in renders])
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        models, meta = build_manipulator_from_checkpoint(ckpt_dir, step, device="cuda", dtype=dtype)
        sliced = tuple(meta["sliced_layer"]) if meta.get("sliced_layer") else None

        def fwd(i):
            return forward_3_encoder(models, torch.from_numpy(p), torch.from_numpy(r[i:i + EDIT_BATCH]),
                                     tsr_encode=meta["tsr_encode"], sliced_layer=sliced,
                                     use_tanh=meta["use_tanh"])

        with ops.plain_versions():
            want = np.concatenate([tensor_to_image(fwd(i).float())
                                   for i in range(0, EDIT_RENDERS, EDIT_BATCH)])
        got = np.stack([np.asarray(Image.open(os.path.join(outs[name], f"photo0__render{i}.png")))
                        for i in range(EDIT_RENDERS)])
        rec[f"{name}_max_uint8_diff_vs_plain"] = int(np.abs(got.astype(np.int16) - want).max())
        rec[f"{name}_grids"] = sum(f.endswith("_grid.png") for f in os.listdir(outs[name]))
        if dtype == torch.float32:
            with torch.no_grad():
                ms = cuda_ms(lambda: fwd(0), iters=5, warmup=2)[0]
            rec["forward_img_per_s"] = EDIT_BATCH / ms * 1e3
        del models
        torch.cuda.empty_cache()
    rec["float32_main_img_per_s"] = EDIT_RENDERS / rec["float32_main_s"]
    emit(rec)
    for name in outs:
        require(counts[name] == {k: n_batches * v for k, v in EXPECTED_LAUNCHES.items()},
                f"{name} edit launches {counts[name]}, expected {n_batches} x {EXPECTED_LAUNCHES}")
        require(rec[f"{name}_grids"] == EDIT_RENDERS, f"{name} grids: {rec[f'{name}_grids']}")
        require(rec[f"{name}_max_uint8_diff_vs_plain"] <= 1,
                f"{name} edits vs the plain forward: {rec[f'{name}_max_uint8_diff_vs_plain']}")
    return rec


def projector_launches(per_forward):
    """One projector step's launches: G's forward (``per_forward``), and its
    backward to the latent and the noise maps: K2 once per K1, the blur's
    adjoint once per blur, K5 once per K4 (the ToRGB skip's adjoint)."""
    return {"blur": 2 * per_forward["blur"], "upsample2x": per_forward["upsample2x"],
            "fused_leaky_relu": per_forward["fused_leaky_relu"],
            "fused_leaky_relu_bwd": per_forward["fused_leaky_relu"],
            "downsample2x": per_forward["upsample2x"]}


def projection_run_launches(per_step, evaluations):
    """The launches of one ``optimize_projection`` run: ``evaluations``
    evaluations of the loss and its gradient (one per Adam step; L-BFGS's
    line search may take more), each ``per_step``, then G's forward of the
    final image."""
    return {k: evaluations * v + EXPECTED_LAUNCHES[k] for k, v in per_step.items()}


def projector_phase(ops, ckpt_dir, step, per_step):
    """The projector on the EMA G of the CLI phase's checkpoint (full width,
    256 px, batch 1) with every noise weight set to a seeded non-zero value,
    LPIPS with random weights, towards G's own image of a seeded z:

    * the step-0 gradients of MSE + LPIPS to the latent and to every noise
      map, through the kernels, under ``plain_versions()`` twice and in
      float64, each held by :func:`hold_gradient`;
    * ``PROJ_ADAM_STEPS`` Adam steps (LPIPS from ``PROJ_LPIPS_START``) and
      ``PROJ_LBFGS_STEPS`` L-BFGS steps (LPIPS from the middle) through
      ``optimize_projection``, kernel and plain paths under cuDNN's
      deterministic algorithms: the loss curves agree within 1e-4
      relative, PSNR rises, the plain runs launch nothing, and each kernel
      run launches ``per_step`` (the kernel phase's weights) per evaluation
      of the loss, plus one forward for the final image;
    * ms per Adam step (cuDNN's default algorithms) and the launches per
      step of that timed run, counted from 0 just before it."""
    from fm3dgan_torch.eval import projector
    from fm3dgan_torch.models import LPIPS, Generator
    from fm3dgan_torch.nn.modulated import NoiseInjection
    from fm3dgan_torch.tools.nets import lpips_net
    from fm3dgan_torch.utils import build_manipulator_from_checkpoint

    models, meta = build_manipulator_from_checkpoint(ckpt_dir, step, device="cuda")
    g = models.generator
    rng = torch.Generator().manual_seed(61)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, NoiseInjection):
                m.weight.copy_(torch.rand(1, generator=rng) * 0.4 + 0.1)
        target = g(torch.randn(1, g.style_dim, generator=rng).cuda(), randomize_noise=False)
    lpips = lpips_net("cuda")
    start = (projector.get_avg_w_latent(g, rng), g.make_noise(rng))
    rec = dict(phase="projector", size=256, batch=1)

    def grads(gen, lp, dtype):
        latent = start[0].to(dtype).clone().requires_grad_(True)
        noises = [n.to(dtype).clone().requires_grad_(True) for n in start[1]]
        loss = projector.projection_loss(gen, target.to(dtype), latent, noises, lp, True,
                                         projector.ProjectorConfig())
        gs = torch.autograd.grad(loss, [latent, *noises])
        return {"latent": gs[0], **{f"noise_{i}": x for i, x in enumerate(gs[1:])}}

    def run(optimizer, steps, lpips_start, plain):
        """``optimize_projection`` from ``start``; its result and its
        launches, counted from 0."""
        cfg = projector.ProjectorConfig(steps=steps, lr=0.1, optimizer=optimizer,
                                        lpips_start_step=lpips_start)
        ops.reset_launches()
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            out = projector.optimize_projection(g, target, *start, lpips_fn=lpips, config=cfg)
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    torch.backends.cudnn.deterministic = True
    try:
        got = grads(g, lpips, torch.float32)
        ops.reset_launches()
        with ops.plain_versions():
            want, again = grads(g, lpips, torch.float32), grads(g, lpips, torch.float32)
            g64 = Generator(size=meta["size"], style_dim=meta["latent"],
                            channel_multiplier=meta["channel_multiplier"],
                            width_mult=meta["width_mult"], dtype=torch.float64).cuda().eval()
            g64.load_state_dict(g.state_dict())
            lp64 = LPIPS(dtype=torch.float64).cuda().eval().requires_grad_(False)
            lp64.load_state_dict(lpips.state_dict())
            exact = grads(g64, lp64, torch.float64)
            del g64, lp64
            torch.cuda.synchronize()
        plain_launches = {"gradients": ops.launch_counts()}
        part_max = max(float(e.abs().max()) for e in exact.values())
        held, fails = {}, []
        for name, e in exact.items():
            ok, rel = hold_gradient(got[name], want[name], e, part_max)
            held[name] = rel
            if not ok or not torch.equal(want[name], again[name]):
                fails.append(name)
        rec["gradients"] = held
        rec["noise_grad_max_abs"] = [float(got[f"noise_{i}"].abs().max())
                                     for i in range(len(start[1]))]

        curves = {}
        for optimizer, steps, lpips_start in (("adam", PROJ_ADAM_STEPS, PROJ_LPIPS_START),
                                              ("lbfgs", PROJ_LBFGS_STEPS, PROJ_LBFGS_STEPS // 2)):
            kernel, launches = run(optimizer, steps, lpips_start, False)
            plain, plain_launches[optimizer] = run(optimizer, steps, lpips_start, True)
            # Each evaluation runs K2 as often; Adam evaluates once a step.
            evaluations = launches["fused_leaky_relu_bwd"] // per_step["fused_leaky_relu_bwd"]
            with torch.no_grad():
                start_img = g(input_is_latent=True, latent_styles=[start[0]], noise=start[1])
            curves[optimizer] = dict(
                losses=kernel["losses"], plain_losses=plain["losses"],
                max_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(kernel["losses"], plain["losses"])),
                psnr_start=projector.psnr(start_img, target),
                psnr=projector.psnr(kernel["image"], target), launches=launches,
                evaluations=evaluations, steps=steps)
        rec["curves"] = curves
    finally:
        torch.backends.cudnn.deterministic = False
    run("adam", 2, PROJ_LPIPS_START, False)  # warm-up of the default algorithms
    t0 = time.perf_counter()
    _, launches = run("adam", PROJ_ADAM_STEPS, PROJ_LPIPS_START, False)
    rec["adam_ms_per_step"] = (time.perf_counter() - t0) / PROJ_ADAM_STEPS * 1e3
    rec["adam_launches"] = launches
    rec["launches_per_step"] = {k: (v - EXPECTED_LAUNCHES[k]) // PROJ_ADAM_STEPS
                                for k, v in launches.items()}
    rec["expected_launches_per_step"] = per_step
    rec["plain_launches"] = plain_launches
    emit(rec)
    require(not fails, f"projector gradients outside their bar: {fails} {held}")
    require(all(v > 0 for v in rec["noise_grad_max_abs"]), "a noise map has no gradient")
    want = projection_run_launches(per_step, PROJ_ADAM_STEPS)
    require(launches == want, f"timed projector launches {launches} != {want}")
    for name, counts in plain_launches.items():
        require(not any(counts.values()), f"plain projector ({name}) launched {counts}")
    for name, c in curves.items():
        require(all(math.isfinite(v) for v in c["losses"]), f"{name} losses {c['losses']}")
        require(c["max_rel_diff"] <= 1e-4, f"{name} kernel vs plain losses: {c['max_rel_diff']}")
        require(c["psnr"] > c["psnr_start"], f"{name} PSNR {c['psnr_start']} -> {c['psnr']}")
        want = projection_run_launches(per_step, c["evaluations"])
        require(c["launches"] == want and c["evaluations"] >= c["steps"]
                and (name != "adam" or c["evaluations"] == c["steps"]),
                f"{name} projector launches {c['launches']} != {want} ({c['steps']} steps)")
    return rec


def eval_tools_phase(ops, root, ckpt_dir, step):
    """PPL (``PPL_SAMPLES`` pairs, batch 16, LPIPS with random weights) and
    ``get_generator_styles`` on the CLI phase's EMA G, through the kernels
    and under ``plain_versions()`` (PPL within 1e-4 relative, styles equal);
    then ``calc_inception`` on a folder of seeded PNGs and a short ``fid``
    run against its statistics, each through its ``main``.  Seconds of
    each."""
    from fm3dgan_torch.eval.ppl import get_ppl_score
    from fm3dgan_torch.pipeline.introspect import get_generator_styles
    from fm3dgan_torch.tools import calc_inception, fid
    from fm3dgan_torch.tools.nets import lpips_net
    from fm3dgan_torch.utils import build_manipulator_from_checkpoint

    g = build_manipulator_from_checkpoint(ckpt_dir, step, device="cuda")[0].generator
    lpips = lpips_net("cuda")

    def ppl():
        return get_ppl_score(lambda z: g.get_latent(z.cuda()),
                             lambda w: g(input_is_latent=True, latent_styles=[w], randomize_noise=False),
                             lpips, n_sample=PPL_SAMPLES, batch_size=16, latent_dim=g.style_dim,
                             generator=torch.Generator().manual_seed(0))

    z = torch.randn(4, g.style_dim, generator=torch.Generator().manual_seed(71)).cuda()
    rec = dict(phase="eval_tools", ppl_samples=PPL_SAMPLES)
    torch.backends.cudnn.deterministic = True
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        kernel = ppl()
        rec["ppl_s"] = time.perf_counter() - t0
        rec["ppl_launches"] = ops.launch_counts()
        styles = get_generator_styles(g, z)
        ops.reset_launches()
        with ops.plain_versions():
            plain = ppl()
            plain_styles = get_generator_styles(g, z)
            rec["plain_launches"] = ops.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    rec.update(ppl=kernel, plain_ppl=plain, ppl_rel_diff=abs(kernel - plain) / abs(plain),
               styles=len(styles), styles_max_abs_diff=max(float(abs(a - b).max())
                                                          for a, b in zip(styles, plain_styles)))
    del g
    torch.cuda.empty_cache()
    imgs = os.path.join(root, "fid_imgs")
    _write_pngs(imgs, "x", FID_SAMPLES, 72)
    stats = os.path.join(root, "fid_stats.pkl")
    _, rec["calc_inception_s"] = _tool(calc_inception, "--img_dir", imgs, "--out", stats,
                                       "--batch", "16")
    out, rec["fid_s"] = _tool(fid, "--ckpt_dir", ckpt_dir, "--step", str(step), "--stats", stats,
                              "--n_sample", str(FID_SAMPLES), "--batch", "16")
    rec["fid"] = float(out.strip().splitlines()[-1].split(":")[-1])
    emit(rec)
    require(math.isfinite(kernel) and kernel > 0, f"PPL {kernel}")
    require(rec["ppl_rel_diff"] <= 1e-4, f"PPL kernel vs plain: {rec['ppl_rel_diff']}")
    require(rec["styles_max_abs_diff"] == 0.0, f"styles kernel vs plain: {rec['styles_max_abs_diff']}")
    counts = rec["ppl_launches"]
    require(all(counts[k] > 0 for k in ("blur", "upsample2x", "fused_leaky_relu"))
            and counts["fused_leaky_relu_bwd"] == 0 and counts["downsample2x"] == 0,
            f"PPL launches {counts}")
    require(not any(rec["plain_launches"].values()), f"plain eval tools launched {rec['plain_launches']}")
    require(math.isfinite(rec["fid"]), f"FID {rec['fid']}")
    return rec


def export_phase(ops, root, ckpt_dir, step):
    """The export CLI on the CLI phase's checkpoint (EMA G, full width, 256
    px) at batch ``EXPORT_BATCH``, float32 and bfloat16, through its
    ``main`` with ``--verify`` (the reloaded program against the live
    forward: 2e-5 in float32, 5e-2 in bfloat16).  Then the float32
    program: launches per batch (one forward's: K3 6 / K4 6 / K1 13), none
    under ``plain_versions()`` and within 1e-5·max|ref| of the kernel run
    there; a second seeded weight set through the same program against its
    own eager forward (2e-5); these comparisons under cuDNN's deterministic
    algorithms, as the tool's own (its default ones differ from run to run
    by more than 2e-5 on this checkpoint: recorded beside them); img/s of
    the program against the eager forward (default algorithms), in turns.
    The bfloat16 program's launches too."""
    from fm3dgan_torch.pipeline import FaceManipulator
    from fm3dgan_torch.tools import export_model
    from fm3dgan_torch.utils import build_manipulator_from_checkpoint

    rec = dict(phase="export", batch=EXPORT_BATCH, size=256)
    paths = {}
    for name in ("float32", "bfloat16"):
        paths[name] = os.path.join(root, f"model_{name}.pt2")
        out, rec[f"{name}_main_s"] = _tool(
            export_model, "--ckpt_dir", ckpt_dir, "--step", str(step), "--out", paths[name],
            "--batch", str(EXPORT_BATCH), "--dtype", name, "--verify")
        rec[f"{name}_verify"] = out.strip().splitlines()[-1]
        rec[f"{name}_mb"] = os.path.getsize(paths[name]) / 1e6
        torch.cuda.empty_cache()
    photo, render = (x.cuda() for x in export_model.seeded_inputs(EXPORT_BATCH, 256, seed=5))
    counts = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        models, meta = build_manipulator_from_checkpoint(ckpt_dir, step, device="cuda", dtype=dtype)
        serving = export_model.ServingForward(models, meta)
        weights = export_model.program_weights(serving)
        program = torch.export.load(paths[name]).module()
        with torch.no_grad():
            ops.reset_launches()
            got = program(weights, photo, render)
            torch.cuda.synchronize()
            counts[name] = ops.launch_counts()
            if name != "float32":
                continue
            rec["default_cudnn_program_vs_eager"] = float((serving(photo, render) - got).abs().max())
            rec["default_cudnn_eager_vs_eager"] = float(
                (serving(photo, render) - serving(photo, render)).abs().max())
            with export_model.deterministic_cudnn():
                got = program(weights, photo, render)
                ops.reset_launches()
                with ops.plain_versions():
                    plain = program(weights, photo, render)
                torch.cuda.synchronize()
                rec["plain_launches"] = ops.launch_counts()
            ref = got.float()
            rec["max_abs_diff_vs_plain"] = float((plain.float() - ref).abs().max())
            rec["plain_atol"] = 1e-5 * float(ref.abs().max())
            times = {"eager": [], "program": []}
            for which in ("eager", "program", "program", "eager"):
                fn = ((lambda: serving(photo, render)) if which == "eager"
                      else (lambda: program(weights, photo, render)))
                times[which].append(cuda_ms(fn, iters=5, warmup=2)[0])
            rec["runs_ms"] = times
            for which, ms in times.items():
                rec[f"{which}_img_per_s"] = EXPORT_BATCH / (sum(ms) / len(ms)) * 1e3
            other = export_model.ServingForward(
                FaceManipulator.create(size=256, input_size=256, device="cuda", seed=1), meta)
            with export_model.deterministic_cudnn():
                want = other(photo, render)
                got2 = program(export_model.program_weights(other), photo, render)
            rec["second_weights_max_abs_diff"] = float((got2 - want).abs().max())
            rec["second_weights_vs_first"] = float((got2 - got).abs().max())
            del other, want, got2, plain
        del models, serving, weights, program, got
        torch.cuda.empty_cache()
    rec["launches_per_batch"] = counts
    emit(rec)
    for name in ("float32", "bfloat16"):
        require(rec[f"{name}_verify"].startswith("verify OK"), f"{name} export: {rec[f'{name}_verify']}")
        require(counts[name] == EXPECTED_LAUNCHES,
                f"{name} exported batch launches {counts[name]} != {EXPECTED_LAUNCHES}")
    require(not any(rec["plain_launches"].values()), f"plain program launched {rec['plain_launches']}")
    require(rec["max_abs_diff_vs_plain"] <= rec["plain_atol"],
            f"program kernel vs plain: {rec['max_abs_diff_vs_plain']} > {rec['plain_atol']}")
    require(rec["second_weights_max_abs_diff"] <= 2e-5,
            f"second weight set vs its forward: {rec['second_weights_max_abs_diff']}")
    require(rec["second_weights_vs_first"] > 1e-2, "the second weight set did not move the output")
    return rec


def landmarks_phase(root):
    """``extract_landmarks``'s ``main`` with ``--random_init`` on
    ``LANDMARK_IMAGES`` seeded 256 px PNGs in batches of ``LANDMARK_BATCH``,
    5 and 68 points: seconds and images/s, one file per image with as many
    finite ``x y`` lines as points.  Then S3FD (the tool's seeded weights)
    at ``LANDMARK_BATCH`` x 256 px: its 12 maps within 1e-4·max of a float64
    run of the same weights on the card, and its ms."""
    from fm3dgan_torch.models.sfd_detector import S3FD, preprocess_sfd
    from fm3dgan_torch.tools import extract_landmarks
    from fm3dgan_torch.tools.nets import seeded

    d = os.path.join(root, "faces")
    _write_pngs(d, "face", LANDMARK_IMAGES, 81)
    rec = dict(phase="landmarks", images=LANDMARK_IMAGES, batch=LANDMARK_BATCH, size=256)
    lines_ok = {}
    for points in (5, 68):
        out_dir = os.path.join(root, f"landmarks{points}")
        _, rec[f"points{points}_main_s"] = _tool(
            extract_landmarks, "--img_dir", d, "--out_dir", out_dir, "--random_init",
            "--batch", str(LANDMARK_BATCH), "--points", str(points))
        rec[f"points{points}_img_per_s"] = LANDMARK_IMAGES / rec[f"points{points}_main_s"]
        files = sorted(os.listdir(out_dir))
        values = [[float(v) for line in open(os.path.join(out_dir, f)) for v in line.split()]
                  for f in files]
        lines_ok[points] = (len(files) == LANDMARK_IMAGES
                            and all(len(v) == 2 * points and all(map(math.isfinite, v)) for v in values))
    net32 = seeded(S3FD, 0)  # the tool's --random_init weights
    net64 = S3FD(dtype=torch.float64)
    net64.load_state_dict(net32.state_dict())
    net32, net64 = (n.requires_grad_(False).eval().cuda() for n in (net32, net64))
    g = torch.Generator().manual_seed(82)
    x = preprocess_sfd(torch.rand(LANDMARK_BATCH, 3, 256, 256, generator=g) * 255).cuda()
    with torch.no_grad():
        maps32, maps64 = net32(x), net64(x.double())
        rec["s3fd_ms"] = cuda_ms(lambda: net32(x), iters=10, warmup=2)[0]
    rec["s3fd_max_rel_diff_vs_float64"] = max(
        float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(maps32, maps64))
    rec["s3fd_map_shapes"] = [list(m.shape) for m in maps32]
    emit(rec)
    require(all(lines_ok.values()), f"landmark files: {lines_ok}")
    require(rec["s3fd_max_rel_diff_vs_float64"] <= 1e-4,
            f"S3FD float32 vs float64: {rec['s3fd_max_rel_diff_vs_float64']}")
    return rec


def ir_backbone_phase():
    """``IR_SE_50`` and ``IR_50`` at 112 px, batch ``IR_BATCH``, seeded
    weights: the float32 embeddings within 1e-4 of a float64 run on the
    card, and float32 ms per batch."""
    from fm3dgan_torch.models import psp_encoder

    g = torch.Generator().manual_seed(91)
    x = (torch.rand(IR_BATCH, 3, 112, 112, generator=g) * 2 - 1).cuda()
    rec = dict(phase="ir_backbone", batch=IR_BATCH, size=112)
    for name in ("IR_SE_50", "IR_50"):
        torch.manual_seed(92)
        net32 = getattr(psp_encoder, name)()
        net64 = getattr(psp_encoder, name)(dtype=torch.float64)
        net64.load_state_dict(net32.state_dict())
        net32, net64 = (n.requires_grad_(False).eval().cuda() for n in (net32, net64))
        with torch.no_grad():
            y32, y64 = net32(x), net64(x.double())
            rec[f"{name}_ms"] = cuda_ms(lambda: net32(x), iters=10, warmup=2)[0]
        rec[f"{name}_max_abs_diff_vs_float64"] = float((y32.double() - y64).abs().max())
        rec[f"{name}_norm"] = float(y32.norm(dim=-1).mean())
        del net32, net64
    emit(rec)
    for name in ("IR_SE_50", "IR_50"):
        require(rec[f"{name}_max_abs_diff_vs_float64"] <= 1e-4,
                f"{name} float32 vs float64: {rec[f'{name}_max_abs_diff_vs_float64']}")
        require(abs(rec[f"{name}_norm"] - 1.0) <= 1e-5, f"{name} embedding norm {rec[f'{name}_norm']}")
    return rec


# ---------------- data parallelism -------------------------------------------

DDP_WORLD = 2
DDP_BATCH = 16  # the global batch of the ddp phase, 8 per rank
DDP_ITERS = 6
DDP_TWO_BATCH = 8  # the 2-encoder gradients' global batch, 4 per rank
DDP_FID_IMAGES = 10  # in two batches of 5, each padded by a row for the 2 ranks
DDP_TIMEOUT = 900
DDP_CLI_ITERS, DDP_CLI_SAVE = 4, 2  # the resumed run repeats the last iteration
DDP_CLI_LR = "1e-7"


def _here():
    return os.path.dirname(os.path.abspath(__file__))


def _ddp_root():
    return os.path.join(_here(), "build", "chip_smoke_ddp")


def _fingerprint(tensors):
    """[n, 2] int64: the sum of each tensor's bit patterns and their
    position-weighted sum (wrapping), equal on two ranks only if the bits
    are (to any practical chance)."""
    rows = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1)
        bits = bits.view(torch.int32 if bits.element_size() == 4 else torch.int64).long()
        idx = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        rows.append(torch.stack([bits.sum(), (bits * idx).sum()]))
    return torch.stack(rows).cpu()


def _three_encoder_grads(train, trainer, state, photo, render, ref, ppl, ppl_idx):
    """D, R1 (D), G (DS with D_edit, LPIPS, ArcFace) and PPL on rows
    ``ppl_idx`` of the batch with the PPL image ``ppl``: their gradients at
    the current weights with fixed noise, averaged over the ranks (as every
    optimizer step averages them), and the losses of the global batch."""
    from fm3dgan_torch import parallel

    steps, cfg, avg = train.steps, trainer.config, parallel.average_gradients
    d, losses = steps.d_step_grads(state, cfg, photo, render, ref, use_edit=False)
    r1, r1_m = steps.d_reg_step_grads(state, cfg, ref, use_edit=False)
    g, g_m = steps.g_step_grads(state, cfg, photo, render, ref, use_edit=True, ds_flag=True,
                                extreme_ds_flag=False)
    p_sub, r_sub = trainer._ppl_rows(photo, render, ppl_idx)
    ppl_g, _, ppl_m = steps.g_reg_step_grads(state, cfg, p_sub, r_sub, ppl_noise=ppl)
    losses = parallel.mean_metrics({**losses, **r1_m, **g_m, "g_reg": ppl_m["g_reg"]})
    return ({"d_step": avg(d), "r1": avg(r1), "g_step": avg(g), "g_reg_step": avg(ppl_g)},
            {k: float(v) for k, v in losses.items()})


def _two_encoder_grads(train, trainer, state, photo, render, ref, ppl, ppl_idx):
    """The 2-encoder gradient phase's G, FFHQ G and PPL steps (fixed noise),
    averaged over the ranks, and the global batch's losses."""
    from fm3dgan_torch import parallel

    steps2, cfg, enc, avg = train.steps_2encoder, trainer.config, trainer.mod_encode, \
        parallel.average_gradients
    g, losses = steps2.g_step_grads(state, cfg, photo, render, ref, enc, ds_flag=True)
    g_ffhq, ffhq_m, _ = steps2.g_ffhq_ds_step_grads(state, cfg, photo, render, photo, enc)
    p_sub, r_sub = trainer._ppl_rows(photo, render, ppl_idx)
    g_reg, _, ppl_m = steps2.g_reg_step_grads(state, cfg, p_sub, r_sub, enc, ppl_noise=ppl)
    losses = parallel.mean_metrics({**losses, **ffhq_m, "g_reg": ppl_m["g_reg"]})
    return ({"g_step": avg(g), "g_ffhq_ds_step": avg(g_ffhq), "g_reg_step": avg(g_reg)},
            {k: float(v) for k, v in losses.items()})


def _ddp_gradient_inputs(steps, rows):
    """The global batches of the held gradients (3-encoder: batch 16, DS
    pairs, PPL on every other row; 2-encoder: batch 8, PPL on the first
    half), ``rows`` of each, prepared on the card, with the PPL images."""
    import numpy as np

    photo, render, ref = (steps.prepare_batch(a, "cuda")
                          for a in _train_inputs(DDP_BATCH, 71, ds_flag=True))
    g = torch.Generator(device="cuda").manual_seed(72)
    ppl_idx = np.arange(0, DDP_BATCH, 2)
    ppl = torch.randn(len(ppl_idx), 3, 256, 256, device="cuda", generator=g) / 256
    three = (photo[rows(DDP_BATCH)], render[rows(DDP_BATCH)], ref[rows(DDP_BATCH)],
             ppl[rows(len(ppl_idx))], ppl_idx)
    photo, render, _ = (steps.prepare_batch(a, "cuda")
                        for a in _two_encoder_inputs(DDP_TWO_BATCH, 61))
    ref = photo.flip(0)
    half = np.arange(DDP_TWO_BATCH // 2)
    ppl = torch.randn(len(half), 3, 256, 256, device="cuda", generator=g) / 256
    two = (photo[rows(DDP_TWO_BATCH)], render[rows(DDP_TWO_BATCH)], ref[rows(DDP_TWO_BATCH)],
           ppl[rows(len(half))], half)
    return three, two


def _fid_images():
    g = torch.Generator(device="cuda").manual_seed(73)
    return torch.rand(DDP_FID_IMAGES, 3, 256, 256, device="cuda", generator=g) * 2 - 1


def _to_cpu(grads):
    return {s: {k: {n: t.detach().cpu() for n, t in part.items()} for k, part in parts.items()}
            for s, parts in grads.items()}


def _held_runs(ops, train, trainer, run, inputs, with_plain=True):
    """``run`` (:func:`_three_encoder_grads` or :func:`_two_encoder_grads`)
    under cuDNN's deterministic algorithms through the kernels, under
    ``plain_versions()`` (None without ``with_plain``), and in float64 under
    ``plain_versions()`` with every parameter and buffer cast to float64 (no
    float32 rounding left): the three gradient sets on the host, and the
    first run's losses."""
    torch.backends.cudnn.deterministic = True
    try:
        kernels, losses = run(train, trainer, trainer.state, *inputs)
        kernels, plain = _to_cpu(kernels), None
        with ops.plain_versions():
            if with_plain:
                plain = _to_cpu(run(train, trainer, trainer.state, *inputs)[0])
            state64 = trainer.float64_state()
            for m in vars(state64).values():
                if isinstance(m, torch.nn.Module):
                    m.double()
            *tensors, ppl_idx = inputs
            exact = _to_cpu(run(train, trainer, state64, *(t.double() for t in tensors),
                                ppl_idx)[0])
    finally:
        torch.backends.cudnn.deterministic = False
    return kernels, plain, exact, losses


def _float64_distance(got, exact):
    """The largest |got - exact| over each tensor's max |exact| (over its
    partition's for a gradient zero in exact arithmetic, within 1e-6 of the
    partition's largest), and where."""
    worst = (0.0, "")
    for step, parts in exact.items():
        for part, tensors in parts.items():
            part_max = max(float(e.abs().max()) for e in tensors.values())
            for name, e in tensors.items():
                scale = float(e.abs().max())
                scale = scale if scale > 1e-6 * part_max else part_max
                d = float((got[step][part][name] - e).abs().max()) / scale
                worst = max(worst, (d, f"{step} {part}.{name}"))
    return worst


def _float32_distance(got, want, exact):
    """Per step, the largest |got - want| over max |exact| of a tensor, and
    each one's largest distance to ``exact`` (no bar: two float32 runs that
    round differently)."""
    out = {}
    for step, parts in exact.items():
        w = dict(ddp_vs_one=0.0, ddp_vs_exact=0.0, one_vs_exact=0.0)
        for part, tensors in parts.items():
            part_max = max(float(e.abs().max()) for e in tensors.values())
            for name, e in tensors.items():
                scale = float(e.abs().max())
                if scale <= 1e-6 * part_max:
                    continue
                k, p = got[step][part][name].double(), want[step][part][name].double()
                w["ddp_vs_one"] = max(w["ddp_vs_one"], float((k - p).abs().max()) / scale)
                w["ddp_vs_exact"] = max(w["ddp_vs_exact"], float((k - e).abs().max()) / scale)
                w["one_vs_exact"] = max(w["one_vs_exact"], float((p - e).abs().max()) / scale)
        out[step] = w
    return out


def ddp_rank_main(rank, port, root) -> int:
    """One rank of the ddp phase (``--ddp_rank``): a gloo world of
    ``DDP_WORLD`` processes on the one card over CUDA tensors.  Runs the
    held gradients, ``DDP_ITERS`` training iterations, the 2-encoder
    gradients and the sharded FID features on this rank's rows; rank 0 then
    leaves the group and runs the same work as one process on the global
    batch (:func:`_ddp_one_process`) and writes ``result.json``."""
    import datetime

    from fm3dgan_torch import ops, parallel, train
    from fm3dgan_torch.eval.fid import make_mesh_feature_fn
    from fm3dgan_torch.tools.nets import inception_net

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    (r, w), device = parallel.init_distributed(f"127.0.0.1:{port}", DDP_WORLD, rank,
                                               backend="gloo", device="cuda",
                                               timeout=datetime.timedelta(seconds=600))
    ops.build_all()
    with open(os.path.join(root, "per_iteration.json")) as f:
        per_iteration = json.load(f)
    out = dict(rank=r, world=w, device=str(device))
    three, two = _ddp_gradient_inputs(train.steps, parallel.local_rows)

    # 3-encoder: the held gradients at the initial weights, then training.
    trainer = train.Trainer(train.TrainConfig(), seed=0, device="cuda")
    *grads3, out["losses_grads"] = _held_runs(ops, train, trainer, _three_encoder_grads, three)
    grads3 = grads3 if r == 0 else None
    rows = parallel.local_rows(DDP_BATCH)
    out["iterations"] = []
    torch.cuda.synchronize()
    ops.reset_launches()
    for i in range(DDP_ITERS):
        batch = [a[rows] for a in _train_inputs(DDP_BATCH, 100 + i, trainer.config.is_ds_iter(i))]
        before, stats = ops.launch_counts(), json.loads(json.dumps(parallel.STATS))
        t0 = time.perf_counter()
        m = trainer.train_iteration(i, *batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        coll = {k: {f: v[f] - stats.get(k, {}).get(f, 0) for f in v}
                for k, v in parallel.STATS.items()}
        rec = dict(phase="ddp_train", rank=r, iteration=i, batch=len(batch[0]),
                   global_batch=DDP_BATCH, branch=_branch(trainer, i), ms=ms, launches=counts,
                   collectives=coll,
                   losses={k: float(v) for k, v in m.items() if torch.is_tensor(v)})
        out["iterations"].append(rec)
        emit(rec)
        require(all(math.isfinite(v) for v in rec["losses"].values()), f"ddp iteration {i}")
        if "+" not in rec["branch"]:
            require(counts == per_iteration,
                    f"rank {r} iteration {i}: launches {counts} != {per_iteration}")
    out["launches"] = ops.launch_counts()
    require(all(v > 0 for v in out["launches"].values()), f"rank {r} launches {out['launches']}")
    # Every parameter and statistic equal on the ranks to the bit.
    mine = _fingerprint(t for m in trainer._modules().values() for t in m.state_dict().values())
    theirs = parallel.all_gather_rows(mine[None])
    out["equal_to_the_bit"] = bool(all(torch.equal(theirs[0], t) for t in theirs))
    out["tensors_compared"] = mine.shape[0]
    emit(dict(phase="ddp_replicas", rank=r, iterations=DDP_ITERS, tensors=mine.shape[0],
              equal_to_the_bit=out["equal_to_the_bit"]))
    require(out["equal_to_the_bit"], f"rank {r}: the ranks' states differ after {DDP_ITERS} iterations")
    del trainer
    torch.cuda.empty_cache()

    # 2-encoder: the FFHQ-DS step gradients of the Tensor Transform trainer.
    trainer = train.Trainer2(train.TrainConfig(), seed=0, co_modulation=TWO_ENC_MODE,
                             ds_dataset_type="FFHQ", device="cuda")
    *grads2, out["losses_grads2"] = _held_runs(ops, train, trainer, _two_encoder_grads, two)
    grads2 = grads2 if r == 0 else None
    del trainer
    torch.cuda.empty_cache()

    # The sharded Inception features of 10 images.
    sharded = make_mesh_feature_fn(inception_net("cuda"))
    with torch.no_grad():
        feats = torch.cat([sharded(x) for x in _fid_images().chunk(2)]).cpu()
    out["collectives_total"] = parallel.STATS
    parallel.shutdown()
    del sharded
    torch.cuda.empty_cache()
    if r != 0:
        return 0
    result = _ddp_one_process(train, out, grads3, grads2, feats)
    with open(os.path.join(root, "result.json"), "w") as f:
        json.dump(result, f)
    return 0


def _ddp_one_process(train, ddp, grads3, grads2, feats):
    """Rank 0 after the group: one process on the global batches.  The
    ranks' gradient sets (``grads3``, ``grads2``: through the kernels,
    through the plain versions, and in float64, each averaged over the
    ranks) are held against this process's float64 run, the exact
    reference: the ranks' kernels against their plain versions by
    :func:`hold_gradient`, as the gradient phase holds one process's, and
    the ranks' float64 run within 1e-9 of this one's.  The two float32 runs,
    which round differently, are compared without a bar.  Then
    ``DDP_ITERS`` training iterations beside the ranks' losses, and the
    sharded features against this process's."""
    from fm3dgan_torch import ops
    from fm3dgan_torch.tools.nets import inception_net

    three, two = _ddp_gradient_inputs(train.steps, lambda n: slice(0, n))
    result = dict(ddp=ddp)
    for name, build, run, inputs, got in (
            ("ddp_gradients", lambda: train.Trainer(train.TrainConfig(), seed=0, device="cuda"),
             _three_encoder_grads, three, grads3),
            ("ddp_two_encoder_gradients",
             lambda: train.Trainer2(train.TrainConfig(), seed=0, co_modulation=TWO_ENC_MODE,
                                    ds_dataset_type="FFHQ", device="cuda"),
             _two_encoder_grads, two, grads2)):
        trainer = build()
        one, _, exact, losses = _held_runs(ops, train, trainer, run, inputs, with_plain=False)
        kernels, plain, ddp64 = got
        held, fails = _compare_held(kernels, plain, exact)
        float64_diff = _float64_distance(ddp64, exact)
        ddp_losses = ddp["losses_grads" if name == "ddp_gradients" else "losses_grads2"]
        # D's mean scores are logits near 0: printed, not held.
        loss_rel = {k: abs(ddp_losses[k] - v) / max(abs(v), 1e-30) for k, v in losses.items()
                    if not k.endswith("_score")}
        rec = dict(phase=name, world=DDP_WORLD, backend="gloo", **held,
                   ddp_float64_vs_one_process_float64=float64_diff,
                   float32_ddp_vs_one_process=_float32_distance(kernels, one, exact),
                   losses=losses, ddp_losses=ddp_losses, ddp_vs_one_process_loss_rel=loss_rel)
        emit(rec)
        result[name] = rec
        require(not fails, f"{name}: {len(fails)} data-parallel gradients outside their bar, "
                           f"the first: {fails[:5]}")
        require(float64_diff[0] <= 1e-9, f"{name}: the ranks' float64 gradients {float64_diff}")
        require(all(v <= 1e-4 for v in loss_rel.values()), f"{name}: losses {loss_rel}")
        del one, exact, kernels, plain, ddp64
        if name == "ddp_gradients":
            # The same training iterations as one process at batch 16.
            rows = []
            for i in range(DDP_ITERS):
                batch = _train_inputs(DDP_BATCH, 100 + i, trainer.config.is_ds_iter(i))
                m = trainer.train_iteration(i, *batch)
                one = {k: float(v) for k, v in m.items() if torch.is_tensor(v)}
                two_ranks = ddp["iterations"][i]["losses"]
                rows.append(dict(iteration=i, branch=_branch(trainer, i), one_process=one,
                                 ranks=two_ranks,
                                 rel_diff={k: abs(two_ranks[k] - v) / max(abs(v), 1e-30)
                                           for k, v in one.items()}))
                emit(dict(phase="ddp_losses", **rows[-1]))
            # Iteration 0's D, L1, LPIPS and face-ID losses come before any
            # update of what they read; the rest follow Adam steps, which
            # carry rounding differences into the weights (no bar).
            first = rows[0]["rel_diff"]
            require(all(first[k] <= 1e-4 for k in ("d", "l1", "lpips", "face_id")),
                    f"iteration 0 losses: {first}")
            result["ddp_losses"] = rows
        del trainer
        torch.cuda.empty_cache()
    with torch.no_grad():
        want = inception_net("cuda")(_fid_images()).cpu()
    err = float((feats - want).abs().max()) / float(want.abs().max())
    result["ddp_fid_features"] = dict(phase="ddp_fid_features", images=DDP_FID_IMAGES,
                                      max_rel_diff=err)
    emit(result["ddp_fid_features"])
    require(err <= 1e-4, f"sharded FID features {err}")
    return result


def ddp_phase(ops, per_iteration):
    """Two ranks (gloo over CUDA tensors; NCCL refuses two ranks on one
    card) started as processes of this script, against one process on the
    global batch in rank 0 after the group: see :func:`ddp_rank_main`."""
    root = _ddp_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(root, "per_iteration.json"), "w") as f:
        json.dump(per_iteration, f)
    port = _free_port()
    logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(DDP_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp_rank", str(r),
                               "--ddp_port", str(port)], stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=_here())
             for r in range(DDP_WORLD)]
    try:
        t_end = time.perf_counter() + DDP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [open(os.path.join(root, f"rank{r}.log")).read() for r in range(DDP_WORLD)]
    rcs = [p.returncode for p in procs]
    for line in texts[0].splitlines():  # rank 0's records
        if line.startswith("{"):
            print(line, flush=True)
    if rcs != [0] * DDP_WORLD:
        for r, t in enumerate(texts):
            print(f"--- ddp rank {r} (exit {rcs[r]}) ---\n{t[-6000:]}", flush=True)
    require(rcs == [0] * DDP_WORLD, f"ddp ranks exited {rcs}")
    with open(os.path.join(root, "result.json")) as f:
        result = json.load(f)
    shutil.rmtree(root, ignore_errors=True)
    return result


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_module_main(module, argv, stats_path) -> int:
    """``--run_module``: ``python -m module argv`` in this process with TF32
    off and cuDNN's deterministic algorithms (the ddp_cli phase's runs take
    the same algorithms as its one-process run), writing to ``stats_path``
    each training iteration's ms, kernel launches and collectives
    (``fm3dgan_torch.parallel.STATS``), and the 3-encoder trainer's
    parameters whose gradients its D and G steps all-reduce."""
    import runpy

    from fm3dgan_torch import ops, parallel
    from fm3dgan_torch.train import Trainer, Trainer2
    from fm3dgan_torch.train.state import g_enc_modules, named_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    records = {"iterations": []}

    def counted(cls):
        original = cls.train_iteration

        def train_iteration(self, i, *a, **kw):
            st = self.state
            if "params" not in records and hasattr(st, "g_enc_opt"):  # the 3-encoder trainer
                g_named = named_params(g_enc_modules(st.models, self.config))
                records["params"] = dict(d=sum(p.numel() for p in st.d.parameters()),
                                         g_and_encoders=sum(p.numel() for _, _, p in g_named))
            before, stats = ops.launch_counts(), json.loads(json.dumps(parallel.STATS))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = original(self, i, *a, **kw)
            torch.cuda.synchronize()
            records["iterations"].append(dict(
                iteration=i, ms=(time.perf_counter() - t0) * 1e3,
                launches={k: v - before[k] for k, v in ops.launch_counts().items()},
                collectives={k: {f: v[f] - stats.get(k, {}).get(f, 0) for f in v}
                             for k, v in parallel.STATS.items()}))
            return out

        cls.train_iteration = train_iteration

    counted(Trainer)
    counted(Trainer2)
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    with open(stats_path, "w") as f:
        json.dump(records, f)
    return code


def _module_cmd(module, args, stats, torchrun=False):
    """``module``'s CLI through :func:`run_module_main`, as one process or
    under ``torchrun --nproc_per_node 1`` (an NCCL world of one)."""
    me = [os.path.abspath(__file__), "--run_module", module, "--stats_out", stats, "--", *args]
    if torchrun:
        return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
                "--master_port", str(_free_port()), *me]
    return [sys.executable, *me]


def _run_logged(cmd, log, timeout=600):
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=_here())
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = open(log).read()
    if rc != 0:
        print(f"--- {' '.join(cmd[:8])} ... exited {rc} ---\n{text[-6000:]}", flush=True)
    require(rc == 0, f"{cmd[:8]} exited {rc}")
    return text


def ddp_cli_phase(ops):
    """The training CLIs with ``--data_parallel`` under ``torchrun
    --nproc_per_node 1``: an NCCL world of one at 256 px, full width, fake
    data.  ``train_3_encoder``: ``DDP_CLI_ITERS`` iterations with a
    checkpoint after iteration ``DDP_CLI_SAVE``, then a run resumed from it;
    and the same CLI as one process.  All at lr ``DDP_CLI_LR``: at the
    default lr, Adam moves a weight whose gradient is rounding residue by lr
    either way, and BatchNorm's global statistics round otherwise than
    ``F.batch_norm``.  The losses must agree with the one process's within
    1e-5 relative, R1 within 1e-4: it is taken after D's first Adam step
    (an untrained D's R1, about 6e-5, moved by 5.5e-5 relative between the
    two runs on the card, where the held R1 gradients at one weight set agree
    within 7.6e-5 in the ddp phase), and the resumed (last) iteration must
    equal the uninterrupted one to the bit; prints each iteration's ms with
    and without ``--data_parallel`` (``train_iteration`` alone, between two
    synchronizes: the loop's overlap of the card with the next batch's load
    is what ``fm3dgan_torch/tools/loop_timing.py`` measures), its
    collectives and the bytes it all-reduces beside those the parameters'
    sizes give.  Then ``train_2_encoder
    --data_parallel`` 2 iterations and ``fid --data_parallel`` against
    ``fid``, each a world of one."""
    import re

    import numpy as np

    from fm3dgan_torch.eval.fid import save_stats

    root = os.path.join(_ddp_root(), "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    m3, m2 = "fm3dgan_torch.tools.train_3_encoder", "fm3dgan_torch.tools.train_2_encoder"
    base = ["--fake_data", "--training_iters", str(DDP_CLI_ITERS), "--log_every", "1", "--lr",
            DDP_CLI_LR]
    # One checkpoint (and its eval line), in the data-parallel run alone.
    save = ["--model_save_freq", str(DDP_CLI_SAVE)]
    d = {k: os.path.join(root, k) for k in ("one", "ddp", "ddp_resumed", "two")}
    stats = {k: os.path.join(root, f"{k}_stats.json") for k in d}
    rec = dict(phase="ddp_cli", backend="nccl", world=1, lr=float(DDP_CLI_LR),
               cudnn_deterministic=True)
    try:
        t = {}
        for k, extra, torchrun in (
                ("one", ["--model_save_freq", str(10 ** 6)], False),
                ("ddp", ["--data_parallel", *save], True),
                ("ddp_resumed", ["--data_parallel", *save, "--resume_dir",
                                 os.path.join(d["ddp"], "ckpt"), "--resume_step",
                                 str(DDP_CLI_SAVE)], True)):
            t0 = time.perf_counter()
            _run_logged(_module_cmd(m3, base + extra + ["--exp_dir", d[k]], stats[k], torchrun),
                        os.path.join(root, f"{k}.log"))
            t[k] = time.perf_counter() - t0
        logs, per_iter = {}, {}
        for k in ("one", "ddp", "ddp_resumed"):
            with open(os.path.join(d[k], "training_log.jsonl")) as f:
                logs[k] = {x["iter"]: x for x in map(json.loads, f) if "iter" in x}
            with open(stats[k]) as f:
                per_iter[k] = json.load(f)
        require(sorted(logs["ddp"]) == list(range(DDP_CLI_ITERS)), f"ddp iterations {sorted(logs['ddp'])}")
        require(sorted(logs["ddp_resumed"]) == list(range(DDP_CLI_SAVE + 1, DDP_CLI_ITERS)),
                f"resumed iterations {sorted(logs['ddp_resumed'])}")
        keys = ("d", "g", "l1", "lpips", "face_id", "r1", "g_reg", "path_length")
        rec["ddp_vs_one_rel_diff"] = {
            i: {k: abs(logs["ddp"][i][k] - logs["one"][i][k]) / max(abs(logs["one"][i][k]), 1e-30)
                for k in keys} for i in range(DDP_CLI_ITERS)}
        resumed_keys = ("d", "g", "l1", "lpips", "face_id")  # no R1 or PPL in these iterations
        rec["resumed_diff"] = {i: {k: logs["ddp_resumed"][i][k] - logs["ddp"][i][k]
                                   for k in resumed_keys}
                               for i in range(DDP_CLI_SAVE + 1, DDP_CLI_ITERS)}
        params = per_iter["ddp"]["params"]
        counted = {"d_step": 4 * params["d"], "g_step": 4 * params["g_and_encoders"]}
        rec["params"] = params
        rec["bytes_per_optimizer_step_from_parameters"] = counted
        rec["iterations"] = [dict(iteration=a["iteration"], ms_data_parallel=a["ms"],
                                  ms_one_process=b["ms"], collectives=a["collectives"],
                                  launches=a["launches"], launches_one_process=b["launches"])
                             for a, b in zip(per_iter["ddp"]["iterations"],
                                             per_iter["one"]["iterations"])]
        rec["run_s"] = t
        first = rec["iterations"][1]  # DS with D_edit, no regulariser: a D and a G step
        all_reduced = first["collectives"]["all_reduce"]["bytes"]
        rec["all_reduce_bytes_iteration_1"] = all_reduced
        rec["all_reduce_bytes_besides_gradients"] = (all_reduced - counted["d_step"]
                                                     - counted["g_step"])
        emit(rec)
        for i, rel in rec["ddp_vs_one_rel_diff"].items():
            require(all(v <= (1e-4 if k == "r1" else 1e-5) for k, v in rel.items()),
                    f"ddp CLI iteration {i}: {rel}")
        require(all(v == 0.0 for x in rec["resumed_diff"].values() for v in x.values()),
                f"resumed iterations differ: {rec['resumed_diff']}")
        require(all(it["launches"] == it["launches_one_process"] for it in rec["iterations"]),
                "the data-parallel iterations launch the kernels otherwise than one process")
        require(all(v > 0 for v in per_iter["ddp"]["iterations"][0]["launches"].values()),
                f"ddp CLI launches {per_iter['ddp']['iterations'][0]['launches']}")
        # The all-reduces carry the D and the G step's gradients, and besides
        # them the backward of every gather (BatchNorm's statistics,
        # minibatch stddev's activations), the metrics and the preemption flag.
        grads_bytes = counted["d_step"] + counted["g_step"]
        require(grads_bytes <= all_reduced <= grads_bytes * 1.01,
                f"iteration 1 all-reduced {all_reduced} bytes, the gradients {grads_bytes}")

        # The 2-encoder CLI (2 iterations: reconstruction, DS) and fid with and
        # without --data_parallel on the checkpoint, side by side, each a world
        # of one.
        stats_path = os.path.join(root, "real_stats.pkl")
        save_stats(stats_path, np.zeros(2048), np.eye(2048))
        args = ["--ckpt_dir", os.path.join(d["ddp"], "ckpt"), "--step", str(DDP_CLI_SAVE),
                "--stats", stats_path, "--n_sample", "10", "--batch", "4"]
        cmds = {"two": _module_cmd(m2, ["--fake_data", "--training_iters", "2", "--log_every",
                                        "1", "--data_parallel", "--exp_dir", d["two"]],
                                   stats["two"], torchrun=True),
                "fid_one": [sys.executable, "-m", "fm3dgan_torch.tools.fid", *args],
                "fid_ddp": [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                            "1", "--master_port", str(_free_port()), "-m",
                            "fm3dgan_torch.tools.fid", *args, "--data_parallel"]}
        logs_f = {k: open(os.path.join(root, f"{k}.log"), "w") for k in cmds}
        procs = {k: subprocess.Popen(c, stdout=logs_f[k], stderr=subprocess.STDOUT, cwd=_here())
                 for k, c in cmds.items()}
        try:
            rcs = {k: p.wait(timeout=600) for k, p in procs.items()}
        finally:
            for k, p in procs.items():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                logs_f[k].close()
        texts = {k: open(os.path.join(root, f"{k}.log")).read() for k in cmds}
        for k, rc in rcs.items():
            if rc != 0:
                print(f"--- {k} (exit {rc}) ---\n{texts[k][-4000:]}", flush=True)
        require(all(rc == 0 for rc in rcs.values()), f"exit codes {rcs}")
        with open(os.path.join(d["two"], "training_log.jsonl")) as f:
            two = [x for x in map(json.loads, f) if "iter" in x]
        require([x["iter"] for x in two] == [0, 1] and all(
            math.isfinite(v) for x in two for v in x.values() if isinstance(v, float)),
            f"2-encoder ddp CLI log {two}")
        with open(stats["two"]) as f:
            emit(dict(phase="ddp_cli_two_encoder", iterations=json.load(f)["iterations"],
                      losses=two))
        fids = {}
        for k in ("fid_one", "fid_ddp"):
            found = re.findall(r"^FID \(10 samples\): (\S+)$", texts[k], re.M)
            require(len(found) == 1, f"{k}: {found}")
            fids[k] = float(found[0])
        rec_fid = dict(phase="ddp_cli_fid", fid=fids,
                       rel_diff=abs(fids["fid_ddp"] - fids["fid_one"]) / abs(fids["fid_one"]))
        emit(rec_fid)
        require(rec_fid["rel_diff"] <= 1e-3, f"fid --data_parallel {fids}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


@contextlib.contextmanager
def count_plain_decisions():
    """Count the operator calls that take the plain version on a CUDA tensor
    while the block runs: the plain versions of ``_build.PLAIN`` are the
    operators' CUDA kernels only where ``plain_versions()`` registers them."""
    from fm3dgan_torch.ops import _build

    calls = {"plain": 0}
    original = dict(_build.PLAIN)

    def counted(plain):
        def kernel(x, *args):
            calls["plain"] += x.is_cuda
            return plain(x, *args)

        return kernel

    _build.PLAIN.update({name: counted(plain) for name, plain in original.items()})
    try:
        yield calls
    finally:
        _build.PLAIN.update(original)


def profile_phase(ops):
    """``profile_train``'s ``main`` at TrainConfig()'s shapes in float32 with
    LPIPS and ArcFace: its step seconds and the traced window's device busy
    time and idle share; then ``analyze_trace`` on its trace: the device
    time by category and the top rows per iteration, and each kernel's
    device events, which must equal the launch counter over the window (its
    counts set to 0 at the window's first iteration, read after its last).
    No wrapper may take its plain version, and a trace without device
    events fails."""
    from fm3dgan_torch.tools import analyze_trace, profile_train

    out_dir = os.path.join(_here(), "build", "chip_smoke_profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    first, last = profile_train.TRACE_START, profile_train.TRACE_START + PROFILE_ITERS - 1
    window = {}
    original = profile_train.Trainer.train_iteration

    def train_iteration(self, i, *a):
        if i == first:
            ops.reset_launches()
        out = original(self, i, *a)
        if i == last:
            window["launches"] = ops.launch_counts()
        return out

    buf = io.StringIO()
    profile_train.Trainer.train_iteration = train_iteration
    try:
        with count_plain_decisions() as plain, contextlib.redirect_stdout(buf):
            rc = profile_train.main(["--batch", str(PROFILE_BATCH), "--dtype", "float32",
                                     "--iters", str(PROFILE_ITERS), "--out_dir", out_dir])
        t0 = time.perf_counter()
        events, path = analyze_trace.load_trace(out_dir)
        trace_mb = os.path.getsize(path) / 1e6
        table = analyze_trace.aggregate(events, "gpu")
        analyze_s = time.perf_counter() - t0
    finally:
        profile_train.Trainer.train_iteration = original
        shutil.rmtree(out_dir, ignore_errors=True)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    found = analyze_trace.kernel_sums(table)
    cfg = profile_train.TrainConfig()
    per_it = 1.0 / PROFILE_ITERS
    rows = analyze_trace.top_rows(table, PROFILE_TOP)
    for r in rows:
        r["ms_per_iteration"] = r.pop("ms") * per_it
    rec = dict(
        phase="profile", rc=rc, batch=PROFILE_BATCH, dtype="float32",
        window=[dict(iteration=i, ds=cfg.is_ds_iter(i), r1=i % cfg.d_reg_every == 0,
                     ppl=i % cfg.g_reg_every == 0) for i in range(first, last + 1)],
        step_seconds=res["step_seconds"], trace_mb=trace_mb, analyze_seconds=analyze_s,
        summary={k: v for k, v in res["profile"].items() if not k.startswith("top_")},
        top_host_ops=res["profile"]["top_cpu"],
        device_ms_per_iteration_by_category={
            c: dict(ms=ms * per_it, events=n * per_it)
            for c, (ms, n) in analyze_trace.rollup(table).items()},
        device_ms_per_iteration=sum(v["us"] for v in table.values()) / 1e3 * per_it,
        top_device_rows=rows, kernel_events=found, launches=window.get("launches"),
        kernel_device_ms_per_iteration={
            k: us / 1e3 * per_it for k, us in analyze_trace.kernel_sums(table, "us").items()},
        plain_decisions=plain["plain"])
    emit(rec)
    require(rc == 0, f"profile_train returned {rc}")
    require(sorted(res["step_seconds"]) == ["d_reg_step", "d_step", "g_reg_step", "g_step"]
            and all(v > 0 for v in res["step_seconds"].values()), f"step seconds {res}")
    require(bool(table), "the trace holds no device event (CUDA activity missing)")
    require(all(found.values()) and found == window["launches"],
            f"kernel events in the trace {found} != launches over the window {window}")
    require(plain["plain"] == 0, f"{plain['plain']} wrapper calls took the plain version")
    return rec


def bf16_parity_phase():
    """``validate_bf16``'s ``run`` in float32, in bfloat16, and in float32
    once more, at the JAX tool's defaults but ``BF16_PARITY_ITERS``
    iterations (on the card by default): its
    report of bfloat16 against the first float32 run, and the same windowed
    deviation between the two float32 runs, which cuDNN's float32 algorithms
    make differ: the spread a precision's deviation is read against.  Every
    tracked value of each run, each iteration's, must be finite.  The
    deviations are recorded, not barred: the JAX tool sets no bar."""
    from fm3dgan_torch.tools import validate_bf16

    args = validate_bf16.build_arg_parser().parse_args(["--iters", str(BF16_PARITY_ITERS)])
    hist, seconds = {}, {}
    for name, dtype in (("float32", "float32"), ("bfloat16", "bfloat16"),
                        ("float32_repeat", "float32")):
        t0 = time.perf_counter()
        hist[name] = validate_bf16.run(dtype, args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    repeat = validate_bf16.report(hist["float32"], hist["float32_repeat"])
    rec = dict(phase="bf16_parity", iters=args.iters, size=args.size, input_size=args.input_size,
               batch=args.batch, run_seconds=seconds,
               report=validate_bf16.report(hist["float32"], hist["bfloat16"]),
               float32_repeat={k: dict(tail_mean=v["bf16_tail_mean"],
                                       max_windowed_rel_dev=v["max_windowed_rel_dev"])
                               for k, v in repeat.items() if k in validate_bf16.TRACKED})
    emit(rec)
    for name, h in hist.items():
        for k in validate_bf16.TRACKED:
            require(len(h[k]) == args.iters and all(math.isfinite(v) for v in h[k]),
                    f"{name} {k}: {h[k]}")
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


def summary(records, launches, inference_launches, two_encoder_launches, edit_launches,
            projector_launches, ddp_launches):
    """One line per kernel.  The SUMMED keys are those of one float32
    training iteration without regulariser at batch 16 (the kernel-phase
    records of every training shape, each counted as often as the iteration
    launches it); the forward_* keys are those of one batch-8 inference
    forward, the projector_* keys those of one batch-1 projector step.
    ``launches`` counts the float32 training run, ``launches_inference`` one
    batch-8 forward, ``launches_two_encoder`` the 2-encoder training run,
    ``launches_edit`` one batch of the edit CLI, ``launches_projector`` one
    projector step, ``launches_ddp`` rank 0's ``DDP_ITERS`` iterations at batch
    8 of the global 16."""
    kernels = []
    for name, info in KERNEL_INFO.items():
        recs = [r for r in records if r["kernel"] == name and r["dtype"] == "float32"]
        bf16 = [r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16"]
        train_recs = [r for r in recs if "launches_per_iteration" in r]
        fwd_recs = [r for r in recs if "launches_per_forward" in r]
        fwd = _weighted_sums(fwd_recs, "launches_per_forward")
        proj = _weighted_sums([r for r in recs if "launches_per_step" in r], "launches_per_step")
        kernels.append(dict(
            name=name, **info, launches=launches[name],
            launches_two_encoder=two_encoder_launches[name],
            launches_edit=edit_launches[name], launches_projector=projector_launches[name],
            launches_ddp=ddp_launches[name],
            launches_per_iteration=sum(r["launches_per_iteration"] for r in train_recs),
            launches_inference=inference_launches[name],
            max_abs_err=max(r["max_abs_diff"] for r in recs),
            max_abs_err_bf16=max(r["max_abs_diff"] for r in bf16),
            **_weighted_sums(train_recs, "launches_per_iteration"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in train_recs) else "operations",
            **{f"forward_{k}": v for k, v in fwd.items()},
            **{f"projector_{k}": v for k, v in proj.items()},
            note=(f"ms, device_ms, host_us, plain_ms, bound_ms, library_*: one float32 training "
                  f"iteration without regulariser, batch {TRAIN_BATCH}; forward_*: one float32 "
                  f"inference forward, batch {BATCH}; projector_*: one float32 projector step, "
                  f"batch 1; ms: events around eager calls; device_ms: CUDA-graph replay; "
                  f"host_us: host time of the eager calls"),
        ))
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--run_module"]:  # --run_module M --stats_out S -- args
        return run_module_main(sys.argv[2], sys.argv[6:], sys.argv[4])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write every record to this JSON file")
    ap.add_argument("--ddp_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ddp_port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ddp_rank is not None:
        return ddp_rank_main(args.ddp_rank, args.ddp_port, _ddp_root())
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
    # The projector's shapes: G forward and backward at batch 1, float32.
    proj_records = phase("projector_kernel", training_kernel_phase, ops, batch=1, passes=(1, 1, 0, 0),
                         dtypes=(torch.float32,), what="projector")
    records += proj_records
    per_step = {name: sum(r["launches_per_step"] for r in proj_records if r["kernel"] == name)
                for name in KERNEL_INFO}
    require(per_step == projector_launches(EXPECTED_LAUNCHES),
            f"projector kernel weights {per_step} != {projector_launches(EXPECTED_LAUNCHES)}")
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
    # The training CLI, then the serving and checkpoint tools on its checkpoint.
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        phase("cli", cli_phase, ops, root)
        ckpt = os.path.join(root, "run", "ckpt")
        edit = phase("edit_cli", edit_cli_phase, ops, root, ckpt, CLI_SAVE)
        torch.cuda.empty_cache()
        proj = phase("projector", projector_phase, ops, ckpt, CLI_SAVE, per_step)
        torch.cuda.empty_cache()
        phase("eval_tools", eval_tools_phase, ops, root, ckpt, CLI_SAVE)
        torch.cuda.empty_cache()
        phase("export", export_phase, ops, root, ckpt, CLI_SAVE)
        torch.cuda.empty_cache()
        phase("landmarks", landmarks_phase, root)
        torch.cuda.empty_cache()
        phase("ir_backbone", ir_backbone_phase)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

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
    torch.cuda.empty_cache()

    # Data parallelism: two gloo ranks on the card against one process, then
    # the CLIs in an NCCL world of one.
    ddp = phase("ddp", ddp_phase, ops, per_iteration)
    phase("ddp_cli", ddp_cli_phase, ops)
    torch.cuda.empty_cache()

    # The profiling tools: a traced TrainConfig() window broken down, then
    # bf16 training against float32.
    phase("profile", profile_phase, ops)
    torch.cuda.empty_cache()
    phase("bf16_parity", bf16_parity_phase)

    result = summary(records, launches, path["launches"], two_train["launches"],
                     edit["launches_per_batch"], proj["launches_per_step"],
                     ddp["ddp"]["launches"])
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
