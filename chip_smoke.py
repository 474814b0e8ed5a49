"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Builds the hand-written CUDA kernels of ``fm3dgan_torch`` from
``fm3dgan_torch/ops/csrc`` and then, in order (TF32 off throughout):

1. kernel phase: each kernel at every shape the 256 px inference forward
   gives it (batch 8) and at every shape a training iteration gives it
   (batch 16), float32 and bfloat16, against its plain PyTorch version on
   the card, with its time, the plain version's time, one PyTorch library
   call's time where one computes the same function, and its memory/compute
   bound;
2. path phase: ``FaceManipulator.create(size=256, input_size=256)`` with
   seeded random weights runs ``forward_3_encoder`` at batch 8 in float32
   through the kernels and through the plain versions, checks the output
   and the launch counts, repeats in bfloat16, checks a small configuration
   on the card against the CPU, and times batch 32;
3. gradient phase: on a full-width 256 px ``Trainer`` state, the gradients
   of one G step (GAN + L1 + face-regional, fixed noise) and of one R1 step
   at batch 16, through the kernels, under ``plain_versions()`` (which
   must launch nothing and reproduce itself to the bit) and, as the exact
   reference, under ``plain_versions()`` in float64; each parameter tensor
   held to :func:`hold_gradient` (the 1e-4 bar, widened only where the
   float64 run shows the plain float32 path itself further off);
4. training phase: that ``Trainer`` runs iterations 0-5 on seeded uint8
   batches of 16 in float32 (reconstruction, DS with D_edit, extreme DS,
   R1, PPL), printing flags, losses, ms and launches per iteration, and
   checks that the losses are finite, every partition, g_ema and the
   BatchNorm statistics moved, the PPL mean is positive, all five kernels
   ran and each iteration without regulariser launched them as often as
   the kernel phase's per-shape weights say; then 2 iterations in bfloat16.

Prints one JSON line per measurement, the card's name and power limit, a
``{"kernels": [...]}`` summary, and last ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device, when a kernel
does not build or launch, or when any check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
            rec["kernel_ms"] = cuda_ms(lambda: ops.blur(x, k2d, (1, 1)))
            rec["plain_ms"] = cuda_ms(lambda: ops.blur_plain(x, k2d, (1, 1)))
            rec["library_ms"] = cuda_ms(lib)
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
            rec["kernel_ms"] = cuda_ms(lambda: ops.upsample2x(x, k1d, (2, 1)))
            rec["plain_ms"] = cuda_ms(lambda: ops.upsample2x_plain(x, k1d, (2, 1)))
            rec["library_ms"] = cuda_ms(lib)
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
            rec["kernel_ms"] = cuda_ms(lambda: ops.fused_leaky_relu(x, b))
            rec["plain_ms"] = cuda_ms(lambda: ops.fused_leaky_relu_plain(x, b))
            rec["library_ms"] = None
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
    rec["kernel_ms"] = cuda_ms(kernel_fn, iters=20)
    rec["plain_ms"] = cuda_ms(plain_fn, iters=20)
    rec["library_ms"] = None if lib_fn is None else cuda_ms(lib_fn, iters=20)
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
    """One G step (GAN + L1 + face-regional, DS branch with D_edit) and one R1
    step on the same state with fixed noise and cuDNN's deterministic
    algorithms, through the kernels and through the plain versions, forward
    and backward; the plain runs must launch no kernel.  The plain run is
    made twice (the repeat must give the same gradients to the bit) and once
    more in float64 (``Trainer.float64_state``), the exact reference, whose
    losses must agree with the float32 ones within 1e-4.  Every parameter
    tensor must pass :func:`hold_gradient`."""
    steps, st, cfg = train.steps, trainer.state, trainer.config
    photo, render, ref = (steps.prepare_batch(a, "cuda")
                          for a in _train_inputs(GRAD_BATCH, 11, ds_flag=True))
    torch.backends.cudnn.deterministic = True

    def run(state, photo, render, ref):
        g, g_losses = steps.g_step_grads(state, cfg, photo, render, ref, use_edit=True,
                                         ds_flag=True, extreme_ds_flag=False)
        r1, r1_losses = steps.d_reg_step_grads(state, cfg, ref, use_edit=False)
        losses = {k: float(v) for k, v in {**g_losses, **r1_losses}.items()}
        return {"g_step": g, "r1": r1}, losses

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    got, got_losses = run(st, photo, render, ref)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ops.reset_launches()
    with ops.plain_versions():
        want, _ = run(st, photo, render, ref)
        again, _ = run(st, photo, render, ref)
        state64 = trainer.float64_state()
        exact, exact_losses = run(state64, photo.double(), render.double(), ref.double())
    torch.cuda.synchronize()
    plain_counts = ops.launch_counts()
    del state64
    torch.backends.cudnn.deterministic = False
    require(not any(plain_counts.values()), f"gradient phase plain runs launched {plain_counts}")
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
            group = "encoders" if part.startswith("e_") else "g_and_d"
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
    rec = dict(phase="gradients", batch=GRAD_BATCH, dtype="float32", tensors=n,
               zero_in_exact_arithmetic=zero, worst_rel_diff=worst,
               plain_over_1e4_from_exact=plain_off,
               kernel_vs_plain_over_1e4=over, plain_repeat_differs=repeat_differs,
               losses=got_losses, loss_rel_diff_vs_exact=loss_rel,
               launches=counts, plain_launches=plain_counts,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    emit(rec)
    require(not repeat_differs, f"the plain path does not reproduce itself: {repeat_differs}")
    require(not fails, f"gradients outside their bar: {fails}")
    require(all(v > 0 for v in counts.values()), f"gradient phase launches {counts}")
    return rec


def _snapshot(st):
    mods = {"d": st.d, "d_edit": st.d_edit, "g": st.models.generator, "e_tsr": st.models.e_tsr,
            "e_w": st.models.e_w, "e_w_plus": st.models.e_w_plus, "g_ema": st.g_ema}
    snap = {k: {n: p.detach().clone() for n, p in m.named_parameters()} for k, m in mods.items()}
    snap["bn_stats"] = {f"{k}.{n}": b.detach().clone() for k in ("e_tsr", "e_w", "e_w_plus")
                        for n, b in mods[k].named_buffers() if n.endswith(("running_mean", "running_var"))}
    return snap


def training_phase(ops, train, trainer, iters, dtype_name, per_iteration):
    """``Trainer.train_iteration`` on iterations 0..iters-1; returns the
    launches of the whole run.  Each iteration without regulariser must
    launch each kernel as often as ``per_iteration`` says."""
    st = trainer.state
    before = _snapshot(st) if dtype_name == "float32" else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for i in range(iters):
        photo, render, ref = _train_inputs(TRAIN_BATCH, 100 + i, trainer.config.is_ds_iter(i))
        before_i = ops.launch_counts()
        t0 = time.perf_counter()
        m = trainer.train_iteration(i, photo, render, ref)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v - before_i[k] for k, v in ops.launch_counts().items()}
        losses = {k: float(v) for k, v in m.items() if torch.is_tensor(v)}
        rec = dict(phase="train", dtype=dtype_name, iteration=i, batch=TRAIN_BATCH,
                   ds_flag=m["ds_flag"], extreme_ds_flag=m["extreme_ds_flag"],
                   use_edit=bool(m["ds_flag"] and trainer.config.use_separate_d),
                   r1_step=i % trainer.config.d_reg_every == 0,
                   ppl_step=i % trainer.config.g_reg_every == 0,
                   losses=losses, ms=ms, launches=counts)
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
    emit(dict(phase="train_summary", dtype=dtype_name, iterations=iters, batch=TRAIN_BATCH,
              launches=launches, max_memory_allocated_bytes=peak,
              mean_path_length=float(st.mean_path_length)))
    return launches


def _weighted_sums(recs, weight_key):
    """ms, plain_ms, bound_ms, library_ms over ``recs``, each record counted
    as often as ``weight_key`` says; None for the whole path when it does
    not run the kernel, and library_ms None where a record has no library
    call."""
    if not recs:
        return dict(ms=None, plain_ms=None, bound_ms=None, library_ms=None)
    total = lambda key: sum(r[key] * r[weight_key] for r in recs)  # noqa: E731
    lib = None if any(r["library_ms"] is None for r in recs) else total("library_ms")
    return dict(ms=total("kernel_ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                library_ms=lib)


def summary(records, launches, inference_launches):
    """One line per kernel.  ms, plain_ms, bound_ms and library_ms are those
    of one float32 training iteration without regulariser at batch 16 (the
    kernel-phase records of every training shape, each counted as often as
    the iteration launches it); the forward_* keys are those of one batch-8
    inference forward.  ``launches`` counts the float32 training run,
    ``launches_inference`` one batch-8 forward."""
    kernels = []
    for name, info in KERNEL_INFO.items():
        recs = [r for r in records if r["kernel"] == name and r["dtype"] == "float32"]
        bf16 = [r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16"]
        train_recs = [r for r in recs if "launches_per_iteration" in r]
        fwd_recs = [r for r in recs if "launches_per_forward" in r]
        fwd = _weighted_sums(fwd_recs, "launches_per_forward")
        kernels.append(dict(
            name=name, **info, launches=launches[name],
            launches_per_iteration=sum(r["launches_per_iteration"] for r in train_recs),
            launches_inference=inference_launches[name],
            max_abs_err=max(r["max_abs_diff"] for r in recs),
            max_abs_err_bf16=max(r["max_abs_diff"] for r in bf16),
            **_weighted_sums(train_recs, "launches_per_iteration"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in train_recs) else "operations",
            **{f"forward_{k}": v for k, v in fwd.items()},
            note=(f"ms, plain_ms, bound_ms, library_ms: one float32 training iteration without "
                  f"regulariser, batch {TRAIN_BATCH}; forward_*: one float32 inference forward, "
                  f"batch {BATCH}"),
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

    emit(dict(phase="build", seconds=ops.build_all()))
    records = kernel_phase(ops) + training_kernel_phase(ops)
    path = path_phase(ops, pipeline)

    config = train.TrainConfig()  # the shipped 3-encoder configuration, 256 px, full width
    trainer = train.Trainer(config, seed=0, device="cuda")
    grads = gradient_phase(ops, train, trainer)
    per_iteration = launches_per_iteration(records)
    launches = training_phase(ops, train, trainer, TRAIN_ITERS, "float32", per_iteration)
    del trainer
    torch.cuda.empty_cache()
    trainer = train.Trainer(dataclasses.replace(config, compute_dtype="bfloat16"), seed=0,
                            device="cuda")
    training_phase(ops, train, trainer, BF16_ITERS, "bfloat16", per_iteration)
    del trainer
    torch.cuda.empty_cache()

    result = summary(records, launches, path["launches"])
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
