"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Builds the hand-written CUDA kernels of ``fm3dgan_torch`` from
``fm3dgan_torch/ops/csrc`` and then, in order:

1. kernel phase: each kernel at every shape the 256 px forward gives it
   (batch 8, float32 and bfloat16) against its plain PyTorch version on the
   card, with its time, the plain version's time, one PyTorch library call's
   time where one computes the same function, and its memory/compute bound;
2. path phase: ``FaceManipulator.create(size=256, input_size=256)`` with
   seeded random weights runs ``forward_3_encoder`` at batch 8 in float32
   (TF32 off) through the kernels and through the plain versions, checks the
   output and the launch counts, repeats in bfloat16, checks a small
   configuration on the card against the CPU, and times batch 32.

Prints one JSON line per measurement, the card's name and power limit, a
``{"kernels": [...]}`` summary, and last ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device, when a kernel
does not build or launch, or when any check fails.
"""

from __future__ import annotations

import argparse
import json
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

# (C, R): blur input [N, C, 2R+1, 2R+1] after each upsampling transposed conv.
BLUR_SHAPES = [(512, 4), (512, 8), (512, 16), (512, 32), (256, 64), (128, 128)]
# R: ToRGB skip [N, 3, R, R] -> [N, 3, 2R, 2R].
UP2_SHAPES = [4, 8, 16, 32, 64, 128]
# (C, R, launches per forward): every StyledConv's output [N, C, R, R].
ACT_SHAPES = [(512, 4, 1), (512, 8, 2), (512, 16, 2), (512, 32, 2), (512, 64, 2),
              (256, 128, 2), (128, 256, 2)]

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
}
EXPECTED_LAUNCHES = {"blur": 6, "upsample2x": 6, "fused_leaky_relu": 13}


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
        with ops.plain_versions():
            ref = forward_3_encoder(models, photo, render)
        torch.cuda.synchronize()
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


def summary(records, launches):
    kernels = []
    for name, info in KERNEL_INFO.items():
        recs = [r for r in records if r["kernel"] == name and r["dtype"] == "float32"]
        bf16 = [r for r in records if r["kernel"] == name and r["dtype"] == "bfloat16"]
        per_fwd = lambda key: sum(r[key] * r["launches_per_forward"] for r in recs)  # noqa: E731
        lib = None if recs[0]["library_ms"] is None else per_fwd("library_ms")
        kernels.append(dict(
            name=name, **info, launches=launches[name],
            max_abs_err=max(r["max_abs_diff"] for r in recs),
            max_abs_err_bf16=max(r["max_abs_diff"] for r in bf16),
            ms=per_fwd("kernel_ms"), plain_ms=per_fwd("plain_ms"), bound_ms=per_fwd("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in recs) else "operations",
            library_ms=lib,
            note=f"sums over one batch-{BATCH} float32 forward's launches",
        ))
    return {"kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write every record to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fm3dgan_torch import ops, pipeline

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
    records = kernel_phase(ops)
    path = path_phase(ops, pipeline)
    result = summary(records, path["launches"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, records=records, summary=result), f, indent=1)
    print(smi, flush=True)
    emit(result)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
